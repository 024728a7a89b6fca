"""The Gaussian-sum density of a batch of residual rows through one
hand-written CUDA kernel: the filters' measurement update.

:func:`mixture_pdf` evaluates a mixture of ``Nd`` Gaussians over ``R^ny``
(``GaussianSum``'s ``means``, ``inv_cov``, ``log_const`` and ``weights``)
at every row of ``x (..., ny)``:

    q_d = sum_i e_i (sum_j inv_cov[d, j, i] e_j),   e = x - means[d]
    pdf = sum_d weights[d] exp(log_const[d] - q_d / 2)

each product and sum rounded on its own in ``GaussianSum.pdf_t``'s order
(the reference's ``(e @ inv_cov) . e``), or with ``log`` the
log-sum-exp over the components of ``log_const[d] - q_d / 2 +
log(weights[d])``, finite where ``pdf`` underflows to 0. A ``scale (...)``
returns ``scale * pdf``: the filters pass their prior weights, so the
update's multiply is the kernel's last rounding.

It replaces no TPU kernel: the reference's ``pdf`` is an XLA einsum
(``gpu_se_tpu/distributions/gaussian_sum.py:156``), which the port's
einsum of the same form handed to cuBLAS's batched gemv.

A CUDA ``x`` launches the kernel (``csrc/mixture_pdf.cu``), reading the
rows through their strides (the filters' residual ``z - g(x.T).T`` is
a column-major view, not copied); a CPU one takes
:func:`mixture_pdf_plain`; there is no fallback from one to the other,
and the CUDA path raises on an input it does not take (not float32, the
mixture elsewhere or not contiguous, or too large for a block's shared
memory). One kernel takes every ``Nd`` and ``ny`` at run time (the main
paths run 2 and 2). ``mixture_pdf.launches`` counts launches (no rows
launch nothing). The plain version is also ``GaussianSum.pdf_t``, over
lanes. The card's ``expf`` and ``logf`` are the ones torch's ``exp`` and
``log`` call there, so the kernel gives ``pdf_t``'s bits on the card; on
the CPU the plain version's ``exp`` parts from them by an ulp or so.
"""
from __future__ import annotations

import torch

from gpu_se_tpu_torch.ops import _build

# |kernel - plain| of the log mode on another device: the terms are
# bit-equal (the same roundings in the same order); the card's expf and
# logf and the CPU's exp and log of the log-sum-exp's sum (in [1, Nd])
# part by an ulp or two of numbers under log(Nd), and adding the largest
# term back rounds at its ulp
LOG_ATOL = 1e-6
LOG_RTOL = 2.4e-7


def mixture_pdf_plain(x, means, inv_cov, log_const, weights, scale=None,
                      log: bool = False) -> torch.Tensor:
    """Plain version of :func:`mixture_pdf` at the rows of ``x (..., ny)``
    (1-d: one point, a 0-d result), one elementwise op at a time in the
    kernel's order (the reference's ``(e @ inv_cov) . e``), any float
    dtype and device."""
    nd, ny = means.shape
    cols = [x[..., i] for i in range(ny)]
    args = []
    for d in range(nd):
        es = [cols[i] - means[d, i] for i in range(ny)]
        quad = None
        for i in range(ny):
            acc = None
            for j in range(ny):
                term = inv_cov[d, j, i] * es[j]
                acc = term if acc is None else acc + term
            t = es[i] * acc
            quad = t if quad is None else quad + t
        args.append(log_const[d] - 0.5 * quad)
    if log:
        logs = [a + torch.log(weights[d]) for d, a in enumerate(args)]
        return torch.logsumexp(torch.stack(logs, dim=-1), dim=-1)
    total = None
    for d, a in enumerate(args):
        comp = weights[d] * torch.exp(a)
        total = comp if total is None else total + comp
    return total if scale is None else scale * total


def _checked(x, means, inv_cov, log_const, weights, scale, log):
    """``x`` at least 2-d; raises on shapes neither version takes."""
    x = torch.atleast_2d(x)
    if means.dim() != 2:
        raise ValueError(f"means {tuple(means.shape)}: expected (Nd, ny)")
    nd, ny = means.shape
    if x.shape[-1] != ny:
        raise ValueError(f"x {tuple(x.shape)}: rows of {ny} expected")
    if (tuple(inv_cov.shape) != (nd, ny, ny)
            or tuple(log_const.shape) != (nd,)
            or tuple(weights.shape) != (nd,)):
        raise ValueError("inv_cov, log_const, weights: expected "
                         f"({nd}, {ny}, {ny}), ({nd},), ({nd},)")
    if scale is not None:
        if log:
            raise ValueError("scale is taken without log only")
        if scale.shape != x.shape[:-1]:
            raise ValueError(f"scale {tuple(scale.shape)}: expected "
                             f"{tuple(x.shape[:-1])}")
    return x


def mixture_pdf(x: torch.Tensor, means, inv_cov, log_const, weights,
                scale=None, log: bool = False) -> torch.Tensor:
    """The mixture's density at each row of ``x (..., ny)`` (``x`` 1-d
    is one row), times ``scale (...)`` where given, or its log where
    ``log``; returns ``(...)`` on ``x``'s device."""
    x = _checked(x, means, inv_cov, log_const, weights, scale, log)
    if not _build.on_cuda(x):
        return mixture_pdf_plain(x, means, inv_cov, log_const, weights,
                                 scale, log)
    dev = x.device
    nd, ny = means.shape
    if x.dtype != torch.float32:
        raise TypeError(f"x: expected torch.float32, got {x.dtype}")
    for name, t in (("means", means), ("inv_cov", inv_cov),
                    ("log_const", log_const), ("weights", weights)):
        _build.check(name, t, torch.float32, t.dim(), dev)
    batch = x.shape[:-1]
    rows = x.reshape(-1, ny)
    n = rows.shape[0]
    s_scale, scale_ptr = 0, None
    if scale is not None:
        if scale.dtype != torch.float32 or scale.device != dev:
            raise TypeError(f"scale: expected torch.float32 on {dev}, got "
                            f"{scale.dtype} on {scale.device}")
        scale = scale.reshape(-1)
        s_scale, scale_ptr = scale.stride(0), scale.data_ptr()
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        rc = lib.gst_mixture_pdf(
            rows.data_ptr(), n, rows.stride(0), rows.stride(1), nd, ny,
            means.data_ptr(), inv_cov.data_ptr(),
            log_const.data_ptr(), weights.data_ptr(), scale_ptr, s_scale,
            int(log), out.data_ptr(), _build.stream(dev))
    _build.launch_check("mixture_pdf", rc)
    if n:
        mixture_pdf.launches += 1
    return out.reshape(batch)


mixture_pdf.launches = 0


def pdf_bytes(n: int, ny: int, scaled: bool = True) -> int:
    """Bytes :func:`mixture_pdf` must move at ``n`` rows: the rows and
    the prior weights read, the density written (the mixture's few
    floats left out)."""
    return 4 * n * (ny + 1 + int(scaled))


def pdf_ops(n: int, nd: int, ny: int, scaled: bool = True) -> int:
    """Float32 operations of the density at ``n`` rows: a component's
    ``ny`` differences, ``ny`` (``ny`` products and ``ny - 1`` sums) of the
    quadratic form's inner sums, ``ny`` products and ``ny - 1`` sums of
    its outer one, the half and the difference, ``exp`` and the weight;
    the ``Nd - 1`` sums over the components and the scale (``exp``
    counted as one)."""
    per_comp = ny + ny * (2 * ny - 1) + 2 * ny - 1 + 2 + 2
    return n * (nd * per_comp + nd - 1 + int(scaled))
