"""Cumsum-domain merge resample through a hand-written CUDA kernel (v3).

Counterpart of ``gpu_se_tpu/ops/resample_pallas3.py``. The kernel,
:func:`cumsum_merge` (``csrc/resample_merge.cu``), replaces that file's
double-buffered Pallas ``_kernel`` and the synchronous v1 ``_kernel`` of
``resample_pallas.py``: both merge the float32 normalized cumsum ``cs``
against the stratified positions ``u_i = (i + r) / n``, so the ancestor
of slot ``i`` is ``min(#{k : cs_k < u_i}, n - 1)``.

This compares floats, not the integer ``ends``, so it agrees with the
``ends`` routes only up to float ties; each entry point is held to its
own reference kernel given the same ``cs`` and ``r``.

The wrapper takes its plain version for CPU tensors and launches the
kernel for CUDA tensors, with no fallback from one to the other;
``cumsum_merge.launches`` counts launches.

Reference names. The reference module's entry point and the function
that takes its place here:

- ``pallas_systematic_resample_pipelined`` ->
  :func:`systematic_resample_pipelined`: ``(particles, weights, r,
  block_slots)`` in the reference's order; no ``window`` or
  ``interpret``. Aliased.
"""
from __future__ import annotations

import math

import torch

from gpu_se_tpu_torch.ops import _build
from gpu_se_tpu_torch.ops.resample_coarse import blocked_cummax, blocked_cumsum

MAX_ROWS = 8


def normalized_cumsum(weights: torch.Tensor, r) -> torch.Tensor:
    """The merge's keys ``cs``: the float32 cumsum of ``weights`` divided
    by its last entry (a device scalar, so the division is exact IEEE on
    a card too), then made non-decreasing by a running max.

    Weights without a finite positive sum (all 0, a sum that overflows, a
    NaN) give a NaN quotient from some entry on. The reference's XLA
    route converts ``floor(n q_k - r)`` to ``ends_k`` with NaN as 0 and
    gives every slot the first entry ``a`` of the last run of ``ends``;
    the keys are then ``-inf`` before ``a`` and ``+inf`` from it, which
    are sorted and give that ancestor through the merge's count. ``r`` is
    the float32 uniform of the resample.
    """
    cs = blocked_cumsum(weights.to(torch.float32))
    q = cs / cs[-1]
    ends = torch.nan_to_num(torch.floor(q.shape[0] * q - r), nan=0.0)
    no_sum = torch.where(ends < ends[-1], -math.inf, math.inf)
    return torch.where(torch.isnan(q[-1]), no_sum, blocked_cummax(q))


def _positions(n: int, r: torch.Tensor) -> torch.Tensor:
    """``(i + r) / n`` in float32 with IEEE division: ``n`` is a device
    tensor, since PyTorch's CUDA division by a host scalar multiplies by
    its reciprocal."""
    n_t = torch.full((), float(n), dtype=torch.float32, device=r.device)
    return (torch.arange(n, dtype=torch.float32, device=r.device) + r) / n_t


def cumsum_merge_plain(cs, payload, r):
    """Plain version of :func:`cumsum_merge`."""
    n = cs.shape[0]
    c = torch.searchsorted(cs, _positions(n, r), out_int32=True)
    anc = c.clamp_max_(n - 1)
    return torch.index_select(payload, 1, anc), anc


def cumsum_merge(cs: torch.Tensor, payload: torch.Tensor, r):
    """Merge ``cs`` float32 ``(n,)`` (non-decreasing) against ``(i + r) /
    n`` and gather ``payload`` float32 ``(rows, n)``.

    Returns ``out (rows, n)`` with ``out[:, i] = payload[:, anc_i]`` (an
    exact copy) and ``anc (n,)`` int32, ``anc_i = min(#{k : cs_k < (i +
    r) / n}, n - 1)``. ``r`` is a float32 uniform, a 0-d tensor or a
    number.
    """
    dev = cs.device
    _build.check("cs", cs, torch.float32, 1, dev)
    _build.check("payload", payload, torch.float32, 2, dev)
    n = cs.shape[0]
    if n == 0 or payload.shape[1] != n:
        raise ValueError(f"payload {tuple(payload.shape)} vs cs ({n},)")
    r = torch.as_tensor(r, dtype=torch.float32, device=dev).reshape(())
    if not _build.on_cuda(cs):
        return cumsum_merge_plain(cs, payload, r)
    lib = _build.load_library()
    rows = payload.shape[0]
    out = torch.empty((rows, n), dtype=torch.float32, device=dev)
    anc = torch.empty((n,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.gst_cumsum_merge(
            cs.data_ptr(), payload.data_ptr(), rows, r.data_ptr(), n,
            out.data_ptr(), anc.data_ptr(), _build.stream(dev))
    _build.launch_check("cumsum_merge", rc)
    cumsum_merge.launches += 1
    return out, anc


cumsum_merge.launches = 0


def merge_entry(particles: torch.Tensor, weights: torch.Tensor, r,
                block_slots: int):
    """Shared body of the v1 and v3 entries: the reference's geometry
    contract (``n % block_slots == 0``, ``block_slots < 2048``, at most
    8 payload columns), then :func:`cumsum_merge`. Returns
    ``(resampled (n, nx) float32, ancestors (n,) int32)``."""
    n, nx = particles.shape
    if n % block_slots:
        raise ValueError(f"particle count {n} is not a multiple of "
                         f"block_slots={block_slots}")
    if block_slots >= 2048:
        raise ValueError(f"block_slots={block_slots}: the reference's "
                         f"known-deadlock geometry")
    if nx > MAX_ROWS:
        raise ValueError(f"payload of {nx} columns exceeds {MAX_ROWS}")
    out, anc = cumsum_merge(
        normalized_cumsum(weights, r),
        particles.to(torch.float32).T.contiguous(), r)
    return out.T, anc


def systematic_resample_pipelined(particles: torch.Tensor,
                                  weights: torch.Tensor, r,
                                  block_slots: int = 128):
    """The v3 entry, with the reference's default geometry: returns
    ``(resampled (n, nx) float32, ancestors (n,) int32)``."""
    return merge_entry(particles, weights, r, block_slots)


# the reference's name: a call with its positional arguments gives the
# same result here
pallas_systematic_resample_pipelined = systematic_resample_pipelined
