"""The mixture density of ``ops/mixture_pdf`` on the CPU: its plain
version, which CPU tensors take (``GaussianSum.pdf`` and ``logpdf``, the
filters' updates), in the kernel's order.

The plain version rounds every difference, product and sum on its own
in ``GaussianSum.pdf_t``'s order, so the two agree bit for bit; the
``scale`` is the update's separate multiply; the log mode stays finite
where the density underflows. The card's kernel is held to ``pdf_t`` on
the card by the ``gpu`` tests of ``tests/test_torch_kernels.py``.
"""
import numpy as np
import pytest
import torch

from gpu_se_tpu_torch import rig
from gpu_se_tpu_torch.distributions import GaussianSum
from gpu_se_tpu_torch.ops import mixture_pdf as mpdf


def _mixture(nd, ny, seed=0, symmetric=True):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((nd, ny, ny))
    gs = GaussianSum.create(rng.standard_normal((nd, ny)),
                            a @ a.transpose(0, 2, 1) + ny * np.eye(ny),
                            rng.random(nd) + 0.1, device="cpu")
    if symmetric:
        return gs
    # an asymmetric inverse: e^T M e is the same number as e^T M^T e, so
    # only the order of the roundings tells a transposed index
    skew = torch.from_numpy(
        rng.normal(scale=0.3, size=(nd, ny, ny)).astype(np.float32))
    return GaussianSum(gs.means, gs.covariances, gs.weights, gs.chol,
                       (gs.inv_cov + skew).contiguous(), gs.log_const)


MIXTURES = {
    "measurement": lambda: GaussianSum.create(*rig.bench_rig()[2],
                                              device="cpu"),
    "one_component": lambda: _mixture(1, 3, 1),
    "asymmetric_2x2": lambda: _mixture(2, 2, 2, symmetric=False),
    "asymmetric_3x5": lambda: _mixture(3, 5, 3, symmetric=False),
}


def _params(gs):
    return gs.means, gs.inv_cov, gs.log_const, gs.weights


def _points(gs, n, spread=2.0, seed=0):
    """``(n, ny)`` float32 rows about the first component, read
    column-major (the filters' residual's layout)."""
    ny = gs.n_dim
    rng = np.random.default_rng(seed)
    cols = (gs.means[0].numpy()[:, None]
            + spread * rng.standard_normal((ny, n))).astype(np.float32)
    return torch.from_numpy(cols).T


@pytest.mark.parametrize("name", sorted(MIXTURES))
def test_plain_equals_pdf_t_bit_for_bit(name):
    gs = MIXTURES[name]()
    x = _points(gs, 5003)
    assert torch.equal(gs.pdf(x), gs.pdf_t(x.T))
    assert torch.equal(gs.pdf(x.contiguous()), gs.pdf_t(x.T))


@pytest.mark.parametrize("name", sorted(MIXTURES))
def test_scale_is_the_separate_multiply(name):
    gs = MIXTURES[name]()
    x = _points(gs, 777, seed=1)
    w = torch.rand(777, generator=torch.Generator().manual_seed(2))
    assert torch.equal(gs.pdf(x, scale=w), w * gs.pdf(x))


@pytest.mark.parametrize("name", sorted(MIXTURES))
def test_density_equals_the_einsum_in_float64(name):
    """In float64 the unrolled order and the einsum the port called
    before give the same density to rounding."""
    g32 = MIXTURES[name]()
    gs = GaussianSum(*(getattr(g32, f).double() for f in
                       ("means", "covariances", "weights", "chol",
                        "inv_cov", "log_const")))
    x = _points(g32, 1000, seed=3).double()
    es = x[:, None, :] - gs.means
    quad = torch.einsum("ndi,dij,ndj->nd", es, gs.inv_cov, es)
    want = torch.sum(gs.weights * torch.exp(gs.log_const - 0.5 * quad), -1)
    torch.testing.assert_close(gs.pdf(x), want, rtol=1e-12, atol=0)
    torch.testing.assert_close(
        gs.logpdf(x), torch.logsumexp(gs.log_const - 0.5 * quad
                                      + torch.log(gs.weights), -1),
        rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", sorted(MIXTURES))
def test_logpdf_finite_where_pdf_underflows(name):
    gs = MIXTURES[name]()
    near = _points(gs, 2000, spread=0.5, seed=4)
    torch.testing.assert_close(gs.logpdf(near), torch.log(gs.pdf(near)),
                               rtol=1e-5, atol=1e-5)
    widest = float(torch.diagonal(gs.covariances, dim1=1, dim2=2).max())
    far = _points(gs, 2000, spread=60.0 * widest ** 0.5, seed=5)
    assert (gs.pdf(far) == 0).any()
    assert torch.isfinite(gs.logpdf(far)).all()


def test_batch_shapes():
    gs = MIXTURES["measurement"]()
    x = _points(gs, 24).reshape(2, 3, 4, 2)
    got = gs.pdf(x)
    assert got.shape == (2, 3, 4)
    assert torch.equal(got.reshape(-1), gs.pdf(x.reshape(-1, 2)))
    assert gs.pdf(x[0, 0, 0]).shape == (1,)
    assert gs.logpdf(x).shape == (2, 3, 4)


@pytest.mark.parametrize("case", ["columns", "scale_shape", "scale_log",
                                  "inv_cov_shape", "means_dims"])
def test_inputs_either_version_refuses(case):
    gs = MIXTURES["measurement"]()
    x = _points(gs, 16)
    means, inv_cov, log_const, weights = _params(gs)
    kwargs = {}
    if case == "columns":
        x = torch.zeros((16, 3))
    elif case == "scale_shape":
        kwargs = {"scale": torch.ones(15)}
    elif case == "scale_log":
        kwargs = {"scale": torch.ones(16), "log": True}
    elif case == "inv_cov_shape":
        inv_cov = inv_cov[:, :1]
    else:
        means = means[0]
    with pytest.raises(ValueError):
        mpdf.mixture_pdf(x, means, inv_cov, log_const, weights, **kwargs)


def test_pdf_t_is_the_plain_version_over_lanes():
    """``pdf_t`` takes its lanes first and keeps their batch shape: a
    single point gives a 0-d density, a ``(ny, a, b)`` batch ``(a, b)``,
    each the plain version's value at the rows."""
    gs = MIXTURES["asymmetric_3x5"]()
    x = _points(gs, 24, seed=6)
    lanes = x.T.reshape(5, 4, 6)
    got = gs.pdf_t(lanes)
    assert got.shape == (4, 6)
    assert torch.equal(got.reshape(-1), mpdf.mixture_pdf_plain(
        x.contiguous(), *_params(gs)))
    one = gs.pdf_t(x[3])
    assert one.shape == () and torch.equal(one, got.reshape(-1)[3])


def test_bytes_and_operations_of_the_update():
    """At the flat PF's 2^20 rows of two outputs: 8 bytes of residual and
    4 of prior weight read and 4 written a row; 32 operations a row."""
    n = 2**20
    assert mpdf.pdf_bytes(n, 2) == 16 * n
    assert mpdf.pdf_bytes(n, 2, scaled=False) == 12 * n
    assert mpdf.pdf_ops(n, 2, 2) == 32 * n
