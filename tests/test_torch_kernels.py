"""The CUDA kernels against their plain versions, and the port's CUDA path
against the committed reference step.

This file imports no JAX, so it also runs where JAX is not installed
(``--noconftest`` skips ``tests/conftest.py``, which imports JAX). The
``gpu`` tests need a CUDA card and skip without one; on the card::

    python -m pytest tests/test_torch_kernels.py -m gpu -q --noconftest

The kernels are integer logic plus copies, so every output must equal
the plain version's bit for bit (``torch.equal``).
"""
import os

import numpy as np
import pytest
import torch

from gpu_se_tpu_torch import convert
from gpu_se_tpu_torch.distributions import GaussianSum
from gpu_se_tpu_torch.filters import particle_tiled as pft
from gpu_se_tpu_torch.models import bioreactor as bio
from gpu_se_tpu_torch.ops import _build
from gpu_se_tpu_torch.ops import resample_pallas4 as rp4
from gpu_se_tpu_torch.ops.resample_coarse import ends_from_weights

FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "torch_parity_step.npz")
SIZES = [4096, 5000, 8192, 2**20]
FAMILIES = ["uniform", "near_uniform", "heavy"]
REGIMES = ["heavy", "near_uniform"]
# output rows of one 4096-particle step that may differ from the
# reference's: one per `ends` entry moved by a cumsum tie (0-4 seen)
STEP_TIE_ROWS = 8


def _case(n, family, nx=5):
    rng = np.random.default_rng([n, FAMILIES.index(family)])
    parts = rng.standard_normal((nx, n)).astype(np.float32)
    if family == "uniform":
        w = np.ones(n)
    elif family == "near_uniform":
        w = 1.0 + 0.1 * rng.random(n)
    else:   # lognormal with sigma 4, heavy-tailed like the bench rig's
        w = np.exp(4.0 * rng.standard_normal(n))
    return parts, w.astype(np.float32), np.float32(rng.random())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors the wrappers never build or load the library and
    count no launch."""
    parts, w, r = _case(4096, "heavy")
    before = (rp4.compact.launches, rp4.search_gather.launches)
    ends = ends_from_weights(torch.from_numpy(w), torch.tensor(r))
    x = torch.from_numpy(parts)
    got = rp4.resample_core(x, ends)
    want = rp4.resample_core_plain(x, ends)
    assert all(torch.equal(g, wt) for g, wt in zip(got, want))
    assert (rp4.compact.launches, rp4.search_gather.launches) == before
    assert _build._lib is None


def test_library_name_tracks_sources():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path == _build.library_path()
    assert [p.name for p in _build.sources()] == ["resample.cu"]


@pytest.mark.gpu
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("n", SIZES)
def test_kernels_equal_plain_on_card(cuda, n, family):
    parts, w, r = _case(n, family)
    x = torch.from_numpy(parts).to(cuda)
    ends = ends_from_weights(torch.from_numpy(w).to(cuda),
                             torch.tensor(r, device=cuda))
    launches = (rp4.compact.launches, rp4.search_gather.launches)
    got = rp4.compact(ends, x)
    for g, wt in zip(got, rp4.compact_plain(ends, x)):
        assert torch.equal(g, wt)
    c_keys, c_payload, c_idx, _ = got
    for args in ((c_keys, c_payload, c_idx), (ends, x)):      # both routes
        for g, wt in zip(rp4.search_gather(*args),
                         rp4.search_gather_plain(*args)):
            assert torch.equal(g, wt)
    torch.cuda.synchronize()
    assert (rp4.compact.launches, rp4.search_gather.launches) == (
        launches[0] + 1, launches[1] + 2)


@pytest.mark.gpu
@pytest.mark.parametrize("family", FAMILIES)
def test_ends_reproducible_on_card(cuda, family):
    """``ends`` at 2^20 is the same on every run (``blocked_cumsum``)."""
    _, w, r = _case(2**20, family)
    w, r = torch.from_numpy(w).to(cuda), torch.tensor(r, device=cuda)
    first = ends_from_weights(w, r)
    for _ in range(5):
        assert torch.equal(ends_from_weights(w, r), first)


@pytest.mark.gpu
def test_philox_draw_t_distribution_on_card(cuda):
    """The card's Philox stream: the mean and covariance of 2^20 draws of
    the bench rig's initial mixture match the mixture's (4 standard
    errors; a factor 3 on the covariance's for the mixture's tails)."""
    x_ss = np.array([280 / 180, 640 / 24.6, 1000 / 116, 0.0, 0.0])
    means = np.stack([x_ss, x_ss])
    covs = np.stack([np.eye(5) * 1e-4, np.eye(5) * 1e-3])
    w = np.array([0.75, 0.25])
    gs = GaussianSum.create(means, covs, w, device=cuda)
    size = 2**20
    gen = torch.Generator(device=cuda).manual_seed(0)
    draws = gs.draw_t(gen, size).double().cpu().numpy()
    cov = np.einsum("d,dij->ij", w, covs)
    sd = np.sqrt(np.diag(cov))
    assert np.all(np.abs(draws.mean(axis=1) - x_ss) < 4 * sd / np.sqrt(size))
    se = np.sqrt(3 * (np.outer(sd**2, sd**2) + cov**2) / size)
    assert np.all(np.abs(np.cov(draws) - cov) < 4 * se)


@pytest.mark.gpu
@pytest.mark.parametrize("regime", REGIMES)
def test_cuda_step_matches_reference_fixture(cuda, regime):
    d = np.load(FIXTURE)
    meas = convert.gaussian_sum_from_numpy(
        *(d[f"meas_{f}"] for f in ("means", "covariances", "weights", "chol",
                                   "inv_cov", "log_const")), device=cuda)

    def t(name):
        return torch.from_numpy(d[name]).to(cuda)

    args = (t("x_in"), t("u"), t(f"{regime}_z"), t("dt"),
            bio.homeostatic_des, bio.static_outputs, meas)
    xn, w = pft.predict_update_local(*args, t("noise"))
    want = d[f"{regime}_x_out"]
    # given the reference's ends, the resample is exact
    out, _ = rp4.resample_core(xn, t(f"{regime}_ends"))
    np.testing.assert_array_equal(out.cpu().numpy(), want)
    np.testing.assert_allclose(w.cpu().numpy(), d[f"{regime}_w"],
                               rtol=1e-5, atol=0)
    got = pft.step_from_noise(*args, t("noise"), t("r")).cpu().numpy()
    assert np.count_nonzero(np.any(got != want, axis=0)) <= STEP_TIE_ROWS
