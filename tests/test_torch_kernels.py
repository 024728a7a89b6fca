"""The CUDA kernels against their plain versions, the port's CUDA path
against the committed reference step, and the router's routes and the
flat filter on the card (each route launching its kernel).

This file imports no JAX, so it also runs where JAX is not installed
(``--noconftest`` skips ``tests/conftest.py``, which imports JAX). The
``gpu`` tests need a CUDA card and skip without one; on the card::

    python -m pytest tests/test_torch_kernels.py -m gpu -q --noconftest

The kernels are integer logic plus copies, so every output must equal
the plain version's bit for bit (``torch.equal``).
"""
import contextlib
import os
import shutil

import numpy as np
import pytest
import torch

from gpu_se_tpu_torch import convert, rig, trace
from gpu_se_tpu_torch.distributions import GaussianSum
from gpu_se_tpu_torch.filters import gs_ukf as gsf
from gpu_se_tpu_torch.filters import particle as pf
from gpu_se_tpu_torch.filters import particle_tiled as pft
from gpu_se_tpu_torch.filters import resampling as rs
from gpu_se_tpu_torch.models import bioreactor as bio
from gpu_se_tpu_torch.ops import _build
from gpu_se_tpu_torch.ops import counter_draw as cd
from gpu_se_tpu_torch.ops import mixture_pdf as mpdf
from gpu_se_tpu_torch.ops import resample_coarse as rc
from gpu_se_tpu_torch.ops import resample_pallas2 as rp2
from gpu_se_tpu_torch.ops import resample_pallas3 as rp3
from gpu_se_tpu_torch.ops import resample_pallas4 as rp4
from gpu_se_tpu_torch.ops import resample_pallas_block as rpb
from gpu_se_tpu_torch.ops.resample_coarse import ends_from_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "torch_parity_step.npz")
GSUKF_FIXTURE = os.path.join(REPO, "tests", "data", "torch_parity_gsukf.npz")
SIZES = [4096, 5000, 8192, 2**20]
FAMILIES = ["uniform", "near_uniform", "heavy"]
REGIMES = ["heavy", "near_uniform"]
# output rows of one 4096-particle step that may differ from the
# reference's: one per `ends` entry moved by a cumsum tie (0-4 seen)
STEP_TIE_ROWS = 8
# the GSUKF on the card: the weights go through the density kernel
# (``pdf_t``'s order) and expf, an ulp or so off the reference's einsum
W_RTOL = 1e-5


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
    count no launch: the resample's and the mixture density's (the
    filters' update, ``GaussianSum.pdf`` and ``logpdf``)."""
    parts, w, r = _case(4096, "heavy")
    before = (rp4.compact.launches, rp4.expand.launches,
              mpdf.mixture_pdf.launches)
    ends = ends_from_weights(torch.from_numpy(w), torch.tensor(r))
    x = torch.from_numpy(parts)
    got = rp4.resample_core(x, ends)
    want = rp4.resample_core_plain(x, ends)
    assert all(torch.equal(g, wt) for g, wt in zip(got, want))
    meas = GaussianSum.create(*rig.bench_rig()[2], device="cpu")
    params = (meas.means, meas.inv_cov, meas.log_const, meas.weights)
    resid = 3.0 * x[:2].T
    prior = torch.from_numpy(w)
    assert torch.equal(meas.pdf(resid, scale=prior), mpdf.mixture_pdf_plain(
        resid, *params, scale=prior))
    assert torch.equal(meas.logpdf(resid), mpdf.mixture_pdf_plain(
        resid, *params, log=True))
    assert (rp4.compact.launches, rp4.expand.launches,
            mpdf.mixture_pdf.launches) == before
    assert _build._lib is None


def test_library_name_tracks_sources():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path == _build.library_path()
    assert [p.name for p in _build.sources()] == [
        "counter_draw.cu", "graph_cond.cu", "mixture_pdf.cu", "resample.cu",
        "resample_block.cu", "resample_coarse.cu", "resample_expand.cu",
        "resample_merge.cu", "trace.cu"]


def test_library_name_tracks_headers(tmp_path, monkeypatch):
    """Editing a shared ``*.cuh`` header changes the library's name, so
    the card never loads a library built from the old header; headers
    are found through ``-I csrc`` and never compiled on their own."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert [p.name for p in _build.headers()] == [
        "lower_bound.cuh", "merge_path.cuh", "trace_ring.cuh",
        "warp_stage.cuh"]
    before = _build.library_path()
    header = csrc / "lower_bound.cuh"
    header.write_text(header.read_text() + "// edited\n")
    assert _build.library_path() != before
    compiles, link = _build.commands("nvcc", "lib.so", str(tmp_path))
    assert [c[c.index("-c") + 1] for c in compiles] == [
        str(p) for p in _build.sources()]
    for cmd in compiles:
        assert cmd[cmd.index("-I") + 1] == str(csrc)
        assert "-shared" not in cmd
    assert "-shared" in link
    assert not any(a.endswith(".cuh") for c in compiles + [link] for a in c)


@pytest.mark.gpu
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("n", SIZES)
def test_kernels_equal_plain_on_card(cuda, n, family):
    parts, w, r = _case(n, family)
    x = torch.from_numpy(parts).to(cuda)
    ends = ends_from_weights(torch.from_numpy(w).to(cuda),
                             torch.tensor(r, device=cuda))
    launches = (rp4.compact.launches, rp4.expand.launches)
    got = rp4.compact(ends, x)
    for g, wt in zip(got, rp4.compact_plain(ends, x)):
        assert torch.equal(g, wt)
    c_keys, c_payload, c_idx, _ = got
    for args in ((c_keys, c_payload, c_idx), (ends, x)):      # both routes
        for g, wt in zip(rp4.expand(*args), rp4.expand_plain(*args)):
            assert torch.equal(g, wt)
    torch.cuda.synchronize()
    assert (rp4.compact.launches, rp4.expand.launches) == (
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


# ----------------------------------------------------------------------
# the merge kernels: ends_merge_round and cumsum_merge
# ----------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("n", [4096, 5120, 2**20])
def test_merge_kernels_equal_plain_on_card(cuda, n, family):
    _, w, r = _case(n, family)
    rng = np.random.default_rng(n)
    w_d, r_d = torch.from_numpy(w).to(cuda), torch.tensor(r, device=cuda)
    ends = ends_from_weights(w_d, r_d)
    cs = rp3.normalized_cumsum(w_d, r_d)
    launches = (rpb.ends_merge_round.launches, rp3.cumsum_merge.launches)
    for nx in (5, 30):
        parts = torch.from_numpy(
            rng.standard_normal((n, nx)).astype(np.float32)).to(cuda)
        got = rpb.ends_merge_round(ends, parts, 0,
                                   *rpb.block_resample_state(n, nx, cuda))
        want = rpb.ends_merge_round_plain(
            ends, parts, 0, *rpb.block_resample_state(n, nx, cuda))
        for g, wt in zip(got, want):
            assert torch.equal(g, wt)
    for rows in (5, 8):
        payload = torch.from_numpy(
            rng.standard_normal((rows, n)).astype(np.float32)).to(cuda)
        for g, wt in zip(rp3.cumsum_merge(cs, payload, r_d),
                         rp3.cumsum_merge_plain(cs, payload, r_d)):
            assert torch.equal(g, wt)
    torch.cuda.synchronize()
    assert (rpb.ends_merge_round.launches, rp3.cumsum_merge.launches) == (
        launches[0] + 2, launches[1] + 2)


@pytest.mark.gpu
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("n", [4096, 5120, 2**20])
def test_coarse_gather_equals_plain_on_card(cuda, n, family):
    _, w, r = _case(n, family)
    rng = np.random.default_rng(n + 1)
    ends = ends_from_weights(torch.from_numpy(w).to(cuda),
                             torch.tensor(r, device=cuda))
    o = rc.chunk_boundaries(ends, n)
    launches = rc.coarse_gather.launches
    for rows in (5, 6):
        payload = torch.from_numpy(
            rng.standard_normal((rows, n)).astype(np.float32)).to(cuda)
        for g, wt in zip(rc.coarse_gather(ends, o, payload),
                         rc.coarse_gather_plain(ends, o, payload)):
            assert torch.equal(g, wt)
    torch.cuda.synchronize()
    assert rc.coarse_gather.launches == launches + 2


@pytest.mark.gpu
def test_ends_merge_four_block_feed_on_card(cuda):
    """Four ascending source blocks into four shards (``slot0``
    offsets) equal one round over the whole pool."""
    n, q = 2**20, 4
    parts, w, r = _case(n, "heavy", nx=5)
    x = torch.from_numpy(parts.T.copy()).to(cuda)
    ends = ends_from_weights(torch.from_numpy(w).to(cuda),
                             torch.tensor(r, device=cuda))
    whole = rpb.ends_merge_round(ends, x, 0,
                                 *rpb.block_resample_state(n, 5, cuda))
    n_blk = n_local = n // q
    for s in range(q):
        state = rpb.block_resample_state(n_local, 5, cuda)
        for b in range(q):
            sl = slice(b * n_blk, (b + 1) * n_blk)
            state = rpb.ends_merge_round(ends[sl].contiguous(),
                                         x[sl].contiguous(), s * n_local,
                                         *state)
        rows = slice(s * n_local, (s + 1) * n_local)
        for g, wt in zip(state, whole):
            assert torch.equal(g, wt[rows])


@pytest.mark.gpu
def test_router_auto_routes_launch_their_kernels_on_card(cuda):
    """Auto on CUDA tensors: ``(n, 5)`` takes compact + expand, ``(n,
    8)`` the cumsum merge, a (means, covs) bank the ends merge and
    ``systematic_resample_bank`` compact + expand; each equals
    its route's plain versions on the same tensors. ``impl("coarse")``
    takes the coarse search."""
    n = 2**16
    rng = np.random.default_rng(0)
    w = torch.from_numpy(np.exp(4.0 * rng.standard_normal(n)).astype(
        np.float32)).to(cuda)
    r = torch.tensor(np.float32(0.37), device=cuda)

    def rand(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(cuda)

    def counts():
        return (rp4.compact.launches, rp4.expand.launches,
                rpb.ends_merge_round.launches, rp3.cumsum_merge.launches,
                rc.coarse_gather.launches)

    x5, x8, means = rand(n, 5), rand(n, 8), rand(n, 5)
    a = rand(n, 5, 5)
    covs = a + a.transpose(1, 2)
    ends = ends_from_weights(w, r)
    idx = rs.indices_from_ends(ends).long()

    c0 = counts()
    got, _ = rs.systematic_resample_from_r(x5, w, r)
    assert torch.equal(got, x5[idx])
    c1 = counts()
    assert (c1[0] - c0[0], c1[1] - c0[1]) == (1, 1)
    got, _ = rs.systematic_resample_from_r(x8, w, r)
    want, _ = rp3.cumsum_merge_plain(rp3.normalized_cumsum(w, r),
                                     x8.T.contiguous(), r)
    assert torch.equal(got, want.T)
    c2 = counts()
    assert c2[3] - c1[3] == 1
    (gm, gc), _ = rs.systematic_resample_from_r((means, covs), w, r)
    assert torch.equal(gm, means[idx]) and torch.equal(gc, covs[idx])
    c3 = counts()
    assert c3[2] - c2[2] == 1
    (gm, gc), _ = rs.systematic_resample_bank_from_r(means, covs, w, r)
    assert torch.equal(gm, means[idx]) and torch.equal(gc, covs[idx])
    c4 = counts()
    assert (c4[0] - c3[0], c4[1] - c3[1]) == (1, 1)
    with rs.impl("coarse"):
        got, _ = rs.systematic_resample_from_r(x5, w, r)
    assert torch.equal(got, x5[idx])
    assert rc.coarse_gather.launches - c4[4] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("route, kernel", [("auto", rp4.expand),
                                           ("ends", rpb.ends_merge_round),
                                           ("coarse", rc.coarse_gather)])
def test_router_all_zero_weights_on_card(cuda, route, kernel):
    """Weights that sum to 0 at 2^20: the card's route launches its
    kernel and gives what the CPU route gives, every slot particle 0,
    the reference's answer (``test_torch_resample_router.py`` holds the
    CPU route to it); so does the bank route."""
    n = 2**20
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((n, 5)).astype(np.float32))
    w = torch.zeros(n)
    r = torch.tensor(np.float32(0.37))
    first = x[:1].expand(n, 5)
    with rs.impl(route):
        want, _ = rs.systematic_resample_from_r(x, w, r)
        launches = kernel.launches
        got, _ = rs.systematic_resample_from_r(x.to(cuda), w.to(cuda),
                                               r.to(cuda))
        torch.cuda.synchronize()
    assert kernel.launches == launches + 1
    assert torch.equal(want, first)
    assert torch.equal(got.cpu(), want)
    if route == "auto":
        covs = x[:, :, None] * x[:, None, :]
        launches = rp4.compact.launches
        (gm, gc), _ = rs.systematic_resample_bank_from_r(
            x.to(cuda), covs.to(cuda), w.to(cuda), r.to(cuda))
        torch.cuda.synchronize()
        assert rp4.compact.launches == launches + 1
        assert torch.equal(gm.cpu(), first)
        assert torch.equal(gc.cpu(), covs[:1].expand(n, 5, 5))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", rig.NO_SUM_KINDS)
@pytest.mark.parametrize("route", ["v3", "pallas"])
def test_merge_routes_without_a_finite_sum_on_card(cuda, route, kind):
    """Weights without a finite positive sum at 2^20: the cumsum-merge
    routes launch ``cumsum_merge`` and give what the CPU route gives, one
    particle in every slot (``test_torch_resample_router.py`` holds the
    CPU route to the reference's XLA route)."""
    n = 2**20
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((n, 5)).astype(np.float32))
    w = torch.from_numpy(rig.no_sum_weights(kind, n))
    r = torch.tensor(np.float32(0.37))
    with rs.impl(route):
        want, _ = rs.systematic_resample_from_r(x, w, r)
        launches = rp3.cumsum_merge.launches
        got, _ = rs.systematic_resample_from_r(x.to(cuda), w.to(cuda),
                                               r.to(cuda))
        torch.cuda.synchronize()
    assert rp3.cumsum_merge.launches == launches + 1
    assert torch.equal(want, want[:1].expand(n, 5))
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("route, kernel", [("ends", "ends_merge_round"),
                                           ("v3", "cumsum_merge"),
                                           ("pallas", "cumsum_merge"),
                                           ("coarse", "coarse_gather"),
                                           ("auto", "expand")])
def test_flat_filter_steps_on_card(cuda, route, kernel):
    """Three chained ``ParticleFilter`` steps at 2^16 through a route:
    one launch of the route's kernel per step, finite moments."""
    x_ss = np.array([280 / 180, 640 / 24.6, 1000 / 116, 0.0, 0.0])
    state_noise = (np.zeros((2, 5)),
                   np.stack([np.diag([1e-4, 1e-7, 1e-3, 1e-3, 1e-7]),
                             np.diag([1e-3, 1e-6, 1e-2, 1e-2, 1e-6])]),
                   np.array([0.75, 0.25]))
    x0 = GaussianSum.create(state_noise[0] + x_ss, *state_noise[1:],
                            device=cuda)
    meas = GaussianSum.create(
        np.array([[1e-1, 0], [0, -1e-1]]),
        np.array([[[6e-2, 0], [0, 8e-2]], [[500, 100], [100, 700]]]),
        np.array([0.85, 0.15]), device=cuda)
    filt = pf.ParticleFilter(bio.homeostatic_des, bio.static_outputs, 2**16,
                             x0, GaussianSum.create(*state_noise,
                                                    device=cuda),
                             meas, seed=1)
    fn = {"ends_merge_round": rpb.ends_merge_round,
          "cumsum_merge": rp3.cumsum_merge,
          "coarse_gather": rc.coarse_gather,
          "expand": rp4.expand}[kernel]
    u = torch.tensor([0.06, 0.2], device=cuda)
    z = bio.static_outputs(torch.from_numpy(x_ss)).to(torch.float32).to(cuda)
    before = fn.launches
    with rs.impl(route):
        for _ in range(3):
            filt.step(u, z, 0.1)
    torch.cuda.synchronize()
    assert fn.launches - before == 3
    est, cov = filt.moments()
    assert torch.isfinite(est).all() and torch.isfinite(cov)


@pytest.mark.gpu
def test_philox_draw_distribution_on_card(cuda):
    """The card's ``draw`` at 2^20: component shares, and each
    component's mean and covariance (4 standard errors)."""
    gs = GaussianSum.create(
        np.array([[1e-1, 0], [0, -1e-1]]),
        np.array([[[6e-2, 0], [0, 8e-2]], [[500, 100], [100, 700]]]),
        np.array([0.85, 0.15]), device=cuda)
    size = 2**20
    eps, comp = gs.draw_inputs(torch.Generator(device=cuda).manual_seed(0),
                               size)
    draws = gs.draw_from(eps, comp).double().cpu().numpy()
    comp = comp.cpu().numpy()
    w = np.array([0.85, 0.15])
    for d in range(2):
        pick = draws[comp == d]
        m = len(pick)
        assert abs(m / size - w[d]) < 4 * np.sqrt(w[d] * (1 - w[d]) / size)
        cov = gs.covariances[d].double().cpu().numpy()
        sd = np.sqrt(np.diag(cov))
        mean_err = pick.mean(axis=0) - gs.means[d].double().cpu().numpy()
        assert np.all(np.abs(mean_err) < 4 * sd / np.sqrt(m))
        se = np.sqrt(3 * (np.outer(sd**2, sd**2) + cov**2) / m)
        assert np.all(np.abs(np.cov(pick.T) - cov) < 4 * se)


# ----------------------------------------------------------------------
# the v2 expansion kernel and the GSUKF
# ----------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("n", [4096, 5001, 2**20])
def test_expand_equals_plain_at_every_block_on_card(cuda, n, family):
    """On compacted keys (strictly increasing, the window bound holds)
    and on the raw ``ends`` (repeated keys: the search runs past the
    window), at chunk sizes from 1 to past the staged window; every
    chunk size gives the same bits."""
    parts, w, r = _case(n, family)
    x = torch.from_numpy(parts).to(cuda)
    ends = ends_from_weights(torch.from_numpy(w).to(cuda),
                             torch.tensor(r, device=cuda))
    c_keys, c_payload, c_idx, _ = rp4.compact(ends, x)
    launches = rp2.expand.launches
    calls = 0
    for args in ((c_keys, c_payload, c_idx), (ends, x)):
        want = rp2.expand_plain(*args)
        for block in (1, 512, 1024, 2048, 4096, 10000):
            got = rp2.expand(*args, block=block)
            calls += 1
            for g, p in zip(got, want):
                assert torch.equal(g, p)
    torch.cuda.synchronize()
    assert rp2.expand.launches == launches + calls


@pytest.mark.gpu
@pytest.mark.parametrize("window, block", [(1024, 1024), (4096, 2048)])
def test_v2_entry_on_card_equals_the_plain_route(cuda, window, block):
    """The v2 entry on the card against the plain route on the CPU, given
    the card's ``ends``: bit-equal rows and ancestors."""
    n = 2**16
    parts, w, r = _case(n, "heavy")
    x = torch.from_numpy(parts.T.copy()).to(cuda)
    w_d, r_d = torch.from_numpy(w).to(cuda), torch.tensor(r, device=cuda)
    before = (rp4.compact.launches, rp2.expand.launches)
    got, anc = rp2.resample_v2_core(x, w_d, r_d, window, block)
    torch.cuda.synchronize()
    assert (rp4.compact.launches, rp2.expand.launches) == (
        before[0] + 1, before[1] + 1)
    idx = rs.indices_from_ends(ends_from_weights(w_d, r_d).cpu())
    assert torch.equal(anc.cpu(), idx)
    assert torch.equal(got.cpu(), x.cpu()[idx.long()])


@pytest.mark.gpu
def test_gsukf_step_on_card_matches_fixture(cuda):
    """The reference's GSUKF step (tests/data/torch_parity_gsukf.npz) on
    the card: means bit-equal, weights within ``W_RTOL``, covariances
    exactly symmetric; given the reference's ``ends`` the bank resample
    is bit-equal; the whole step, with the card's own ``ends``, differs
    in at most ``STEP_TIE_ROWS`` rows. The v2 entry equals the
    reference's on its integer-weight case."""
    d = np.load(GSUKF_FIXTURE)
    meas = convert.gaussian_sum_from_numpy(
        *(d[f"meas_{f}"] for f in ("means", "covariances", "weights", "chol",
                                   "inv_cov", "log_const")), device=cuda)

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(cuda)

    n = d["means_in"].shape[0]
    noise = t(rig.gsukf_noise(d["noise_sd"], n, int(d["noise_seed"])))
    args = (t(d["u"]), t(d["z"]))
    means, covs = gsf.predict_core(t(d["means_in"]), t(d["covs_in"]),
                                   args[0], t(d["dt"]), noise,
                                   bio.homeostatic_des, noise_is_lanes=True)
    means, covs, w = gsf.update_core(means, covs, t(d["w_in"]), *args,
                                     bio.static_outputs, meas)
    assert torch.equal(covs, covs.mT)
    np.testing.assert_array_equal(means.cpu().numpy(), d["upd_means"])
    np.testing.assert_allclose(w.cpu().numpy(), d["upd_w"], rtol=W_RTOL,
                               atol=0)
    ti, tj = torch.triu_indices(5, 5, device=cuda)
    payload = torch.cat([means.T, covs[:, ti, tj].T]).contiguous()
    out, _ = rp4.resample_core(payload, t(d["ends"]))
    np.testing.assert_array_equal(out[:5].T.cpu().numpy(), d["out_means"])
    (m2, c2), _ = gsf.step_from_noise(
        t(d["means_in"]), t(d["covs_in"]), t(d["w_in"]), *args, t(d["dt"]),
        bio.homeostatic_des, bio.static_outputs, meas, noise, t(d["r"]),
        noise_is_lanes=True)
    differ = (np.any(m2.cpu().numpy() != d["out_means"], axis=1)
              | np.any(c2.cpu().numpy() != d["out_covs"], axis=(1, 2)))
    assert np.count_nonzero(differ) <= STEP_TIE_ROWS
    parts, w2, r2 = rig.v2_case(n, int(d["v2_seed"]))
    got = rp2.fused_systematic_resample_v2(
        t(parts), t(w2), torch.tensor(r2, device=cuda),
        window=int(d["v2_window"]), block=int(d["v2_block"]))
    np.testing.assert_array_equal(got.cpu().numpy(), d["v2_out"])


@pytest.mark.gpu
def test_gsukf_filter_steps_on_card(cuda):
    """Three chained filter steps at 2^16 Gaussians through the bank
    route: one compact and one expand per step, exactly symmetric
    covariances, finite moments."""
    x_ss = np.array([280 / 180, 640 / 24.6, 1000 / 116, 0.0, 0.0])
    x0 = GaussianSum.create(np.stack([x_ss, x_ss]),
                            np.stack([np.eye(5) * 1e-4, np.eye(5) * 1e-3]),
                            np.array([0.75, 0.25]))
    state_pdf = GaussianSum.create(
        np.zeros((2, 5)), np.stack([np.diag([1e-4, 1e-7, 1e-3, 1e-3, 1e-7]),
                                    np.diag([1e-3, 1e-6, 1e-2, 1e-2, 1e-6])]),
        np.array([0.75, 0.25]))
    meas = GaussianSum.create(
        np.array([[1e-1, 0], [0, -1e-1]]),
        np.array([[[6e-2, 0], [0, 8e-2]], [[500, 100], [100, 700]]]),
        np.array([0.85, 0.15]))
    filt = gsf.GaussianSumUnscentedKalmanFilter(
        bio.homeostatic_des, bio.static_outputs, 2**16, x0, state_pdf, meas,
        seed=2)
    assert filt.means.is_cuda
    u = torch.tensor([0.06, 0.2], device=cuda)
    z = bio.static_outputs(torch.from_numpy(x_ss)).to(torch.float32).to(cuda)
    before = (rp4.compact.launches, rp4.expand.launches)
    for _ in range(3):
        filt.step(u, z, 0.1)
    torch.cuda.synchronize()
    assert (rp4.compact.launches - before[0],
            rp4.expand.launches - before[1]) == (3, 3)
    assert torch.equal(filt.covariances, filt.covariances.mT)
    est, cov = filt.moments()
    assert torch.isfinite(est).all() and torch.isfinite(cov)


# ----------------------------------------------------------------------
# compact (one launch, decoupled look-back) and expand (warp bracket,
# 4 slots a thread) on the edge cases shared with the CPU tests
# ----------------------------------------------------------------------
EDGE_CASES = rig.edge_cases()
EDGE_IDS = [rig.edge_id(c) for c in EDGE_CASES]


def _edge_inputs(case, dev):
    family, n, rows = case
    exact = rig.edge_exact_ends(family, n)
    if exact is not None:
        ends = torch.from_numpy(exact).to(dev)
    else:
        w, r = rig.edge_weights(family, n)
        ends = ends_from_weights(torch.from_numpy(w).to(dev),
                                 torch.tensor(r, device=dev))
    return ends, torch.from_numpy(rig.edge_payload(rows, n)).to(dev)


@pytest.mark.gpu
def test_library_constants_equal_the_models_on_card(cuda):
    """The tile and the staging limit that the CPU tests' numpy models of
    the two kernels take are the ones the kernels were built with."""
    lib = _build.load_library()
    assert lib.gst_compact_tile() == rig.COMPACT_TILE
    assert lib.gst_expand_max_stage() == rig.EXPAND_MAX_STAGE
    assert lib.gst_compact_words(rig.COMPACT_TILE + 1) == 3


@pytest.mark.gpu
@pytest.mark.parametrize("case", EDGE_CASES, ids=EDGE_IDS)
def test_compact_edge_cases_on_card(cuda, case):
    ends, x = _edge_inputs(case, cuda)
    launches = rp4.compact.launches
    got = rp4.compact(ends, x)
    for g, wt in zip(got, rp4.compact_plain(ends, x)):
        assert torch.equal(g, wt)
    assert rp4.compact.launches == launches + 1
    family, n, _ = case
    count = int(got[3])
    if family == "all_survive":
        assert count == n
    elif family == "one_survivor":
        assert count == 1


@pytest.mark.gpu
@pytest.mark.parametrize("case", EDGE_CASES, ids=EDGE_IDS)
def test_expand_edge_cases_on_card(cuda, case):
    """Every chunk size, on the compacted keys with their indices and on
    the raw ``ends`` (repeated keys) without."""
    ends, x = _edge_inputs(case, cuda)
    c_keys, c_payload, c_idx, _ = rp4.compact_plain(ends, x)
    for args in ((c_keys, c_payload, c_idx), (ends, x)):
        want = rp4.expand_plain(*args)
        for block in rig.EXPAND_BLOCKS:
            for g, p in zip(rp4.expand(*args, block=block), want):
                assert torch.equal(g, p)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2**20, 2**24])
def test_compact_repeats_give_the_same_bits_on_card(cuda, n):
    """200 launches on one input: a race in the look-back would show as
    a rare wrong prefix. At 2^24 there are more tiles than the card
    holds blocks."""
    ends, x = _edge_inputs(("heavy", n, 5), cuda)
    want = rp4.compact_plain(ends, x)
    for _ in range(200):
        for g, wt in zip(rp4.compact(ends, x), want):
            assert torch.equal(g, wt)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4096, 5001, 2**20, 2**20 + 1])
def test_expand_without_src_idx_on_card(cuda, n):
    """``src_idx=None`` returns the positions themselves; n a multiple of
    4 takes the 16-byte stores, any other n the 4-byte ones."""
    ends, x = _edge_inputs(("heavy", n, 5), cuda)
    c_keys, c_payload, _, _ = rp4.compact(ends, x)
    for keys, payload in ((c_keys, c_payload), (ends, x)):
        want = rp4.expand_plain(keys, payload)
        for block in (3, 1024):
            for g, p in zip(rp4.expand(keys, payload, block=block), want):
                assert torch.equal(g, p)


# ----------------------------------------------------------------------
# ends_merge_round and cumsum_merge (the merge path of merge_path.cuh) on
# the edge cases and ring feeds shared with the CPU tests
# ----------------------------------------------------------------------
@pytest.mark.gpu
def test_merge_constants_equal_the_model_on_card(cuda):
    """The block and thread sizes that the CPU tests' numpy model of the
    merge path takes are the ones the kernels were built with."""
    lib = _build.load_library()
    assert lib.gst_merge_threads() == rig.MERGE_THREADS
    assert lib.gst_ends_merge_thread_items() == rig.ENDS_MERGE_ITEMS
    assert lib.gst_cumsum_merge_thread_items() == rig.CUMSUM_MERGE_ITEMS


@pytest.mark.gpu
@pytest.mark.parametrize("case", rig.ends_merge_cases(),
                         ids=[rig.edge_id(c) for c in rig.ends_merge_cases()])
def test_ends_merge_round_edge_cases_on_card(cuda, case):
    family, n, nx = case
    ends, x = _edge_inputs(case, cuda)
    parts = x.T.contiguous()
    launches = rpb.ends_merge_round.launches
    got = rpb.ends_merge_round(ends, parts, 0,
                               *rpb.block_resample_state(n, nx, cuda))
    want = rpb.ends_merge_round_plain(ends, parts, 0,
                                      *rpb.block_resample_state(n, nx, cuda))
    for g, wt in zip(got, want):
        assert torch.equal(g, wt)
    assert rpb.ends_merge_round.launches == launches + 1


@pytest.mark.gpu
@pytest.mark.parametrize("case", rig.cumsum_merge_cases(),
                         ids=[rig.edge_id(c) for c in rig.cumsum_merge_cases()])
def test_cumsum_merge_edge_cases_on_card(cuda, case):
    family, n, rows = case
    w, r = rig.edge_weights(family, n)
    r = torch.tensor(r, device=cuda)
    cs = rp3.normalized_cumsum(torch.from_numpy(w).to(cuda), r)
    payload = torch.from_numpy(rig.edge_payload(rows, n)).to(cuda)
    launches = rp3.cumsum_merge.launches
    for g, wt in zip(rp3.cumsum_merge(cs, payload, r),
                     rp3.cumsum_merge_plain(cs, payload, r)):
        assert torch.equal(g, wt)
    assert rp3.cumsum_merge.launches == launches + 1


@pytest.mark.gpu
@pytest.mark.parametrize("feed", rig.RING_FEEDS,
                         ids=[rig.edge_id(f) for f in rig.RING_FEEDS])
def test_ends_merge_ring_feeds_on_card(cuda, feed):
    """Every shard fed every source block in ascending order, blocks and
    shards of unequal sizes: each round's state equals the plain round's
    on the same state, and the shards together equal one round over the
    whole pool."""
    family, n, blocks, shards = feed
    ends, x = _edge_inputs((family, n, 5), cuda)
    parts = x.T.contiguous()
    whole = rpb.ends_merge_round_plain(ends, parts, 0,
                                       *rpb.block_resample_state(n, 5, cuda))
    src, dst = rig.ring_bounds(n, blocks), rig.ring_bounds(n, shards)
    for s0, s1 in zip(dst, dst[1:]):
        state = rpb.block_resample_state(s1 - s0, 5, cuda)
        for b0, b1 in zip(src, src[1:]):
            want = rpb.ends_merge_round_plain(
                ends[b0:b1], parts[b0:b1], s0, *[t.clone() for t in state])
            state = rpb.ends_merge_round(ends[b0:b1], parts[b0:b1], s0,
                                         *state)
            for g, wt in zip(state, want):
                assert torch.equal(g, wt)
        for g, wt in zip(state, whole):
            assert torch.equal(g, wt[s0:s1])


@pytest.mark.gpu
@pytest.mark.parametrize("nx", [5, 30])
def test_ends_merge_round_on_unaligned_state_on_card(cuda, nx):
    """State views that start 4 bytes past a 16-byte boundary take the
    scalar path; the columns past nx and the rows outside the view keep
    their bits."""
    n = 5001
    ends, x = _edge_inputs(("heavy", n, nx), cuda)
    parts = x.T.contiguous()
    cols = rpb._cols_pad(nx)
    base = [torch.full((n + 1, 1), 7, dtype=torch.int32, device=cuda),
            torch.full((n + 1, cols), -2.5, device=cuda),
            torch.zeros((n + 1, 1), device=cuda)]
    base[2][::3] = 1.0                       # some slots already final
    plain = [t.clone() for t in base]
    got = rpb.ends_merge_round(ends, parts, 3, *[t[1:] for t in base])
    want = rpb.ends_merge_round_plain(ends, parts, 3,
                                      *[t[1:] for t in plain])
    for g, wt in zip(got, want):
        assert torch.equal(g, wt)
    for g, wt in zip(base, plain):
        assert torch.equal(g, wt)


# ----------------------------------------------------------------------
# coarse_gather (chunk boundaries as merge-path splits) on its edge cases
# shared with the CPU tests' numpy model
# ----------------------------------------------------------------------
@pytest.mark.gpu
def test_coarse_constants_equal_the_model_on_card(cuda):
    """The chunks a block takes and the keys it stages, which the CPU
    tests' numpy model of ``coarse_gather`` takes, are the library's."""
    lib = _build.load_library()
    assert lib.gst_coarse_chunks() == rig.COARSE_CHUNKS
    assert lib.gst_coarse_stage() == rig.COARSE_STAGE
    assert rc.BLOCK == rig.COARSE_CHUNK


@pytest.mark.gpu
@pytest.mark.parametrize("case", rig.coarse_cases(),
                         ids=[rig.edge_id(c) for c in rig.coarse_cases()])
def test_coarse_gather_edge_cases_on_card(cuda, case):
    """Bit-equal to the plain version on every case, 2^24 included: the
    one survivor's long last chunk, blocks without keys, exact ``ends``
    where every entry survives."""
    family, n, rows = case
    ends, payload = _edge_inputs(case, cuda)
    o = rc.chunk_boundaries(ends, n)
    launches = rc.coarse_gather.launches
    for g, wt in zip(rc.coarse_gather(ends, o, payload),
                     rc.coarse_gather_plain(ends, o, payload)):
        assert torch.equal(g, wt)
    torch.cuda.synchronize()
    assert rc.coarse_gather.launches == launches + 1


# ----------------------------------------------------------------------
# the QP's chunks of iterations, replayed from a CUDA graph on the card
# ----------------------------------------------------------------------
def _random_qp(n, m, seed):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    A = rng.normal(size=(m, n))
    x = rng.normal(size=n)
    margin = rng.uniform(0.1, 1.0, size=m)
    return M @ M.T + np.eye(n), A, rng.normal(size=n), A @ x - margin, \
        A @ x + margin


@pytest.mark.gpu
@pytest.mark.parametrize("identity", [False, True])
def test_qp_graph_matches_cpu_on_card(cuda, identity):
    """A solve on the card (its chunks replayed from a CUDA graph) ends
    with the CPU solve's status and within 1e-4 of its ``x``; a second
    solve replays the same graph to the same bits; a batch member lands
    within 1e-4 of the CPU's too."""
    from gpu_se_tpu_torch.control import qp

    P, A, q, l, u = _random_qp(20, 30, 3)
    if identity:
        P = np.eye(20)
    solvers = {d: qp.DenseQP(P, A, l, u, q, device=d) for d in ("cpu", cuda)}
    want = solvers["cpu"].solve(q, l, u)
    card = solvers[cuda]
    got = card.solve(q, l, u)
    again = card.solve(q, l, u)
    assert int(got.status) == int(want.status) == qp.SOLVED
    x = want.x.numpy()
    assert np.abs(got.x.cpu().numpy() - x).max() <= 1e-4 * np.abs(x).max()
    for f in ("x", "y", "z", "status", "iterations"):
        assert torch.equal(getattr(got, f), getattr(again, f))
    batch = card.solve_batch(np.stack([q, 2 * q]), np.stack([l, l]),
                             np.stack([u, u]))
    assert batch.status.tolist() == [qp.SOLVED] * 2
    assert np.abs(batch.x[0].cpu().numpy() - x).max() <= 1e-4 * np.abs(x).max()


# ----------------------------------------------------------------------
# the sharded protocols on the card (parallel/sharded.py)
# ----------------------------------------------------------------------
SHARD_N = 2**16
# the kernels each sharded flat route launches at W = 1
SHARD_ROUTES = {"xla": (), "kernel": ("ends_merge_round",),
                "a2a": ("compact", "expand"), "a2a_xla": (), "a2a_ring": (),
                "a2a_ring_v4": ("compact", "expand")}
LAUNCHES = {"compact": rp4.compact, "expand": rp4.expand,
            "ends_merge_round": rpb.ends_merge_round}


def _shard_rows(family, route):
    """This rank's rows of the sharded resample of ``_case(SHARD_N,
    family)`` through ``route`` on the rank's card, with the launches it
    made."""
    from gpu_se_tpu_torch.parallel import make_mesh, particle_sharding
    from gpu_se_tpu_torch.parallel import sharded

    mesh = make_mesh()
    parts, w, r = _case(SHARD_N, family)
    for k in LAUNCHES.values():
        k.launches = 0
    out, _ = sharded._resample(
        particle_sharding(mesh, parts.T), particle_sharding(mesh, w),
        torch.tensor(r, device=mesh.device), mesh,
        sharded._FLAT_ROUTES[route])
    return (out.cpu().numpy(),
            {name: k.launches for name, k in LAUNCHES.items()})


@pytest.mark.gpu
@pytest.mark.parametrize("family", FAMILIES)
def test_sharded_routes_launch_their_kernels_on_card(cuda, family):
    """At W = 1 (no process group) every sharded flat route launches its
    kernels once and gives the rows of the plain gather at the same
    segmented ``ends``, bit for bit."""
    from gpu_se_tpu_torch.parallel import make_mesh
    from gpu_se_tpu_torch.parallel import sharded

    parts, w, r = _case(SHARD_N, family)
    x = torch.from_numpy(parts.T.copy()).to(cuda)
    ends, _ = sharded._segmented_ends(torch.from_numpy(w).to(cuda),
                                      torch.tensor(r, device=cuda),
                                      make_mesh(device=cuda))
    want = x[torch.clamp(rc.indices_from_ends(ends), max=SHARD_N - 1).long()]
    for route, kernels in SHARD_ROUTES.items():
        got, counts = _shard_rows(family, route)
        np.testing.assert_array_equal(got, want.cpu().numpy(), err_msg=route)
        assert counts == {k: int(k in kernels) for k in LAUNCHES}, route


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["xla", "kernel", "a2a_ring_v4",
                                   "a2a_ring"])
def test_sharded_step_graphed_equals_eager_on_card(cuda, route):
    """At W = 1 the flat entry point's step is one graph replay a call
    (the kernel route's skips IF nodes), bit-equal to the same step under
    ``graphs.disabled`` over three chained steps from one seed; the kernel
    route's ``ends_merge_round`` counted at each replay by the card."""
    from gpu_se_tpu_torch import graphs
    from gpu_se_tpu_torch.parallel import make_mesh
    from gpu_se_tpu_torch.results import sharded_steps as ss

    mesh = make_mesh(device=cuda)
    parts = tuple(GaussianSum.create(*a, device=cuda)
                  for a in rig.bench_rig())
    (a, fn, step), (b, _, _) = (ss.entry_step(mesh, f"flat {route}", 0,
                                              parts) for _ in range(2))
    assert fn.graphed
    graphs.settle_counts()
    before = rpb.ends_merge_round.launches
    for _ in range(3):
        a = step(a)
        with graphs.disabled(fn):
            b = step(b)
        assert torch.equal(a.particles, b.particles)
        assert torch.equal(a.weights, b.weights)
    assert fn.replays >= 1
    graphs.settle_counts()
    assert rpb.ends_merge_round.launches - before == (
        6 if route == "kernel" else 0)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["kernel", "a2a", "a2a_ring_v4"])
def test_two_ranks_on_one_card_over_gloo(cuda, route):
    """Two spawned ranks share the card over gloo, which copies each
    exchanged buffer through the host: their rows equal W = 1's."""
    from gpu_se_tpu_torch.parallel.launch import run_group

    want, _ = _shard_rows("heavy", route)
    ranks = run_group(_shard_rows, 2, "heavy", route, timeout_s=300)
    np.testing.assert_array_equal(np.concatenate([g for g, _ in ranks]),
                                  want)
    for _, counts in ranks:
        assert all(counts[k] >= 1 for k in SHARD_ROUTES[route]), counts


@pytest.mark.gpu
@pytest.mark.parametrize("start,count,nx,lanes_last", rig.COUNTER_CASES)
def test_counter_draw_equals_plain_on_card(cuda, start, count, nx,
                                          lanes_last):
    """The production kernel's uniforms bit-equal to the plain version
    and its normals within ``NORMAL_ATOL``, the verification hook's
    Philox words bit-equal; one counted launch (the hook's is not
    counted), none for an empty draw; slices concatenate to the whole
    draw. ``rig.COUNTER_CASES`` covers every compile-time nx and two
    run-time ones."""
    key = torch.tensor([0x1234ABCD, 0x0F0E0D0C], device=cuda)
    before = cd.counter_draw.launches
    empty = cd.counter_draw(key, start, 0, nx, lanes_last)
    assert empty[1].shape == (0,)
    assert cd.counter_draw.launches == before
    eps, u = cd.counter_draw(key, start, count, nx, lanes_last)
    w = cd.counter_words(key, start, count, nx)
    torch.cuda.synchronize()
    assert cd.counter_draw.launches == before + 1
    p_eps, p_u, p_w = cd.counter_draw_plain(key, start, count, nx,
                                            lanes_last, words=True)
    assert torch.equal(w.to(torch.int64) & cd.MASK32, p_w)
    assert torch.equal(u, p_u)
    assert float((eps - p_eps).abs().max()) <= cd.NORMAL_ATOL
    cut = count // 3 + 1
    a, b = (cd.counter_draw(key, start, cut, nx, lanes_last),
            cd.counter_draw(key, start + cut, count - cut, nx, lanes_last))
    assert torch.equal(torch.cat([a[0], b[0]], dim=int(lanes_last)), eps)
    assert torch.equal(torch.cat([a[1], b[1]]), u)


@pytest.mark.gpu
def test_counter_draw_instantiations_on_card(cuda):
    """The library has an instantiation for every compile-time nx of the
    wrapper and refuses one asked for another nx; the verification hook
    launches no counted draw."""
    lib = _build.load_library()
    key = torch.tensor([1, 2], device=cuda)
    eps = torch.empty((8, 5), device=cuda)
    u = torch.empty((8,), device=cuda)
    stream = _build.stream(cuda)
    assert lib.gst_counter_draw(key.data_ptr(), 0, 8, 5, 4, 0,
                                eps.data_ptr(), u.data_ptr(), stream) != 0
    for nx in range(1, cd.MAX_FIXED_NX + 1):
        assert lib.gst_counter_draw(key.data_ptr(), 0, 8, nx, nx, 0,
                                    eps.data_ptr(), u.data_ptr(),
                                    stream) == 0
    assert lib.gst_counter_draw(key.data_ptr(), 0, 8, 6, 6, 0,
                                eps.data_ptr(), u.data_ptr(), stream) != 0
    before = cd.counter_draw.launches
    w = cd.counter_words(key, 0, 8, 5)
    assert w.shape == (8, 8) and cd.counter_draw.launches == before
    assert torch.equal(w.to(torch.int64) & cd.MASK32,
                       cd.words_plain(key, 0, 8, 5))


@pytest.mark.gpu
def test_graphed_pacf_chain_on_card(cuda):
    """The pacf series' chain as one CUDA graph: the kernels launch K
    times at the warm-up and are counted K times at every replay, none at
    the capture; each replay draws fresh noise and steps to finite
    particles; the series of a few reps is one replay a rep (max |pacf|
    takes 12 or more), its steps timed alone by events captured in the
    graph."""
    from gpu_se_tpu_torch.results import _filter_bench as fb
    from gpu_se_tpu_torch.results import pacf_series as ps

    _, x0, state_pdf, meas_pdf = fb.rig_dists(cuda)
    u, z, dt = fb.rig_inputs(cuda)
    x = x0.draw_t(torch.Generator(device=cuda).manual_seed(1), 2**16)
    before = (rp4.compact.launches, rp4.expand.launches)
    chain = ps.GraphedChain(x, 5, ps.K, u, z, dt, state_pdf, meas_pdf)
    captured = (rp4.compact.launches, rp4.expand.launches)
    assert captured == (before[0] + ps.K, before[1] + ps.K)
    one = chain.replay(x).clone()
    two = chain.replay(x).clone()
    torch.cuda.synchronize()
    assert chain.replays == 2
    assert (rp4.compact.launches, rp4.expand.launches) == (
        captured[0] + 2 * ps.K, captured[1] + 2 * ps.K)
    assert torch.isfinite(one).all() and torch.isfinite(two).all()
    assert not torch.equal(one, two)
    out = ps.pacf_series(2**16, ps.K, 12, gpu=True)
    assert out["replays"] == 13 and len(out["device_series_ms"]) == 12
    assert min(out["device_series_ms"]) > 0
    # the events captured in the graph time its steps alone, inside the
    # events around the copy, the launch and the replay
    graph, device = (np.array(out[k]) for k in ("graph_series_ms",
                                                "device_series_ms"))
    assert len(graph) == 12 and min(graph) > 0 and (graph <= device).all()


# ----------------------------------------------------------------------
# conditional nodes and the QP's device loop
# ----------------------------------------------------------------------
def _kept(fn, dev):
    """``fn`` run once, then captured as a graph kept for a node's body."""
    from gpu_se_tpu_torch import graphs

    graphs.warm_up(fn, (), {}, dev)
    return graphs.capture(fn, (), {}, [], dev, keep_graph=True)[0]


@pytest.mark.gpu
def test_graph_cond_loop_on_card(cuda):
    """A WHILE node whose body holds a kept graph and a nested IF, then a
    tail IF, all in one captured graph: each replay starts the loop
    afresh and runs it 7 times, the IF on odd counts, the tail once; the
    count on the card adds the WHILE iterations. Outside a capture the
    wrapper raises."""
    from gpu_se_tpu_torch import graphs
    from gpu_se_tpu_torch.ops import graph_cond as gc

    gc.prepare(cuda)
    n, hits, tails = (torch.zeros((), dtype=torch.int32, device=cuda)
                      for _ in range(3))
    go, odd, more = (torch.zeros((), dtype=torch.bool, device=cuda)
                     for _ in range(3))

    def body():
        n.add_(1)
        go.copy_(n < 7)
        odd.copy_(n % 2 == 1)

    parts = [_kept(fn, cuda) for fn in (
        body, lambda: hits.add_(1), lambda: tails.add_(10))]

    def whole():
        for t in (n, hits, tails):
            t.zero_()
        gc.while_loop(go, [parts[0], gc.If(odd, (parts[1],))])
        more.copy_(n == 7)
        gc.if_then(more, [parts[2]])

    graph = graphs.capture(whole, (), {}, [], cuda)[0]
    gc.reset_iterations(cuda)
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    assert (int(n), int(hits), int(tails)) == (7, 4, 10)
    assert gc.iterations(cuda) == 14
    with pytest.raises(RuntimeError, match="no capture is underway"):
        gc.while_loop(go, [parts[0]])


def _qp_pair(port, qs, ls, us, dev):
    """The device loop's and the host-driven loop's solution of the same
    batch, each with its carried rho and refactorization counts."""
    from gpu_se_tpu_torch.control import qp

    t = lambda v: torch.as_tensor(np.asarray(v), dtype=torch.float32,
                                  device=dev)
    out = []
    for host in (False, True):
        ctx = qp.host_driven() if host else contextlib.nullcontext()
        with ctx:
            sol = port.solve_batch(t(qs), t(ls), t(us))
        loop = qp._card_loop(port.consts, len(qs), port.settings,
                             torch.float32, dev)
        out.append((sol, loop.rho.clone(), loop.refactors.clone()))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(rig.QP_CASES))
def test_qp_device_loop_equals_host_driven_on_card(cuda, name):
    """Every QP solve on the card is one graph whose loop is a WHILE
    node; on a refactorizing solve, a stall at a max_iter between checks
    and the Woodbury path's stall it gives the host-driven loop's
    statuses, iterations, iterates, residuals, rho and refactorization
    counts bit for bit, for a batch whose members stop at their own
    checks; the WHILE ran once a chunk of the longest member; a solve
    inside a caller's capture runs inline and still equals it."""
    import dataclasses

    from gpu_se_tpu_torch import graphs
    from gpu_se_tpu_torch.control import qp
    from gpu_se_tpu_torch.ops import graph_cond as gc

    make, settings, status, refactors = rig.QP_CASES[name]
    P, A, q, l, u = make()
    port = qp.DenseQP(P, A, l, u, q, settings=qp.QPSettings(**settings),
                      device=cuda)
    qs = np.stack([q, 0.5 * q, -q])
    ls, us = np.stack([l] * 3), np.stack([u] * 3)
    port.solve_batch(qs, ls, us)                 # builds the loop
    gc.reset_iterations(cuda)
    (dev_sol, dev_rho, dev_ref), (host_sol, host_rho, host_ref) = _qp_pair(
        port, qs, ls, us, cuda)
    torch.cuda.synchronize()
    assert gc.iterations(cuda) == int(dev_sol.iterations.max()) // \
        port.settings.check_every
    print(name, dev_sol.status.tolist(), dev_sol.iterations.tolist(),
          dev_ref.tolist(), host_ref.tolist())
    for f in dataclasses.fields(dev_sol):
        assert torch.equal(getattr(dev_sol, f.name),
                           getattr(host_sol, f.name)), f.name
    assert torch.equal(dev_rho, host_rho) and torch.equal(dev_ref, host_ref)
    assert int(dev_sol.status[0]) == status
    assert int(dev_ref[0]) >= refactors
    # inline in a caller's graph: warm-up, capture, then replays
    step = graphs.Graphed(lambda a, b, c: dataclasses.astuple(
        port.solve_batch(a, b, c)))
    t = lambda v: torch.as_tensor(v, dtype=torch.float32, device=cuda)
    for _ in range(3):
        got = step(t(qs), t(ls), t(us))
    assert (step.captures, step.replays) == (1, 2)
    for g, w in zip(got, dataclasses.astuple(host_sol)):
        assert torch.equal(g, w)


# ----------------------------------------------------------------------
# mixture_pdf: the measurement density of the flat PF's and the GSUKF's
# updates
# ----------------------------------------------------------------------
def _meas(dev):
    """The benchmark's measurement mixture (``pf_2p20``'s, the bench
    rig's): two components over two outputs."""
    return GaussianSum.create(*rig.bench_rig()[2], device=dev)


def _residual(n, dev, seed):
    """The flat PF's residual ``z - g(x.T).T`` at ``n`` particles drawn
    about the steady state, as ``particle.update`` forms it: a
    column-major view, never copied."""
    x0 = GaussianSum.create(*rig.bench_rig()[0], device=dev)
    parts = x0.draw(torch.Generator(device=dev).manual_seed(seed), (n,))
    z = bio.static_outputs(torch.from_numpy(rig.X_SS)).to(torch.float32)
    resid = z.to(dev) - bio.static_outputs(parts.T).T
    assert not resid.is_contiguous()
    return resid


def _wide(dev, seed=3):
    """A mixture of 3 components over 5 outputs, wider than the main
    paths' 2 x 2."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((3, 5, 5))
    return GaussianSum.create(rng.standard_normal((3, 5)),
                              a @ a.transpose(0, 2, 1) + 5 * np.eye(5),
                              rng.random(3) + 0.1, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2**20, 1000003])
def test_mixture_pdf_equals_pdf_t_on_card(cuda, n):
    """The kernel's density of the flat PF's residual (a non-contiguous
    view) equals ``pdf_t`` evaluated by torch on the card bit for bit:
    both round every difference, product and sum on its own in one
    order, and torch's ``exp`` on the card is the same ``expf``. Scaled
    by prior weights it equals the separate multiply. One launch a
    call."""
    meas = _meas(cuda)
    resid = _residual(n, cuda, n)
    w = torch.rand((n,), generator=torch.Generator(device=cuda).manual_seed(
        1), device=cuda)
    before = mpdf.mixture_pdf.launches
    got = meas.pdf(resid)
    scaled = meas.pdf(resid, scale=w)
    assert mpdf.mixture_pdf.launches == before + 2
    want = meas.pdf_t(resid.T)
    assert torch.equal(got, want)
    assert torch.equal(scaled, w * want)
    assert (got > 0).all() and got.shape == (n,)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2**20, 1000003])
def test_mixture_pdf_run_time_size_on_card(cuda, n):
    """Three components over five outputs take the same kernel, its
    sizes read at run time: bit-equal to ``pdf_t`` on rows read
    column-major and row-major."""
    gs = _wide(cuda)
    cols = torch.randn((5, n), device=cuda,
                       generator=torch.Generator(device=cuda).manual_seed(2))
    want = gs.pdf_t(cols)
    assert torch.equal(gs.pdf(cols.T), want)
    assert torch.equal(gs.pdf(cols.T.contiguous()), want)


@pytest.mark.gpu
def test_mixture_pdf_refuses_what_it_does_not_take_on_card(cuda):
    """The library refuses a scale in the log mode, an empty mixture and
    one past a block's shared memory, and the wrapper raises on an input
    it does not take: no fallback."""
    meas = _meas(cuda)
    resid = _residual(4099, cuda, 5)
    lib = _build.load_library()
    x = torch.zeros((8, 5), device=cuda)
    out = torch.empty((8,), device=cuda)
    gs = _wide(cuda)
    args = (gs.means.data_ptr(), gs.inv_cov.data_ptr(),
            gs.log_const.data_ptr(), gs.weights.data_ptr())

    def call(nd, ny, scale, log):
        return lib.gst_mixture_pdf(x.data_ptr(), 8, ny, 1, nd, ny, *args,
                                   scale, 1, log, out.data_ptr(),
                                   _build.stream(cuda))

    assert call(3, 5, None, 0) == 0 and call(3, 5, None, 1) == 0
    assert call(3, 5, out.data_ptr(), 1) != 0
    assert call(0, 5, None, 0) != 0
    assert call(3, 64, None, 0) != 0         # 3 (64 + 64^2 + 2) floats
    big = GaussianSum.create(np.zeros((3, 64)), np.stack([np.eye(64)] * 3),
                             np.ones(3), device=cuda)
    with pytest.raises(RuntimeError):
        big.pdf(torch.zeros((8, 64), device=cuda))
    with pytest.raises(TypeError):
        meas.pdf(resid.double())
    with pytest.raises(ValueError):
        meas.to("cpu").pdf(resid)


@pytest.mark.gpu
@pytest.mark.parametrize("wide", [False, True])
def test_mixture_logpdf_on_card(cuda, wide):
    """The log mode against the plain ``logpdf`` on the CPU within
    ``LOG_ATOL`` and ``LOG_RTOL`` (the terms bit-equal; the card's expf
    and logf against the CPU's exp and log in the log-sum-exp), out to
    points where ``pdf`` underflows to 0 and the log stays finite."""
    gs = _wide(cuda) if wide else _meas(cuda)
    n = 100003
    if wide:
        x = 30.0 * torch.randn((5, n), device=cuda).T
    else:
        x = 40.0 * _residual(n, cuda, 7)
    got = gs.logpdf(x)
    want = mpdf.mixture_pdf_plain(
        x.cpu(), gs.means.cpu(), gs.inv_cov.cpu(), gs.log_const.cpu(),
        gs.weights.cpu(), log=True)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.cpu(), want, rtol=mpdf.LOG_RTOL,
                               atol=mpdf.LOG_ATOL)
    underflow = gs.pdf(x) == 0
    assert underflow.any() and torch.isfinite(got[underflow]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["pf", "gsukf"])
def test_one_mixture_pdf_launch_per_graphed_update_on_card(cuda, kind):
    """Each ``update`` of a filter shell launches the kernel once: its
    graph's warm-up, then once at each replay (``mixture_pdf.launches``),
    and its ``shell.update`` span carries that launch."""
    x0, state_pdf, meas = (GaussianSum.create(*a, device=cuda)
                           for a in rig.bench_rig())
    f, g = bio.homeostatic_des, bio.static_outputs
    if kind == "pf":
        shell = pf.ParticleFilter(f, g, 2**16, x0, state_pdf, meas, seed=4)
    else:
        shell = gsf.GaussianSumUnscentedKalmanFilter(
            f, g, 2**14, x0, state_pdf, meas, seed=4, device=cuda)
    u = np.array([0.06, 0.2])
    z = bio.static_outputs(torch.from_numpy(rig.X_SS)).numpy()
    trace._arm(True)
    try:
        for k in range(4):
            before = mpdf.mixture_pdf.launches
            shell.update(u, z)
            torch.cuda.synchronize()
            assert mpdf.mixture_pdf.launches == before + 1
        rec = trace.collect(cuda)
    finally:
        trace._arm()
    assert shell.graphs["update"].replays >= 2
    attrs = [rec.attr[i] for i, k in enumerate(rec.name.tolist())
             if rec.names[k] == "shell.update"]
    assert attrs == [(("mixture_pdf", 1),)] * 4
    assert torch.isfinite(shell.weights).all()
