"""The port's Gaussian-sum UKF against the JAX reference.

The reference runs eagerly on the CPU (jitted, XLA fuses the model's
float32 ops and changes bits), on the bench rig of ``bench.py`` at N =
4096 Gaussians from the reference's initial bank, with sigma-point noise
made by numpy and a fixed ``r`` injected into both. Tolerances:

* sigma weights, sigma points, ``predict_core``, and the means and
  covariances of ``update_core`` / ``update_stabilized``: bit-equal (the
  same float32 ops in the same order; the port's square root is
  correctly rounded, as the reference's);
* weights after an update: ``rtol=1e-5`` (``exp``, and the reference's
  einsum against the port's unrolled density, round differently);
* the resample given the reference's ``ends``: bit-equal; the whole step
  with the port's own ``ends``: rows whose ancestor moved with an
  ``ends`` entry on a cumsum tie may differ (at most ``STEP_TIE_ROWS``
  of 4096), every other row bit-equal;
* ``point_estimate``: ``rtol=1e-6``; ``point_covariance``: ``rtol=1e-4``
  (float32 sums in another order, then an SVD);
* the linear toy model: ``rtol=1e-6`` (its ``exp`` rounds differently).
"""
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_se_tpu.distributions import GaussianSum as JGS
from gpu_se_tpu.distributions.gaussian_sum import (
    DeterministicGaussianSum as JDGS,
)
from gpu_se_tpu.filters import gs_ukf as jg
from gpu_se_tpu.filters.resampling import systematic_resample_indices
from gpu_se_tpu.models import bioreactor as jbio
from gpu_se_tpu.ops.resample_coarse import ends_from_weights as j_ends
from gpu_se_tpu_torch import convert
from gpu_se_tpu_torch.distributions import DeterministicGaussianSum as TDGS
from gpu_se_tpu_torch.distributions import GaussianSum as TGS
from gpu_se_tpu_torch.filters import (
    GaussianSumUnscentedKalmanFilter,
    ParallelGaussianSumUnscentedKalmanFilter,
)
from gpu_se_tpu_torch.filters import gs_ukf as tg
from gpu_se_tpu_torch.filters import resampling as trs
from gpu_se_tpu_torch.models import bioreactor as tbio
from gpu_se_tpu_torch.ops import resample_pallas2 as trp2
from gpu_se_tpu_torch.ops import resample_pallas4 as trp4
from gpu_se_tpu_torch.ops import resample_pallas_block as trb
from gpu_se_tpu_torch.ops import smallmat as tsm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "torch_parity_gsukf.npz")
FIELDS = ("means", "covariances", "weights", "chol", "inv_cov", "log_const")
STEP_TIE_ROWS = 8
N = 4096


def _load_fixture_script():
    spec = importlib.util.spec_from_file_location(
        "make_torch_parity_fixture",
        os.path.join(REPO, "scripts", "make_torch_parity_fixture.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FIX = _load_fixture_script()
F_J = functools.partial(jbio.homeostatic_des, xp=jnp)
G_J = functools.partial(jbio.static_outputs, xp=jnp)
F_T, G_T = tbio.homeostatic_des, tbio.static_outputs


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


def _to_torch(jgs):
    return convert.gaussian_sum_from_numpy(
        *(np.asarray(getattr(jgs, f)) for f in FIELDS), device="cpu")


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def ref():
    """One eager reference step on the rig at N Gaussians: its inputs,
    injected noise and ``r``, and every stage's output."""
    x0_args, sp_args, mp_args = FIX.bench_rig()
    x0, state_pdf, meas = (JGS.create(*a) for a in (x0_args, sp_args,
                                                     mp_args))
    state = jg.init(jax.random.PRNGKey(0), N, x0, state_pdf)
    u = np.array([0.06, 0.2], np.float32)
    z = np.asarray(jbio.static_outputs(FIX.X_SS, u, xp=np), np.float32)
    dt, r = np.float32(0.1), np.float32(FIX.R_GSUKF)
    sd = np.sqrt(np.diag(sp_args[1][0])).astype(np.float32)
    noise_t = FIX.gsukf_noise(sd, N)
    pm, pc = jg.predict_core(state.means, state.covariances,
                             jnp.asarray(u), dt, jnp.asarray(noise_t), F_J,
                             noise_is_lanes=True)
    um, uc, uw = jg.update_core(pm, pc, state.weights, jnp.asarray(u),
                                jnp.asarray(z), G_J, meas)
    upd = jg.GSUKFState(um, uc, uw, state.key)
    stab = jg.update_stabilized(jg.GSUKFState(pm, pc, state.weights,
                                              state.key),
                                jnp.asarray(u), jnp.asarray(z), G_J, meas)
    idx = systematic_resample_indices(uw, r)
    return {
        "meas": _to_torch(meas), "u": u, "z": z, "dt": dt, "r": r,
        "noise_t": noise_t,
        "means_in": np.array(state.means),
        "covs_in": np.array(state.covariances),
        "w_in": np.array(state.weights),
        "pred": (np.array(pm), np.array(pc)),
        "upd": (np.array(um), np.array(uc), np.array(uw)),
        "stab": (np.array(stab.means), np.array(stab.covariances),
                 np.array(stab.weights)),
        "ends": np.array(j_ends(uw, r)),
        "out": (np.array(um[idx]), np.array(uc[idx])),
        "estimate": np.array(jg.point_estimate(upd)),
        "covariance": float(jg.point_covariance(upd)),
    }


# ----------------------------------------------------------------------
# the pieces
# ----------------------------------------------------------------------
@pytest.mark.parametrize("nx", [1, 2, 5, 8])
def test_sigma_weights_bit_equal(nx):
    got = tg.sigma_weights(nx)
    _eq(got, jg.sigma_weights(nx))
    assert float(got.double().sum()) == pytest.approx(1.0, rel=1e-6)


def test_sigma_points_bit_equal(ref):
    means, covs = ref["pred"][0][:64], ref["pred"][1][:64]
    jstate = jg.GSUKFState(jnp.asarray(means), jnp.asarray(covs),
                           jnp.ones(64) / 64, jax.random.PRNGKey(0))
    tstate = tg.GSUKFState(_t(means), _t(covs), torch.ones(64) / 64, None)
    want = jg.get_sigma_points(jstate)
    _eq(tg.get_sigma_points(tstate), want)
    lanes = tg._sigma_points_lanes(_t(means.T),
                                   _t(covs.transpose(1, 2, 0)))
    _eq(lanes.permute(2, 0, 1), want)


def test_cholesky_jitter_fallback():
    """A singular covariance gets the jittered factor: finite, and equal
    to the reference's; a healthy one keeps its own factor."""
    covs = np.zeros((3, 3, 3), np.float32)
    covs[2] = np.eye(3) * 2.0
    got = tg._batched_cholesky_jittered(_t(covs))
    assert torch.isfinite(got).all()
    _eq(got, jg._batched_cholesky_jittered(jnp.asarray(covs)))
    _eq(got[2], tsm.cholesky_small(_t(covs[2:]))[0])


@pytest.mark.parametrize("lanes", [True, False])
def test_predict_core_bit_equal(ref, lanes):
    noise = ref["noise_t"] if lanes else ref["noise_t"].transpose(2, 0, 1)
    means, covs = tg.predict_core(_t(ref["means_in"]), _t(ref["covs_in"]),
                                  _t(ref["u"]), _t(ref["dt"]), _t(noise),
                                  F_T, noise_is_lanes=lanes)
    _eq(means, ref["pred"][0])
    _eq(covs, ref["pred"][1])
    assert torch.equal(covs, covs.mT)


@pytest.mark.parametrize("stabilized", [False, True])
def test_update_vs_reference(ref, stabilized):
    state = convert.gsukf_state_from_numpy(*ref["pred"], ref["w_in"],
                                           torch.Generator())
    assert state.means.dtype == torch.float32 and state.n_dim == 5
    upd = tg.update_stabilized if stabilized else tg.update
    out = upd(state, _t(ref["u"]), _t(ref["z"]), G_T, ref["meas"])
    want = ref["stab" if stabilized else "upd"]
    _eq(out.means, want[0])
    _eq(out.covariances, want[1])
    assert torch.equal(out.covariances, out.covariances.mT)
    assert out.weights.dtype == torch.float32
    np.testing.assert_allclose(out.weights.numpy(), want[2], rtol=1e-5,
                               atol=0)


def _inject_ends(monkeypatch, ends):
    ends = _t(ends)
    for mod in (trs, trb, trp4):
        monkeypatch.setattr(mod, "ends_from_weights", lambda *_: ends)


@pytest.mark.parametrize("route", ["auto", "bank", "ends", "xla"])
def test_resample_given_reference_ends(ref, monkeypatch, route):
    """The bank (compact + expand), the ``ends`` merge and the
    plain route, each given the reference's ``ends``: bit-equal."""
    _inject_ends(monkeypatch, ref["ends"])
    um, uc, uw = (_t(a) for a in ref["upd"])
    with trs.impl(route):
        (means, covs), w = trs.systematic_resample_bank_from_r(
            um, uc, uw, _t(ref["r"]))
    _eq(means, ref["out"][0])
    _eq(covs, ref["out"][1])
    assert torch.equal(w, torch.full((N,), 1.0 / N))


def _step(ref):
    return tg.step_from_noise(
        _t(ref["means_in"]), _t(ref["covs_in"]), _t(ref["w_in"]),
        _t(ref["u"]), _t(ref["z"]), _t(ref["dt"]), F_T, G_T, ref["meas"],
        _t(ref["noise_t"]), _t(ref["r"]), noise_is_lanes=True)


def test_step_from_noise_vs_reference(ref, monkeypatch):
    (means, covs), w = _step(ref)
    differ = (np.any(means.numpy() != ref["out"][0], axis=1)
              | np.any(covs.numpy() != ref["out"][1], axis=(1, 2)))
    assert np.count_nonzero(differ) <= STEP_TIE_ROWS
    assert torch.equal(w, torch.full((N,), 1.0 / N))
    assert torch.equal(covs, covs.mT)
    _inject_ends(monkeypatch, ref["ends"])
    (means, covs), _ = _step(ref)
    _eq(means, ref["out"][0])
    _eq(covs, ref["out"][1])


def test_moments_vs_reference(ref):
    um, uc, uw = (_t(a) for a in ref["upd"])
    state = tg.GSUKFState(um, uc, uw, None)
    np.testing.assert_allclose(tg.point_estimate(state).numpy(),
                               ref["estimate"], rtol=1e-6, atol=0)
    got = float(tg.point_covariance(state))
    assert got == pytest.approx(ref["covariance"], rel=1e-4)


def test_resample_draws_r_from_the_state_generator(ref):
    um, uc, uw = (_t(a) for a in ref["upd"])
    gen = torch.Generator().manual_seed(9)
    r = torch.rand((), generator=torch.Generator().manual_seed(9))
    out = tg.resample(tg.GSUKFState(um, uc, uw, gen))
    (want_m, want_c), _ = trs.systematic_resample_bank_from_r(um, uc, uw, r)
    assert torch.equal(out.means, want_m) and torch.equal(out.covariances,
                                                          want_c)
    assert out.generator is gen


# ----------------------------------------------------------------------
# a linear toy model (tests/test_gs_ukf.py's)
# ----------------------------------------------------------------------
def _toy():
    def f_j(x, u, dt):
        return jnp.stack([u[0] * dt, (jnp.exp(-u[1]) - 1.0) * x[1] * dt])

    def g_j(x, u):
        return jnp.stack([x[0] * x[1]])

    def f_t(x, u, dt):
        return torch.stack([torch.broadcast_to(u[0] * dt, x[0].shape),
                            (torch.exp(-u[1]) - 1.0) * x[1] * dt])

    def g_t(x, u):
        return torch.stack([x[0] * x[1]])

    mixtures = (
        (np.array([[1.0, 10.0], [1.5, 11.0]]),
         np.stack([np.eye(2) * 0.1, np.eye(2) * 0.2]), np.array([0.3, 0.7])),
        (np.zeros((2, 2)), np.stack([np.eye(2) * 1e-4, np.eye(2) * 1e-3]),
         np.array([0.6, 0.4])),
        (np.array([[0.0]]), np.array([[[0.5]]]), np.array([1.0])),
    )
    return f_j, g_j, f_t, g_t, mixtures


def test_toy_model_step_vs_reference():
    f_j, g_j, f_t, g_t, mixtures = _toy()
    x0, sp, meas = (JGS.create(*m) for m in mixtures)
    state = jg.init(jax.random.PRNGKey(4), 64, x0, sp)
    u, z, dt = np.array([0.1, 0.2], np.float32), np.array([10.5],
                                                           np.float32), 0.1
    noise = (1e-2 * np.random.default_rng(4).standard_normal((64, 5, 2))
             ).astype(np.float32)
    pm, pc = jg.predict_core(state.means, state.covariances, jnp.asarray(u),
                             jnp.float32(dt), jnp.asarray(noise), f_j)
    um, uc, uw = jg.update_core(pm, pc, state.weights, jnp.asarray(u),
                                jnp.asarray(z), g_j, meas)
    tm, tc = tg.predict_core(_t(state.means), _t(state.covariances), _t(u),
                             torch.tensor(np.float32(dt)), _t(noise), f_t)
    np.testing.assert_allclose(tm.numpy(), np.asarray(pm), rtol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(pc), rtol=1e-6)
    vm, vc, vw = tg.update_core(_t(pm), _t(pc), _t(state.weights), _t(u),
                                _t(z), g_t, _to_torch(meas))
    np.testing.assert_allclose(vm.numpy(), np.asarray(um), rtol=1e-6)
    np.testing.assert_allclose(vc.numpy(), np.asarray(uc), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(vw.numpy(), np.asarray(uw), rtol=1e-5)
    assert torch.equal(vc, vc.mT)


def test_linear_update_reference_semantics():
    """P_yy from the sigma spread alone: for a linear g the gain is 1,
    the mean jumps to z and the covariance contracts by 2 nx w_sigma."""
    x0 = TGS.create(np.array([[2.0]]), np.array([[[1e-12]]]), np.array([1.0]),
                    device="cpu")
    state_pdf = TGS.create(np.array([[0.0]]), np.array([[[1.0]]]),
                           np.array([1.0]), device="cpu")
    meas = TGS.create(np.array([[0.0]]), np.array([[[0.1]]]), np.array([1.0]),
                      device="cpu")
    gsf = GaussianSumUnscentedKalmanFilter(
        lambda x, u, dt: 0.0 * x, lambda x, u: x[:1], 1, x0, state_pdf,
        meas, device="cpu")
    gsf.update(np.array([0.0]), np.array([3.0]))
    assert float(gsf.means[0, 0]) == pytest.approx(3.0, rel=1e-5)
    spread = 2.0 / (2.0 + 8.0 / 5.0)
    assert float(gsf.covariances[0, 0, 0]) == pytest.approx(1 - spread,
                                                            rel=1e-3)


def test_update_survives_collapsed_component():
    """A bank entry with a zero covariance: singular P_yy, finite update,
    as the reference's."""
    f_j, g_j, f_t, g_t, mixtures = _toy()
    x0, sp, meas = (JGS.create(*m) for m in mixtures)
    state = jg.init(jax.random.PRNGKey(3), 4, x0, sp)
    covs = np.array(state.covariances)
    covs[0] = 0.0
    u, z = np.array([0.1, 0.2], np.float32), np.array([10.5], np.float32)
    want = jg.update_core(state.means, jnp.asarray(covs), state.weights,
                          jnp.asarray(u), jnp.asarray(z), g_j, meas)
    got = tg.update_core(_t(state.means), _t(covs), _t(state.weights),
                         _t(u), _t(z), g_t, _to_torch(meas))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)


# ----------------------------------------------------------------------
# the shell and DeterministicGaussianSum
# ----------------------------------------------------------------------
def _shell(seed=0, **kw):
    x0_args, sp_args, mp_args = FIX.bench_rig()
    return GaussianSumUnscentedKalmanFilter(
        F_T, G_T, 4096, TGS.create(*x0_args, device="cpu"),
        TGS.create(*sp_args, device="cpu"),
        TGS.create(*mp_args, device="cpu"), seed=seed, device="cpu", **kw)


def test_shell_api_and_moments_cache():
    gsf = _shell(seed=1)
    assert ParallelGaussianSumUnscentedKalmanFilter is \
        GaussianSumUnscentedKalmanFilter
    u, z = np.array([0.06, 0.2]), np.asarray(
        jbio.static_outputs(FIX.X_SS, np.zeros(2), xp=np))
    gsf.predict(u, 0.1)
    gsf.update(u, z)
    first = gsf.moments()
    assert gsf.moments() is first
    gsf.resample()
    assert gsf.moments() is not first
    est, cov = gsf.moments()
    assert est.shape == (5,) and torch.isfinite(est).all()
    assert float(cov) > 0
    assert gsf.means.shape == (4096, 5)
    assert gsf.covariances.shape == (4096, 5, 5)
    assert torch.equal(gsf.covariances, gsf.covariances.mT)
    assert torch.equal(gsf.weights, torch.full((4096,), 1.0 / 4096))
    gsf.state = tg.GSUKFState(gsf.means, gsf.covariances, gsf.weights,
                              gsf.state.generator)
    assert gsf._moments_cache is None


@pytest.mark.parametrize("stabilized", [False, True])
def test_shell_step_equals_composition(stabilized):
    u, z = np.array([0.06, 0.2]), np.asarray(
        jbio.static_outputs(FIX.X_SS, np.zeros(2), xp=np)) + 5.0
    a, b = _shell(5, stabilized=stabilized), _shell(5, stabilized=stabilized)
    a.predict(u, 0.1)
    a.update(u, z)
    a.resample()
    b.step(u, z, 0.1)
    assert torch.equal(a.means, b.means)
    assert torch.equal(a.covariances, b.covariances)


def test_shell_defaults_to_the_card():
    x0_args, sp_args, mp_args = FIX.bench_rig()
    args = (F_T, G_T, 16, TGS.create(*x0_args, device="cpu"),
            TGS.create(*sp_args, device="cpu"),
            TGS.create(*mp_args, device="cpu"))
    if torch.cuda.is_available():
        assert GaussianSumUnscentedKalmanFilter(*args).means.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            GaussianSumUnscentedKalmanFilter(*args)


@pytest.fixture
def fresh_streams():
    JDGS.reset()
    TDGS.reset()
    yield
    JDGS.reset()
    TDGS.reset()


def test_deterministic_gaussian_sum_replays(fresh_streams):
    """Instances share one stream; ``draw(shape)`` returns its first
    ``prod(shape) * Nx`` values, squeezed; ``reset`` starts it again."""
    _, sp_args, _ = FIX.bench_rig()
    a = TDGS(*sp_args, device="cpu")
    b = TDGS(*sp_args, device="cpu")
    first = a.draw((3,))
    assert first.shape == (3, 5)
    longer = b.draw((7,))
    assert torch.equal(longer[:3], first)
    assert torch.equal(a.draw((7,)), longer)
    assert a.draw(1).shape == (5,)
    # the stream depends on how it was extended: replay the same calls
    TDGS.reset()
    c = TDGS(*sp_args, device="cpu")
    assert torch.equal(c.draw((3,)), first)
    assert torch.equal(c.draw((7,)), longer)


def test_deterministic_gaussian_sum_injected_values(fresh_streams):
    """Copying the reference's stream into the port gives the
    reference's draws, shape for shape."""
    _, sp_args, _ = FIX.bench_rig()
    jd = JDGS(*sp_args)
    want = [np.asarray(jd.draw(s)) for s in ((4,), (2, 3), 1)]
    TDGS._values = JDGS._values.copy()
    td = TDGS(*sp_args, device="cpu")
    for s, w in zip(((4,), (2, 3), 1), want):
        np.testing.assert_array_equal(td.draw(s).numpy(), w)


def test_deterministic_gaussian_sum_moments(fresh_streams):
    """The port's own stream: 2^14 draws of the state noise mixture have
    its mean and covariance (4 standard errors; a factor 3 on the
    covariance's for the mixture's tails)."""
    means, covs, w = FIX.bench_rig()[1]
    draws = TDGS(means, covs, w, device="cpu").draw((2**14,)).double().numpy()
    w = w / w.sum()
    cov = np.einsum("d,dij->ij", w, covs)
    sd = np.sqrt(np.diag(cov))
    size = draws.shape[0]
    assert np.all(np.abs(draws.mean(axis=0)) < 4 * sd / np.sqrt(size))
    se = np.sqrt(3 * (np.outer(sd**2, sd**2) + cov**2) / size)
    assert np.all(np.abs(np.cov(draws.T) - cov) < 4 * se)


# ----------------------------------------------------------------------
# the fixture the card is held to
# ----------------------------------------------------------------------
def test_gsukf_fixture_file_is_current(ref):
    """The committed file equals a fresh reference run, and its step is
    the one this file checks the port against."""
    fresh = FIX.build_gsukf()
    committed = np.load(FIXTURE)
    assert sorted(committed.files) == sorted(fresh)
    for name, want in fresh.items():
        got = committed[name]
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert os.path.getsize(FIXTURE) < 2**20
    np.testing.assert_array_equal(committed["upd_means"], ref["upd"][0])
    np.testing.assert_array_equal(committed["out_covs"], ref["out"][1])


def test_gsukf_fixture_step_through_the_cpu_port():
    """What the card does with the file, on the CPU: the port's step
    from the file's inputs and recomputed noise, and its v2 entry."""
    d = np.load(FIXTURE)
    meas = convert.gaussian_sum_from_numpy(
        *(d[f"meas_{f}"] for f in FIELDS), device="cpu")
    noise = FIX.gsukf_noise(d["noise_sd"], N, int(d["noise_seed"]))
    means, covs = tg.predict_core(_t(d["means_in"]), _t(d["covs_in"]),
                                  _t(d["u"]), _t(d["dt"]), _t(noise), F_T,
                                  noise_is_lanes=True)
    means, covs, w = tg.update_core(means, covs, _t(d["w_in"]), _t(d["u"]),
                                    _t(d["z"]), G_T, meas)
    _eq(means, d["upd_means"])
    np.testing.assert_allclose(w.numpy(), d["upd_w"], rtol=1e-5, atol=0)
    parts, w2, r2 = FIX.v2_case(N, int(d["v2_seed"]))
    got = trp2.fused_systematic_resample_v2(
        _t(parts), _t(w2), torch.tensor(r2), window=int(d["v2_window"]),
        block=int(d["v2_block"]))
    _eq(got, d["v2_out"])
