"""The port's flat particle filter against the JAX reference.

The reference runs eagerly on the CPU (jitted, XLA fuses the model's
float32 ops and changes bits) on the closed loop's configuration: the
bioreactor's ``homeostatic_DEs`` / ``static_outputs`` and
``sim/harness.get_noise``'s mixtures, ``x0`` around the steady state.
Noise and ``r`` are the reference's own, injected through
``predict_from_noise`` and ``step_from_noise``. Tolerances:

* predicted particles: bit-equal (the same float32 ops in the same order);
* weights after ``update`` / ``update_stabilized``: ``rtol=1e-5``
  (``exp``, and the reference's einsum against the port's unrolled
  density, round differently);
* one step: rows whose ancestor moved with an ``ends`` entry on a cumsum
  tie may differ (at most ``STEP_TIE_ROWS`` of 4096); given the
  reference's ``ends`` the step is bit-equal;
* ``point_estimate``: ``rtol=1e-6``; ``point_covariance``: ``rtol=1e-4``
  (float32 sums in another order, then an SVD).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_se_tpu.distributions import GaussianSum as JGS
from gpu_se_tpu.filters import particle as jpf
from gpu_se_tpu.models import bioreactor as jbio
from gpu_se_tpu.ops.resample_coarse import ends_from_weights as j_ends
from gpu_se_tpu.sim import harness
from gpu_se_tpu_torch import convert
from gpu_se_tpu_torch.distributions import GaussianSum as TGS
from gpu_se_tpu_torch.distributions import MultivariateGaussianSum
from gpu_se_tpu_torch.filters import particle as tpf
from gpu_se_tpu_torch.filters import resampling as trs
from gpu_se_tpu_torch.models import bioreactor as tbio
from gpu_se_tpu_torch.ops import resample_pallas4 as trp4
from gpu_se_tpu_torch.ops import resample_pallas_block as trb

X_SS = np.array([280 / 180, 640 / 24.6, 1000 / 116, 0.0, 0.0])
FIELDS = ("means", "covariances", "weights", "chol", "inv_cov", "log_const")
STEP_TIE_ROWS = 8
F_J, G_J = jbio.Bioreactor.homeostatic_DEs, jbio.Bioreactor.static_outputs
F_T, G_T = tbio.homeostatic_des, tbio.static_outputs
U = np.array([0.06, 0.2], np.float32)
DT = np.float32(0.1)


def _to_torch(jgs):
    return convert.gaussian_sum_from_numpy(
        *(np.asarray(getattr(jgs, f)) for f in FIELDS), device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


def _rig():
    """The harness's mixtures, and x0 around the steady state."""
    state_pdf, meas_pdf = harness.get_noise()
    x0 = JGS.create(np.asarray(state_pdf.dist.means) + X_SS,
                    np.asarray(state_pdf.dist.covariances),
                    np.asarray(state_pdf.dist.weights))
    return x0, state_pdf.dist, meas_pdf.dist


@pytest.fixture(scope="module", params=[4096, 8192])
def ref(request):
    """One eager reference step at n particles, with its noise and ``r``
    split from the state's key as ``predict`` and ``resample`` do."""
    n = request.param
    x0, state_pdf, meas_pdf = _rig()
    state = jpf.init(jax.random.PRNGKey(3), n, x0)
    z = (np.asarray(jbio.static_outputs(X_SS, U, xp=np))
         + np.array([5.0, -20.0])).astype(np.float32)
    u, z_j, dt = jnp.asarray(U), jnp.asarray(z), jnp.asarray(DT)
    k1, sub1 = jax.random.split(state.key)
    _, sub2 = jax.random.split(k1)
    predicted = jpf.predict(state, u, dt, F_J, state_pdf)
    updated = jpf.update(predicted, u, z_j, G_J, meas_pdf)
    return {
        "n": n, "z": z, "meas": _to_torch(meas_pdf),
        "x_in": np.array(state.particles), "w_in": np.array(state.weights),
        "noise": np.array(state_pdf.draw(sub1, (n,))),
        "r": np.float32(jax.random.uniform(sub2, ())),
        "x_pred": np.array(predicted.particles),
        "w_upd": np.array(updated.weights),
        "w_stab": np.array(jpf.update_stabilized(predicted, u, z_j, G_J,
                                                  meas_pdf).weights),
        "x_out": np.array(jpf.resample(updated).particles),
        "estimate": np.array(jpf.point_estimate(updated)),
        "covariance": float(jpf.point_covariance(updated)),
    }


def _state(particles, weights):
    return tpf.PFState(_t(particles), _t(weights), torch.Generator())


def test_predict_from_noise_bit_equal(ref):
    got = tpf.predict_from_noise(_t(ref["x_in"]), _t(U), _t(DT), F_T,
                                 _t(ref["noise"]))
    np.testing.assert_array_equal(got.numpy(), ref["x_pred"])


@pytest.mark.parametrize("stabilized", [False, True])
def test_update_weights_vs_reference(ref, stabilized):
    upd = tpf.update_stabilized if stabilized else tpf.update
    got = upd(_state(ref["x_pred"], ref["w_in"]), _t(U), _t(ref["z"]), G_T,
              ref["meas"]).weights.numpy()
    want = ref["w_stab" if stabilized else "w_upd"]
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def _step(ref, **kw):
    return tpf.step_from_noise(_t(ref["x_in"]), _t(ref["w_in"]), _t(U),
                               _t(ref["z"]), _t(DT), F_T, G_T, ref["meas"],
                               _t(ref["noise"]), _t(ref["r"]), **kw)


def _inject_ends(monkeypatch, ref):
    ends = _t(j_ends(jnp.asarray(ref["w_upd"]), jnp.asarray(ref["r"])))
    for mod in (trs, trb, trp4):
        monkeypatch.setattr(mod, "ends_from_weights", lambda *_: ends)


def test_step_from_noise_vs_reference_step(ref, monkeypatch):
    n = ref["n"]
    got, w = _step(ref)
    assert torch.equal(w, torch.full((n,), 1.0 / n))
    differ = np.any(got.numpy() != ref["x_out"], axis=1)
    assert np.count_nonzero(differ) <= STEP_TIE_ROWS * n // 4096
    _inject_ends(monkeypatch, ref)
    got, _ = _step(ref)
    np.testing.assert_array_equal(got.numpy(), ref["x_out"])


@pytest.mark.parametrize("route", ["ends", "v4", "v3", "pallas", "xla"])
def test_step_through_each_route(ref, monkeypatch, route):
    """Given the reference's ``ends``, the exact routes are bit-equal to
    the reference step; the merge routes compare floats against the
    positions and stay within the tie bound."""
    _inject_ends(monkeypatch, ref)
    with trs.impl(route):
        got, _ = _step(ref)
    differ = np.count_nonzero(np.any(got.numpy() != ref["x_out"], axis=1))
    if route in ("v3", "pallas"):
        assert differ <= STEP_TIE_ROWS * ref["n"] // 4096
    else:
        assert differ == 0


def test_moments_vs_reference(ref):
    state = _state(ref["x_pred"], ref["w_upd"])
    np.testing.assert_allclose(tpf.point_estimate(state).numpy(),
                               ref["estimate"], rtol=1e-6, atol=0)
    got = float(tpf.point_covariance(state))
    assert got == pytest.approx(ref["covariance"], rel=1e-4)


def test_resample_draws_r_from_the_state_generator(ref):
    x, w = _t(ref["x_pred"]), _t(ref["w_upd"])
    gen = torch.Generator().manual_seed(9)
    r = torch.rand((), generator=torch.Generator().manual_seed(9))
    out = tpf.resample(tpf.PFState(x, w, gen))
    want, _ = trs.systematic_resample_from_r(x, w, r)
    assert torch.equal(out.particles, want) and out.generator is gen
    assert torch.equal(out.weights, torch.full_like(w, 1.0 / w.shape[0]))


# ----------------------------------------------------------------------
# the ParticleFilter shell
# ----------------------------------------------------------------------
def _filter(n=4096, seed=0, **kw):
    x0, state_pdf, meas_pdf = _rig()
    shell = MultivariateGaussianSum(np.asarray(meas_pdf.means),
                                    np.asarray(meas_pdf.covariances),
                                    np.asarray(meas_pdf.weights),
                                    device="cpu")
    return tpf.ParticleFilter(F_T, G_T, n, _to_torch(x0),
                              _to_torch(state_pdf), shell, seed=seed, **kw)


def test_particle_filter_shell_runs_and_reproduces():
    z = tbio.static_outputs(torch.from_numpy(X_SS)).to(torch.float32)
    runs = []
    for _ in range(2):
        pf = _filter(seed=4)
        assert pf.particles.shape == (4096, 5)
        assert torch.equal(pf.weights, torch.full((4096,), 1.0 / 4096))
        pf.predict(U, DT)
        pf.update(U, z)
        assert not torch.equal(pf.weights, torch.full((4096,), 1.0 / 4096))
        pf.resample()
        pf.step(U, z, DT)
        est, cov = pf.moments()
        assert torch.isfinite(est).all() and est.shape == (5,)
        assert float(cov) > 0
        runs.append(pf.particles)
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], _filter(seed=5).particles)


def test_state_setter_clears_the_moments_cache():
    pf = _filter()
    first = pf.moments()
    assert pf.moments() is first                     # cached
    shifted = pf.state.particles + 1.0
    pf.state = dataclasses.replace(pf.state, particles=shifted)
    est, _ = pf.moments()
    torch.testing.assert_close(est, first[0] + 1.0, rtol=1e-6, atol=1e-6)
    assert torch.equal(pf.point_estimate(), est)


def test_stabilized_update_normalizes():
    pf = _filter(stabilized=True)
    z = tbio.static_outputs(torch.from_numpy(X_SS)).to(torch.float32)
    pf.update(U, z + torch.tensor([5.0, -20.0]))
    assert float(pf.weights.sum()) == pytest.approx(1.0, rel=1e-5)


def test_init_draws_from_x0():
    x0, _, _ = _rig()
    gen = torch.Generator().manual_seed(1)
    state = tpf.init(gen, 2**14, _to_torch(x0))
    assert state.particles.shape == (2**14, 5) and state.generator is gen
    mean = state.particles.double().mean(dim=0).numpy()
    sd = np.sqrt(np.diag(np.asarray(x0.covariance(), np.float64)))
    assert np.all(np.abs(mean - np.asarray(x0.mean())) < 4 * sd / 2**7)


def test_pf_state_from_numpy_starts_the_filter(ref):
    gen = torch.Generator().manual_seed(0)
    state = convert.pf_state_from_numpy(ref["x_in"], ref["w_in"], gen)
    assert state.generator is gen and state.particles.dtype == torch.float32
    np.testing.assert_array_equal(state.particles.numpy(), ref["x_in"])
    np.testing.assert_array_equal(state.weights.numpy(), ref["w_in"])
    stepped = tpf.step(state, _t(U), _t(ref["z"]), _t(DT), F_T, G_T,
                       TGS.create(np.zeros((1, 5)), np.eye(5)[None] * 1e-4,
                                  [1.0], device="cpu"), ref["meas"])
    assert stepped.particles.shape == state.particles.shape
    assert torch.isfinite(stepped.particles).all()


def test_as_dist_accepts_a_mixture_or_a_shell():
    _, _, meas = _rig()
    t = _to_torch(meas)
    shell = MultivariateGaussianSum(np.asarray(meas.means),
                                    np.asarray(meas.covariances),
                                    np.asarray(meas.weights), device="cpu")
    assert tpf._as_dist(t) is t
    assert tpf._as_dist(shell) is shell.dist
