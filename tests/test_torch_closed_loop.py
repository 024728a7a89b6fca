"""The port's closed loop against the JAX reference, on the CPU.

- The no-noise loop at dt_control = 2 (P=150, M=100) with the port's
  linear model and MPC (``tests/test_closed_loop_parity.py``'s loop; its
  numpy plant is bit-equal to the port's, ``test_torch_linear.py``),
  against the committed reference trajectory (``picklejar/parity/``,
  read, never recomputed), held to that file's bounds.
- The harness's pieces equal the reference's: the noise mixtures and the
  event masks exactly, ``performance`` within 1e-12.
- The noisy loops, made deterministic, against the reference's on the
  same inputs: the GSUKF at one Gaussian (so the resample does not depend
  on its draw), filter noise whose draws are all 0, the reference's
  initial filter state and, in ``Simulation``, the reference's plant
  noise arrays. ``us``, ``xs``, ``xs_f`` and the rest are held within
  1e-3 of each column's largest magnitude (the float32 filter and ADMM
  part by ~2e-4 over this horizon; after a few more control events the
  reference's own float32 ADMM at 1e-6 stops on a different check now
  and then, and the loops part). Once with every solve accepted, once
  with every second control event made to fall back, the same way in
  both packages.
- The short PF and GSUKF ``Simulation``s and the on-device loop at the
  canonical noise also hold the assertions of ``tests/test_harness.py``
  and ``tests/test_scan_loop.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_se_tpu import sim as ref_sim
from gpu_se_tpu.control import mpc as ref_mpc
from gpu_se_tpu.control import qp as ref_qp
from gpu_se_tpu.filters import gs_ukf as ref_gs_ukf
from gpu_se_tpu.sim import loop as ref_loop
from gpu_se_tpu_torch import convert, sim
from gpu_se_tpu_torch.control import mpc as cmpc
from gpu_se_tpu_torch.control import qp as cqp
from gpu_se_tpu_torch.filters import (
    GaussianSumUnscentedKalmanFilter,
    ParticleFilter,
    gs_ukf,
)
from gpu_se_tpu_torch.sim import loop
from gpu_se_tpu_torch.sim.loop import event_masks, make_scan_loop

from tests.test_closed_loop_parity import (
    reference_no_noise_trajectory,
    run_no_noise_loop,
)

CPU = "cpu"


def test_no_noise_loop_matches_reference_memo():
    _, lin_model, K, _ = sim.get_parts(dt_control=2, N_particles=8, device=CPU)
    ts, us, _, ys = run_no_noise_loop(K, lin_model, dt_control=2)
    ts_ref, us_ref, ys_ref = reference_no_noise_trajectory(2, 50)
    np.testing.assert_array_equal(ts, ts_ref)
    assert np.abs(us - us_ref).max() < 2e-4
    assert np.abs(ys[:, [0, 2]] - ys_ref[:, [0, 2]]).max() < 2.0
    ysp_nat = lin_model.yd2n(K.ysp)
    perf = sim.performance(ys[:, lin_model.outputs], ysp_nat, ts)
    perf_ref = sim.performance(ys_ref[:, lin_model.outputs], ysp_nat, ts)
    assert perf == pytest.approx(perf_ref, rel=1e-3)
    np.testing.assert_allclose(ys[-1, [0, 2]], ysp_nat, rtol=0.05)


def test_noise_mixtures_equal_reference():
    for ours, ref in zip(sim.get_noise(device=CPU), ref_sim.get_noise()):
        for f in dataclasses.fields(ours.dist):
            np.testing.assert_array_equal(getattr(ours.dist, f.name).numpy(),
                                          np.asarray(getattr(ref.dist, f.name)),
                                          err_msg=f.name)


@pytest.mark.parametrize("end_time, dt_control, dt_predict",
                         [(50, 1.0, 0.1), (5, 0.1, 0.1), (4, 1, 0.5), (2, 0.1, 0.3)])
def test_event_masks_equal_reference(end_time, dt_control, dt_predict):
    ts = np.linspace(0, end_time, int(end_time * 10))
    for got, want in zip(event_masks(ts, dt_control, dt_predict),
                         ref_loop.event_masks(ts, dt_control, dt_predict)):
        np.testing.assert_array_equal(got, want)


def test_performance_and_random_io_equal_reference():
    ts = np.linspace(0, 10, 101)
    ys = np.stack([np.ones_like(ts), 2 * np.ones_like(ts)], axis=1)
    assert sim.performance(ys, np.zeros((101, 2)), ts) == pytest.approx(250.0, rel=1e-3)
    rng = np.random.default_rng(4)
    ys, r = rng.normal(size=(101, 2)), rng.normal(size=(101, 2))
    assert sim.performance(ys, r, ts) == pytest.approx(
        ref_sim.performance(ys, r, ts), rel=1e-12, abs=0)
    for got, want in zip(sim.get_random_io(np.random.default_rng(5)),
                         ref_sim.get_random_io(np.random.default_rng(5))):
        np.testing.assert_array_equal(got, want)


def test_get_parts_canonical():
    bioreactor, lin_model, K, est = sim.get_parts(dt_control=1, N_particles=256,
                                                  pf=True, device=CPU)
    assert isinstance(est, ParticleFilter)
    assert lin_model.Nx == 2 and lin_model.Ni == 2 and lin_model.No == 2
    assert K.P == 300 and K.M == 200
    assert K.qp.device.type == CPU and est.particles.device.type == CPU
    np.testing.assert_allclose(est.point_estimate().numpy(), bioreactor.X,
                               rtol=0.3, atol=0.3)
    _, _, _, gsf = sim.get_parts(dt_control=1, N_particles=16, pf=False,
                                 device=CPU)
    assert isinstance(gsf, GaussianSumUnscentedKalmanFilter)


@pytest.mark.parametrize("pf", [True, False])
def test_short_closed_loop(pf):
    s = sim.Simulation(N_particles=256 if pf else 16, dt_control=1,
                       dt_predict=0.5, end_time=4, pf=pf, device=CPU)
    n = len(s.ts)
    assert s._state_noise.shape == (n, 5) and s._meas_noise.shape == (n, 2)
    s.simulate()
    assert s.us.shape == (n, 2)
    assert s.ys.shape == (n, 5)
    assert s.xs_f.shape[1] == 5
    assert np.isfinite(s.performance)
    assert s.mpc_frac is not None and s.mpc_frac > 0.5
    assert s.predict_count >= s.update_count
    assert np.all(s.xs[:, :4] >= -1.0)
    rel_err = np.abs(s.xs_f[-1][[0, 2]] - s.xs[-1][[0, 2]]) / (
        np.abs(s.xs[-1][[0, 2]]) + 1e-6
    )
    assert np.all(rel_err < 0.5)


def _scan(dt_control, n, end_time, dt_predict, pf=True, **kw):
    bioreactor, lin_model, K, est = sim.get_parts(
        dt_control=dt_control, N_particles=n, pf=pf, device=CPU)
    state_pdf, measurement_pdf = sim.get_noise(device=CPU)
    run, ts = make_scan_loop(K, lin_model, state_pdf.dist, measurement_pdf.dist,
                             end_time=end_time, dt_control=dt_control,
                             dt_predict=dt_predict, **kw)
    return bioreactor, est, run, ts


def _gen(seed):
    return torch.Generator(device=CPU).manual_seed(seed)


def test_scan_loop_runs_and_regulates():
    bioreactor, est, run, ts = _scan(1.0, 512, 20.0, 0.1)
    rec = run(est.state, np.asarray(bioreactor.X), _gen(7))
    us, xs, xs_f = rec.us.numpy(), rec.xs.numpy(), rec.xs_f.numpy()
    assert us.shape == (len(ts) - 1, 2)
    assert np.isfinite(us).all() and np.isfinite(xs).all() and np.isfinite(xs_f).all()
    assert np.abs(us - np.array([0.06, 0.2])).max() > 1e-4
    rel = np.abs(xs_f[-1, [0, 2]] - xs[-1, [0, 2]]) / (np.abs(xs[-1, [0, 2]]) + 1e-6)
    assert np.all(rel < 0.5)
    assert np.mean(rec.status.numpy() == 1) > 0.95


def test_scan_loop_deterministic_by_generator_seed():
    _, est, run, ts = _scan(1.0, 128, 5.0, 0.5)
    x0 = np.array([1.5, 26.0, 8.6, 0.0, 0.0])
    a = run(est.state, x0, _gen(3))
    b = run(est.state, x0, _gen(3))
    for field in a._fields:
        assert torch.equal(getattr(a, field), getattr(b, field)), field
    c = run(est.state, x0, _gen(4))
    assert not torch.equal(a.ys_meas, c.ys_meas)


def test_scan_loop_consistent_with_stepwise_harness():
    end_time, dtc = 10, 1.0
    s = sim.Simulation(N_particles=256, dt_control=dtc, dt_predict=0.1,
                       end_time=end_time, pf=True, seed=0, device=CPU)
    s.simulate()
    bioreactor, est, run, ts = _scan(dtc, 256, end_time, 0.1)
    rec = run(est.state, np.asarray(bioreactor.X), _gen(0))
    xs_scan = rec.xs.numpy()
    for idx in (0, 2):
        a, b = s.xs[-1, idx], xs_scan[-1, idx]
        assert abs(a - b) / (abs(a) + 1e-6) < 0.5, (idx, a, b)
    assert np.abs(rec.us.numpy() - np.array([0.06, 0.2])).max() > 1e-4


def test_scan_loop_with_gsukf():
    bioreactor, est, run, ts = _scan(1.0, 16, 8, 0.5, pf=False,
                                     filter_core=gs_ukf)
    rec = run(est.state, np.asarray(bioreactor.X), _gen(1))
    assert np.isfinite(rec.xs_f.numpy()).all()
    assert np.isfinite(rec.us.numpy()).all()
    assert np.mean(rec.status.numpy() == 1) > 0.9


# ----------------------------------------------------------------------
# the noisy loops made deterministic, against the reference
# ----------------------------------------------------------------------
END_DET = 3          # three control events at dt_control = 1
TOL_DET = 1e-3       # of each column's largest magnitude


def _silent(dist):
    """``dist`` with every draw at 0 (zero means and Cholesky factor);
    its pdf keeps the covariances. ``replace`` of either package's
    ``GaussianSum`` dataclass."""
    return dataclasses.replace(dist, means=dist.means * 0, chol=dist.chol * 0)


def _port_gsukf_state(ref_state):
    return convert.gsukf_state_from_numpy(
        ref_state.means, ref_state.covariances, ref_state.weights,
        torch.Generator(device=CPU).manual_seed(0))


def _assert_close(name, got, want, skip=0):
    got, want = np.asarray(got, float)[skip:], np.asarray(want, float)[skip:]
    assert got.shape == want.shape, name
    lim = TOL_DET * np.abs(want).max(axis=0) + 1e-6
    assert (np.abs(got - want) <= lim).all(), (name, np.abs(got - want).max())


def _every_second_raises(step):
    """``MPC.step`` that raises at its 2nd, 4th, ... call, without
    solving (so the MPC keeps its last prediction and warm start)."""
    calls = []

    def alternate(*args):
        calls.append(args)
        if len(calls) % 2 == 0:
            raise ValueError("QP solver did not solve the problem! Status: 0")
        return step(*args)
    return alternate


def _unsolved_when_warm(make_device_step, xp, unsolved):
    """``make_device_step`` whose step reports ``unsolved`` whenever its
    warm start is not all zero: after a solved event the next one falls
    back, which resets the warm start, so the one after it solves."""
    def make(mpc):
        consts, step = make_device_step(mpc)

        def step_fn(c, x0, um1, bias, warm_v, warm_y):
            ctrl, y_pred, sol = step(c, x0, um1, bias, warm_v, warm_y)
            status = xp.where((warm_v != 0).any(), unsolved, sol.status)
            return ctrl, y_pred, dataclasses.replace(sol, status=status)
        return consts, step_fn
    return make


@pytest.mark.parametrize("alternate", [False, True], ids=["solved", "alternate"])
def test_simulation_matches_reference_when_deterministic(alternate):
    """``Simulation`` against the reference's on the same inputs: the
    GSUKF at N = 1 with noiseless predictions, the reference's initial
    filter state and its plant noise arrays. With ``alternate`` both MPCs
    raise at every second step: the loops take the fallback input there
    and the bias after it comes from the last prediction."""
    kw = dict(N_particles=1, dt_control=1, dt_predict=0.5, end_time=END_DET,
              pf=False)
    ref = ref_sim.Simulation(**kw)
    ours = sim.Simulation(**kw, device=CPU)
    ref.f.state_pdf = _silent(ref.f.state_pdf)
    ours.f.state_pdf = _silent(ours.f.state_pdf)
    ours.f.state = _port_gsukf_state(ref.f.state)
    ours._state_noise = ref._state_noise.copy()
    ours._meas_noise = ref._meas_noise.copy()
    if alternate:
        ref.K.step = _every_second_raises(ref.K.step)
        ours.K.step = _every_second_raises(ours.K.step)
    ref.simulate()
    ours.simulate()
    # which steps solve is the float32 ADMM's at 1e-6 (the reference's
    # first step here runs to max_iter and is accepted as near-solved):
    # the packages agree on each, and the forced fallbacks count
    assert ours.mpc_frac == ref.mpc_frac <= (2 / 3 if alternate else 1.0)
    assert len(ours.biass) == len(ref.biass) == 2
    for name in ("us", "xs", "ys", "ys_meas", "biass"):
        _assert_close(name, getattr(ours, name), getattr(ref, name))
    # the first estimate is each filter's own, before the state was copied
    for name in ("xs_f", "ys_f"):
        _assert_close(name, getattr(ours, name), getattr(ref, name), skip=1)
    assert ours.performance == pytest.approx(ref.performance, rel=TOL_DET)


@pytest.mark.parametrize("alternate", [False, True], ids=["solved", "alternate"])
def test_scan_loop_matches_reference_when_deterministic(alternate, monkeypatch):
    """``make_scan_loop`` with the GSUKF core at N = 1 and noise mixtures
    whose draws are all 0, against the reference's loop, from the
    reference's initial filter state. With ``alternate`` both device
    steps report an unsolved QP whenever they were warm-started: the
    second event falls back (keeping the last prediction, resetting the
    warm start) and the third solves from a cold start with the bias of
    the first event's prediction."""
    if alternate:
        monkeypatch.setattr(ref_mpc, "make_device_step", _unsolved_when_warm(
            ref_mpc.make_device_step, jnp, ref_qp.MAX_ITER_REACHED))
        monkeypatch.setattr(cmpc, "make_device_step", _unsolved_when_warm(
            cmpc.make_device_step, torch, cqp.MAX_ITER_REACHED))
    loops = []
    for pkg, pkg_loop, core, kw in ((ref_sim, ref_loop, ref_gs_ukf, {}),
                                    (sim, loop, gs_ukf, dict(device=CPU))):
        bioreactor, lin_model, K, est = pkg.get_parts(
            dt_control=1, N_particles=1, pf=False, **kw)
        state_pdf, measurement_pdf = pkg.get_noise(**kw)
        run, ts = pkg_loop.make_scan_loop(
            K, lin_model, _silent(state_pdf.dist), _silent(measurement_pdf.dist),
            end_time=END_DET, dt_control=1.0, dt_predict=0.5, filter_core=core)
        loops.append((run, est, np.asarray(bioreactor.X)))
    (ref_run, ref_est, x0), (run, _, _) = loops
    want = ref_run(ref_est.state, x0, jax.random.PRNGKey(0))
    got = run(_port_gsukf_state(ref_est.state), x0, _gen(0))
    status = np.asarray(want.status)
    np.testing.assert_array_equal(got.status.numpy(), status)
    control = event_masks(ts, 1.0, 0.5)[1]
    expect = [cqp.SOLVED, cqp.MAX_ITER_REACHED, cqp.SOLVED] if alternate \
        else [cqp.SOLVED] * 3
    np.testing.assert_array_equal(status[control], expect)
    for name in ("us", "xs", "ys_meas", "xs_f"):
        _assert_close(name, getattr(got, name).numpy(),
                      np.asarray(getattr(want, name)))
