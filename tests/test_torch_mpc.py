"""The port's condensed MPC against the JAX reference, on the CPU.

Both MPCs are built from one linear model, so every host float64 matrix
must be bit-equal (the same numpy code). ``MPC.step``'s control and
``y_predicted`` must agree with the reference MPC's within 1e-5 of their
largest magnitude (both solve the same float32 QP to 1e-6), and with the
reference QP layout solved by the float64 ``numpy_admm_qp`` within
``tests/test_mpc.py``'s tolerances. ``make_device_step`` must agree with
``MPC.step`` within 1e-4 (float32 end to end against float64 host
preprocessing).
"""
import numpy as np
import pytest
import torch

from gpu_se_tpu import sim as ref_sim
from gpu_se_tpu.control import MPC as RefMPC
from gpu_se_tpu.control import QPSettings as RefSettings
from gpu_se_tpu.control import build_prediction_matrices as ref_bpm
from gpu_se_tpu_torch import models
from gpu_se_tpu_torch.control import MPC, QPSettings, build_prediction_matrices
from gpu_se_tpu_torch.control.mpc import make_device_step

from tests.test_mpc import ReferenceLayoutMPC, random_stable_lin_model

REL = 1e-5


def _port_lin(lin):
    """The port's ``LinearModel`` holding the same numbers as ``lin``."""
    out = models.LinearModel(lin.A, lin.B, lin.C, lin.D, lin.T, lin.x_bar,
                             lin.u_bar, lin.f_bar, lin.y_bar)
    out.states, out.inputs, out.outputs = lin.states, lin.inputs, lin.outputs
    return out


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(
        np.asarray(want)).max()


@pytest.fixture(scope="module")
def canonical():
    """The reference's canonical rig at dt_control = 1 (P=300, M=200) and
    the port's MPC on its linear model."""
    plant, lin, K_ref, _ = ref_sim.get_parts(dt_control=1, N_particles=8)
    K = MPC(K_ref.P, K_ref.M, K_ref.Q, K_ref.R, _port_lin(lin), K_ref.ysp,
            u_bounds=[np.array([0, np.inf]) - lin.u_bar[0],
                      np.array([0, np.inf]) - lin.u_bar[1]], device="cpu")
    return plant, lin, K_ref, K


def _assert_host_equal(K, K_ref):
    for key, want in K_ref._h.items():
        got = K._h[key]
        if want is None:
            assert got is None, key
        elif isinstance(want, tuple):
            assert all(np.array_equal(g, w) for g, w in zip(got, want)), key
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)
    for name in ("ctrl_map", "theta0_w"):
        np.testing.assert_array_equal(K._consts[name].numpy(),
                                      np.asarray(K_ref._consts[name]))
    for name in ("A_s", "rho", "d_scale", "e_scale", "c_scale", "aat", "s_fac"):
        np.testing.assert_array_equal(getattr(K.qp.consts, name).numpy(),
                                      np.asarray(getattr(K_ref.qp.consts, name)),
                                      err_msg=name)
    assert K.qp.settings.identity_hessian and K_ref.qp.settings.identity_hessian


@pytest.mark.parametrize("with_d", [False, True])
def test_prediction_matrices_bit_equal(with_d):
    lin = random_stable_lin_model(0, with_d=with_d)
    for got, want in zip(build_prediction_matrices(_port_lin(lin), 8, 4),
                         ref_bpm(lin, 8, 4)):
        np.testing.assert_array_equal(got, want)


def _pair(lin, P_h, M_h, Q, R, ysp, **bounds):
    settings = dict(eps_abs=1e-6, eps_rel=1e-6, max_iter=20000)
    ref = RefMPC(P_h, M_h, Q, R, lin, ysp, qp_settings=RefSettings(**settings),
                 **bounds)
    port = MPC(P_h, M_h, Q, R, _port_lin(lin), ysp,
               qp_settings=QPSettings(**settings), device="cpu", **bounds)
    _assert_host_equal(port, ref)
    return ref, port


@pytest.mark.parametrize("with_d", [False, True])
def test_step_matches_reference(with_d):
    """``tests/test_mpc.py``'s random stable model, 4 steps with the bias
    active: the port against the reference MPC and against the reference
    QP layout (float64 numpy ADMM)."""
    P_h, M_h = 8, 4
    lin = random_stable_lin_model(0, with_d=with_d)
    Q, R = np.diag([1.0, 2.0]), np.diag([0.5, 0.5])
    ysp = np.array([1.0, -0.5])
    u_bounds = [np.array([-2.0, 2.0]), np.array([-2.0, 2.0])]
    ref, port = _pair(lin, P_h, M_h, Q, R, ysp, u_bounds=u_bounds)
    layout = ReferenceLayoutMPC(P_h, M_h, Q, R, lin, ysp, u_bounds=u_bounds)
    rng = np.random.default_rng(1)
    x, um1 = np.array([0.5, -0.3]), np.zeros(2)
    for _ in range(4):
        y0 = lin.C @ x + lin.D @ um1 + rng.normal(scale=0.01, size=2)
        u_ref, u_port, u_lay = ref.step(x, um1, y0), port.step(x, um1, y0), \
            layout.step(x, um1, y0)
        assert _rel(u_port, u_ref) <= REL
        assert _rel(port.y_predicted, ref.y_predicted) <= REL
        np.testing.assert_allclose(u_port, u_lay, atol=2e-3)
        np.testing.assert_allclose(port.y_predicted, layout.y_predicted,
                                   atol=2e-3)
        um1 = u_port
        x = lin.A @ x + lin.B @ um1 + rng.normal(scale=0.01, size=2)


def test_step_with_y_and_step_bounds():
    P_h, M_h = 6, 3
    lin = random_stable_lin_model(5, with_d=False)
    Q, R = np.eye(2), 0.1 * np.eye(2)
    ysp = np.array([0.5, 0.5])
    bounds = dict(
        y_bounds=[np.array([-3.0, 3.0]), np.array([-3.0, 3.0])],
        u_bounds=[np.array([-1.5, 1.5]), np.array([-1.5, 1.5])],
        u_step_bounds=[np.array([-0.5, 0.5]), np.array([-0.5, 0.5])],
    )
    ref, port = _pair(lin, P_h, M_h, Q, R, ysp, **bounds)
    layout = ReferenceLayoutMPC(P_h, M_h, Q, R, lin, ysp, **bounds)
    x, um1 = np.array([0.2, -0.4]), np.zeros(2)
    for _ in range(3):
        y0 = lin.C @ x
        u_ref, u_port, u_lay = ref.step(x, um1, y0), port.step(x, um1, y0), \
            layout.step(x, um1, y0)
        assert _rel(u_port, u_ref) <= REL
        assert _rel(port.y_predicted, ref.y_predicted) <= REL
        np.testing.assert_allclose(u_port, u_lay, atol=5e-3)
        um1 = u_port
        x = lin.A @ x + lin.B @ um1


def test_canonical_rig_matches_reference(canonical):
    """The canonical rig at P=300, M=200: host matrices bit-equal, and
    the first control steps of the no-noise loop within 1e-5."""
    plant, lin, K_ref, K = canonical
    _assert_host_equal(K, K_ref)
    bio = models.Bioreactor(plant.X.copy(), high_N=False)
    us = np.array([0.06, 0.2])
    for _ in range(3):
        args = (lin.xn2d(bio.X), lin.un2d(us), lin.yn2d(bio.outputs(us)))
        u_ref = K_ref.step(*args)
        u = K.step(*args)
        assert _rel(u, u_ref) <= REL
        assert _rel(K.y_predicted, K_ref.y_predicted) <= REL
        # both solves end solved or near-solved (the second step takes the
        # reference to max_iter at a dual residual near float32's floor,
        # the port to SOLVED at 75 iterations)
        for sol in (K.last_solution, K_ref.last_solution):
            assert int(sol.status) in (0, 1)
        assert np.all(u + lin.u_bar >= -1e-5)
        us = lin.ud2n(u)
        for _ in range(10):
            bio.step(0.1, us)


def test_device_step_matches_host_step(canonical):
    plant, lin, _, K = canonical
    K.reset()
    consts, step_fn = make_device_step(K)
    x0, um1 = lin.xn2d(plant.X), np.array([0.06, 0.2]) - lin.u_bar
    y0 = lin.yn2d(plant.outputs(None))
    f32 = lambda v: torch.as_tensor(np.asarray(v), dtype=torch.float32)
    ctrl, y_pred, sol = step_fn(consts, f32(x0), f32(um1), f32(np.zeros(2)),
                                K._warm_v, K._warm_y)
    u = K.step(x0, um1, y0)
    assert int(sol.status) == 1
    assert _rel(ctrl.numpy(), u) <= 1e-4
    assert _rel(y_pred.numpy(), K.y_predicted) <= 1e-4


def test_reset_repeats_the_first_step(canonical):
    """After ``reset`` the MPC has no prediction, no last solution and a
    zero warm start, and its next step equals its first bit for bit."""
    plant, lin, _, K = canonical
    args = (lin.xn2d(plant.X), np.array([0.06, 0.2]) - lin.u_bar,
            lin.yn2d(plant.outputs(None)))
    K.reset()
    first = K.step(*args)
    x_first = K.last_solution.x
    assert K.y_predicted is not None and K._warm_v.any()
    K.reset()
    assert K.y_predicted is None and K.last_solution is None
    assert not K._warm_v.any() and not K._warm_y.any()
    np.testing.assert_array_equal(K.step(*args), first)
    assert torch.equal(K.last_solution.x, x_first)


def test_solver_failure_raises():
    lin = random_stable_lin_model(2, with_d=False)
    K = MPC(5, 2, np.eye(2), np.eye(2), _port_lin(lin), np.zeros(2),
            u_bounds=[np.array([1.0, np.inf]), np.array([1.0, np.inf])],
            u_step_bounds=[np.array([-np.inf, -5.0]), np.array([-np.inf, -5.0])],
            device="cpu")
    ref = RefMPC(5, 2, np.eye(2), np.eye(2), lin, np.zeros(2),
                 u_bounds=[np.array([1.0, np.inf]), np.array([1.0, np.inf])],
                 u_step_bounds=[np.array([-np.inf, -5.0]),
                                np.array([-np.inf, -5.0])])
    for mpc in (K, ref):
        with pytest.raises(ValueError):
            mpc.step(np.zeros(2), np.zeros(2), np.zeros(2))
    assert int(K.last_solution.status) == int(ref.last_solution.status)
    assert int(K.last_solution.status) != 1


def test_input_clamp():
    lin = random_stable_lin_model(3, with_d=False)
    K = MPC(5, 2, np.eye(2), np.eye(2), _port_lin(lin), np.zeros(2),
            device="cpu")
    ref = RefMPC(5, 2, np.eye(2), np.eye(2), lin, np.zeros(2))
    u = K.step(np.full(2, 1e12), np.zeros(2), np.zeros(2))  # clamped to 1e10
    assert np.isfinite(u).all()
    assert _rel(u, ref.step(np.full(2, 1e12), np.zeros(2), np.zeros(2))) <= REL


def test_tank_closed_loop():
    """The nonlinear tank settles to its setpoint with a constant bias
    (the reference's ``test_tank_closed_loop``)."""
    end_time = 80
    ts = np.linspace(0, end_time, end_time * 100)
    dt = ts[1]
    tank = models.TankModel(np.array([50.0]), linear=False)
    lin = models.create_linear_model(
        models.TankModel(np.array([50.0]), linear=False),
        x_bar=np.array([50.0]), u_bar=np.array([10.0]), T=1.0)
    r = np.array([100.0])
    K = MPC(P=20, M=8, Q=np.diag([10.0]), R=np.diag([0.0]), lin_model=lin,
            ysp=lin.yn2d(r), device="cpu")
    X_op, U_op, Y_op = np.array([50.0]), np.array([10.0]), np.array([50.0])
    us, ys, biass = [U_op.copy()], [Y_op.copy()], []
    t_next = 0.0
    for t in ts[1:]:
        tank.step(dt, us[-1])
        ys.append(tank.outputs(us[-1]).copy())
        if t > t_next:
            if K.y_predicted is not None:
                biass.append(ys[-1] - Y_op - K.y_predicted)
            us.append(K.step(tank.X - X_op, us[-1] - U_op, ys[-1] - Y_op) + U_op)
            t_next += 1.0
        else:
            us.append(us[-1])
    ys, biass = np.array(ys), np.array(biass)
    np.testing.assert_allclose(ys[5000:].ravel(), np.full(len(ys) - 5000, r[0]),
                               atol=1e-3)
    late_bias = biass[len(biass) // 2:]
    assert late_bias.size > 0
    np.testing.assert_allclose(late_bias - late_bias.mean(), 0.0, atol=1e-6)
