"""The port's scenario MPC against the JAX reference, on the CPU.

The sizes and cases are ``tests/test_scenario_mpc.py``'s. The host
setup is the same float64 numpy, so every host array is bit-equal, and
so is every float32 leaf of ``consensus_consts``. The solves are float32
ADMM in both packages: the stacked solve's control and predictions agree
with the reference's within 1e-4, the independent solves' controls
within 1e-4 and predictions within 1e-3, the consensus within 5e-4 of
the reference's consensus. Within the port, a member of the batched
scenario solve equals the single ``make_device_step`` solve of its row
bit for bit.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_se_tpu.control import ScenarioMPC as RefScenarioMPC
from gpu_se_tpu.control import consensus_consts as ref_consensus_consts
from gpu_se_tpu.control import scenario_mpc as ref_smpc
from gpu_se_tpu.parallel import scenario as ref_scenario
from gpu_se_tpu_torch.control import MPC, ScenarioMPC, consensus_consts
from gpu_se_tpu_torch.control import scenario_mpc as smpc_mod
from gpu_se_tpu_torch.control.mpc import make_device_step
from gpu_se_tpu_torch.control.qp import SOLVED
from gpu_se_tpu_torch.parallel import (
    make_consensus_scenario_step,
    make_scenario_solver,
)

from tests.test_mpc import random_stable_lin_model
from tests.test_scenario_mpc import _P_HOR, _M_HOR, _binding_setup, _scenarios
from tests.test_torch_mpc import _port_lin

CPU = "cpu"
Q, R, YSP = np.eye(2), 0.5 * np.eye(2), np.array([0.3, -0.2])


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def _pair(lin, n_scenarios, **bounds):
    ref = RefScenarioMPC(_P_HOR, _M_HOR, Q, R, lin, YSP,
                         n_scenarios=n_scenarios, **bounds)
    ours = ScenarioMPC(_P_HOR, _M_HOR, Q, R, _port_lin(lin), YSP,
                       n_scenarios=n_scenarios, device=CPU, **bounds)
    return ref, ours


def _binding():
    lin, x0s, um1, biases, y_bounds = _binding_setup()
    return lin, x0s, um1, biases, dict(y_bounds=y_bounds)


BOUNDS = {
    "none": {},
    "y": dict(y_bounds=[np.array([-0.8, 0.8]), np.array([-0.8, 0.8])]),
    "all": dict(y_bounds=[np.array([-0.8, 0.8]), np.array([-0.8, 0.8])],
                u_bounds=[np.array([-2.0, 2.0]), np.array([-1.5, 1.5])],
                u_step_bounds=[np.array([-0.5, 0.5]), np.array([-0.4, 0.4])]),
}


# ----------------------------------------------------------------------
# the host setup, bit for bit
# ----------------------------------------------------------------------
@pytest.mark.parametrize("bounds", list(BOUNDS), ids=list(BOUNDS))
def test_condense_and_whiten_bit_equal(bounds):
    lin = random_stable_lin_model(11, with_d=True)
    want = ref_smpc.condense(lin, _P_HOR, _M_HOR, Q, R, YSP, **BOUNDS[bounds])
    got = smpc_mod.condense(_port_lin(lin), _P_HOR, _M_HOR, Q, R, YSP,
                            **BOUNDS[bounds])
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(want, f.name), err_msg=f.name)
    for L, L_invT in zip(smpc_mod._chol_whiten(got.P_dd),
                         ref_smpc._chol_whiten(want.P_dd)):
        np.testing.assert_array_equal(L, L_invT)
    # a singular Hessian takes the ridge
    sing = np.ones((3, 3))
    for a, b in zip(smpc_mod._chol_whiten(sing), ref_smpc._chol_whiten(sing)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bounds", list(BOUNDS), ids=list(BOUNDS))
def test_scenario_mpc_host_arrays_bit_equal(bounds):
    lin = random_stable_lin_model(11, with_d=False)
    ref, ours = _pair(lin, 4, **BOUNDS[bounds])
    assert (ours.n_D, ours.m) == (ref.n_D, ref.m)
    np.testing.assert_array_equal(ours._L, ref._L)
    np.testing.assert_array_equal(ours._L_invT, ref._L_invT)
    for name in ("A_s", "rho", "rho_inv", "d_scale", "e_scale", "c_scale",
                 "aat", "s_fac"):
        np.testing.assert_array_equal(
            getattr(ours.qp.consts, name).numpy(),
            np.asarray(getattr(ref.qp.consts, name)), err_msg=name)
    assert ours.qp.settings.identity_hessian and ref.qp.settings.identity_hessian
    assert (ours.qp.settings.eps_abs, ours.qp.settings.max_iter) == (1e-6, 20000)
    assert ours._warm_w.shape == (ours.n_D,) and not ours._warm_w.any()
    assert ours._warm_y.shape == (ours.m,) and not ours._warm_y.any()


@pytest.mark.parametrize("bounds", list(BOUNDS), ids=list(BOUNDS))
def test_consensus_consts_bit_equal(bounds):
    lin = random_stable_lin_model(11, with_d=False)
    args = (_P_HOR, _M_HOR, Q, R, YSP)
    want, want_settings, want_dims = ref_consensus_consts(
        lin, *args, **BOUNDS[bounds])
    got, settings, dims = consensus_consts(_port_lin(lin), *args,
                                           device=CPU, **BOUNDS[bounds])
    assert dims == want_dims
    assert set(got) == set(want)
    for key, leaf in want.items():
        if key == "qp":
            for f in dataclasses.fields(leaf):
                np.testing.assert_array_equal(
                    getattr(got["qp"], f.name).numpy(),
                    np.asarray(getattr(leaf, f.name)), err_msg=f.name)
        elif leaf is None:
            assert got[key] is None, key
        else:
            assert got[key].dtype == torch.float32, key
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(leaf),
                                          err_msg=key)
    for f in dataclasses.fields(want_settings):
        if f.name != "dtype":
            assert getattr(settings, f.name) == getattr(want_settings, f.name)


# ----------------------------------------------------------------------
# the stacked solve
# ----------------------------------------------------------------------
def _mean_ctrl(lin, x0s, um1, biases, **bounds):
    """The port's solve at the scenario mean."""
    K = MPC(_P_HOR, _M_HOR, Q, R, _port_lin(lin), YSP, device=CPU, **bounds)
    ctrl, _, st = make_scenario_solver(K)(
        _t(x0s.mean(axis=0)[None]), _t(um1[None]),
        _t(biases.mean(axis=0)[None]))
    assert int(st[0]) == SOLVED
    return ctrl[0].numpy().astype(float)


@pytest.mark.parametrize("case", ["certainty_equivalence", "binding"])
def test_stacked_step_matches_reference(case):
    if case == "binding":
        lin, x0s, um1, biases, bounds = _binding()
    else:
        lin = random_stable_lin_model(11, with_d=False)
        (x0s, um1, biases), bounds = _scenarios(), {}
    ref, ours = _pair(lin, 4, **bounds)
    want, want_y1 = ref.step(x0s, um1, biases)
    ctrl, y1 = ours.step(x0s, um1, biases)
    assert int(ours.last_solution.status) == int(ref.last_solution.status)
    np.testing.assert_allclose(ctrl, want, atol=1e-4)
    np.testing.assert_allclose(y1, want_y1, atol=1e-4)

    ctrl_mean = _mean_ctrl(lin, x0s, um1, biases, **bounds)
    if case == "certainty_equivalence":
        np.testing.assert_allclose(ctrl, ctrl_mean, atol=5e-4)
        return
    # the outlier binds its output bound: the shared move hedges
    assert np.max(np.abs(ctrl - ctrl_mean)) > 1e-3, (ctrl, ctrl_mean)
    cd = ours._cd
    du0, moves = ours.last_moves()
    y_free = ours._y_free(x0s, um1, biases)
    worst = -np.inf
    for s in range(4):
        ys = y_free[s] + cd.theta @ np.concatenate([du0, moves[s].reshape(-1)])
        assert np.all(ys <= cd.y_hi + 1e-3) and np.all(ys >= cd.y_lo - 1e-3)
        worst = max(worst, np.max(np.abs(ys) - 0.8))
    assert worst > -1e-2


def test_stacked_step_warm_starts_and_raises():
    lin, x0s, um1, biases, bounds = _binding()
    _, ours = _pair(lin, 4, **bounds)
    first = ours.step(x0s, um1, biases)[0]
    assert ours._warm_w is ours.last_solution.x
    again = ours.step(x0s, um1, biases)[0]
    np.testing.assert_allclose(again, first, atol=1e-4)
    with pytest.raises(ValueError, match="scenario rows"):
        ours.step(x0s[:3], um1, biases)
    # bounds no first move meets: the solve does not end SOLVED
    tight = [np.array([-0.01, 0.01]), np.array([-0.01, 0.01])]
    _, infeasible = _pair(lin, 4, y_bounds=tight)
    with pytest.raises(ValueError, match="did not solve"):
        infeasible.step(x0s, um1, biases)


# ----------------------------------------------------------------------
# the independent solves
# ----------------------------------------------------------------------
def _make_mpcs():
    """``tests/test_scenario_mpc._make_mpc``'s MPC in both packages."""
    lin = random_stable_lin_model(11, with_d=False)
    kw = dict(u_bounds=[np.array([-2.0, 2.0]), np.array([-2.0, 2.0])])
    from gpu_se_tpu.control import MPC as RefMPC
    return (RefMPC(10, 4, Q, R, lin, YSP, **kw),
            MPC(10, 4, Q, R, _port_lin(lin), YSP, device=CPU, **kw))


def test_scenario_solver_matches_reference_and_single_solves():
    K_ref, K = _make_mpcs()
    rng = np.random.default_rng(1)
    n_sc = 16
    x0s = rng.normal(scale=0.3, size=(n_sc, 2)).astype(np.float32)
    um1s = np.zeros((n_sc, 2), np.float32)
    biases = rng.normal(scale=0.05, size=(n_sc, 2)).astype(np.float32)
    want = ref_scenario.make_scenario_solver(K_ref)(
        jnp.asarray(x0s), jnp.asarray(um1s), jnp.asarray(biases))
    ctrls, preds, st = make_scenario_solver(K)(_t(x0s), _t(um1s), _t(biases))
    assert st.dtype == torch.int32
    np.testing.assert_array_equal(st.numpy(), np.asarray(want[2]))
    assert bool((st == SOLVED).all())
    np.testing.assert_allclose(ctrls.numpy(), np.asarray(want[0]), atol=1e-4)
    np.testing.assert_allclose(preds.numpy(), np.asarray(want[1]), atol=1e-3)

    consts, step_fn = make_device_step(K)
    n_d, m = (K.M + 1) * K.Ni, K.qp.m
    for i in range(n_sc):
        ctrl, pred, sol = step_fn(consts, _t(x0s[i]), _t(um1s[i]),
                                  _t(biases[i]), torch.zeros(n_d),
                                  torch.zeros(m))
        assert torch.equal(ctrl, ctrls[i]) and torch.equal(pred, preds[i])
        assert int(sol.status) == int(st[i])


# ----------------------------------------------------------------------
# the consensus step
# ----------------------------------------------------------------------
def test_consensus_matches_reference_and_stacked():
    lin, x0s, um1, biases, bounds = _binding()
    _, ours = _pair(lin, 4, **bounds)
    ctrl_exact, _ = ours.step(x0s, um1, biases)

    args = (_P_HOR, _M_HOR, Q, R, YSP)
    consts, settings, dims = consensus_consts(_port_lin(lin), *args,
                                              device=CPU, **bounds)
    step = make_consensus_scenario_step(settings, dims, n_outer=60)
    ctrl, gap, worst = step(consts, _t(x0s), _t(um1), _t(biases))
    assert ctrl.dtype == torch.float32 and ctrl.shape == (2,)
    assert int(worst) == SOLVED
    assert float(gap) < 1e-3
    np.testing.assert_allclose(ctrl.numpy(), ctrl_exact, atol=2e-3)

    r_consts, r_settings, r_dims = ref_consensus_consts(lin, *args, **bounds)
    want, _, _ = ref_scenario.make_consensus_scenario_step(
        r_settings, r_dims, n_outer=60)(
        r_consts, jnp.asarray(x0s, jnp.float32), jnp.asarray(um1, jnp.float32),
        jnp.asarray(biases, jnp.float32))
    np.testing.assert_allclose(ctrl.numpy(), np.asarray(want), atol=5e-4)


def test_consensus_restores_the_matmul_precision():
    lin, x0s, um1, biases, bounds = _binding()
    consts, settings, dims = consensus_consts(
        _port_lin(lin), _P_HOR, _M_HOR, Q, R, YSP, device=CPU, **bounds)
    step = make_consensus_scenario_step(settings, dims, n_outer=2)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        step(consts, _t(x0s), _t(um1), _t(biases))
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)


def test_mesh_is_the_multi_device_slice():
    """Both entries take a mesh; on a mesh of one rank (the CPU, no
    process group) they give ``mesh=None``'s results bit for bit. Wider
    meshes are held to the reference's in ``tests/test_torch_sharding.py``.
    """
    from gpu_se_tpu_torch.parallel import make_mesh

    mesh = make_mesh(device=CPU)
    _, K = _make_mpcs()
    rng = np.random.default_rng(1)
    x0s = _t(rng.normal(scale=0.3, size=(4, 2)))
    args = (x0s, torch.zeros((4, 2)), _t(rng.normal(scale=0.05, size=(4, 2))))
    for a, b in zip(make_scenario_solver(K, mesh)(*args),
                    make_scenario_solver(K)(*args)):
        assert torch.equal(a, b)
    lin, x0s, um1, biases, bounds = _binding()
    consts, settings, dims = consensus_consts(
        _port_lin(lin), _P_HOR, _M_HOR, Q, R, YSP, device=CPU, **bounds)
    scen = (consts, _t(x0s), _t(um1), _t(biases))
    for a, b in zip(
            make_consensus_scenario_step(settings, dims, mesh,
                                         n_outer=5)(*scen),
            make_consensus_scenario_step(settings, dims, n_outer=5)(*scen)):
        assert torch.equal(a, b)


def test_rig_binding_case_is_the_references():
    """``rig.binding_case`` (the card's copy, numpy only) holds
    ``tests/test_scenario_mpc._binding_setup``'s model and scenarios."""
    from gpu_se_tpu_torch import rig
    case = rig.binding_case()
    lin, x0s, um1, biases, y_bounds = _binding_setup()
    for got, want in zip(case["model"], (lin.A, lin.B, lin.C, lin.D)):
        np.testing.assert_array_equal(got, want)
    for key, want in (("x0s", x0s), ("um1", um1), ("biases", biases),
                      ("y_bounds", y_bounds), ("Q", Q), ("R", R),
                      ("ysp", YSP)):
        np.testing.assert_array_equal(case[key], want, err_msg=key)
    assert (case["P"], case["M"]) == (_P_HOR, _M_HOR)
