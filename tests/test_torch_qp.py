"""The port's dense ADMM QP against the JAX reference, on the CPU.

Each problem of ``tests/test_qp.py`` goes to both solvers with identical
float32 constants (carried across by ``convert.qp_constants_from_numpy``
from the reference's; the port's own host setup gives the same bits).
Status and iteration count must be equal. ``x``, ``y`` and ``z`` must
agree within 1e-5 of their largest magnitude, or, where the problem is
so sensitive that moving ``q`` by one float32 ulp moves the port's own
solution by more than 1e-6, within 10 times that movement: the random
problems of seeds 2 and 4 (measured here; at seed 2 that movement is
about 2e-4 of ``x`` and 5e-3 of ``y``), whose solutions both solvers
reach through different float32 rounding. The port also passes the KKT
and closed-form assertions of ``tests/test_qp.py``; ``solve_batch``
equals the stacked single solves bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from gpu_se_tpu.control import qp as ref_qp
from gpu_se_tpu_torch import convert
from gpu_se_tpu_torch.control import qp

from tests.test_qp import check_kkt, make_random_qp

REL = 1e-5


def _equality():
    rng = np.random.default_rng(0)
    n, p = 6, 2
    M = rng.normal(size=(n, n))
    P = M @ M.T + np.eye(n)
    q = rng.normal(size=n)
    A = rng.normal(size=(p, n))
    b = rng.normal(size=p)
    return P, A, q, b, b


def _infinite():
    P, A, q, l, u = make_random_qp(10, 15, 7)
    l[::2] = -np.inf
    u[1::2] = np.inf
    return P, A, q, l, u


def _warm():
    P, A, q, l, u = make_random_qp(12, 18, 9)
    return P, A, q, l + 0.05, u + 0.05


# name: (problem, settings kwargs, expected status)
CASES = {
    "unconstrained": (lambda: (np.diag([2.0, 4.0]), np.zeros((0, 2)),
                               np.array([-2.0, -8.0]), np.zeros(0),
                               np.zeros(0)), {}, qp.SOLVED),
    "box_clipped": (lambda: (np.eye(3), np.eye(3), -np.array([5.0, 0.5, -3.0]),
                             -np.ones(3), np.ones(3)), {}, qp.SOLVED),
    "equality": (_equality, {}, qp.SOLVED),
    **{f"random_{s}": (lambda s=s: make_random_qp(20, 30, s), {}, qp.SOLVED)
       for s in (1, 2, 3, 4)},
    "infinite_bounds": (_infinite, {}, qp.SOLVED),
    "warm_shifted": (_warm, {}, qp.SOLVED),
    "primal_infeasible": (lambda: (np.eye(1), np.array([[1.0], [1.0]]),
                                   np.zeros(1), np.array([1.0, -np.inf]),
                                   np.array([np.inf, -1.0])), {},
                          qp.PRIMAL_INFEASIBLE),
    "dual_infeasible": (lambda: (np.zeros((1, 1)), np.array([[1.0]]),
                                 np.array([1.0]), np.array([-np.inf]),
                                 np.array([0.0])), {}, qp.DUAL_INFEASIBLE),
    "tight_tolerance": (lambda: make_random_qp(8, 12, 11),
                        dict(eps_abs=1e-5, eps_rel=1e-5), qp.SOLVED),
}


def _pair(P, A, q, l, u, settings):
    ref = ref_qp.DenseQP(P, A, l, u, q, settings=ref_qp.QPSettings(**settings))
    port = qp.DenseQP(P, A, l, u, q, settings=qp.QPSettings(**settings),
                      device="cpu")
    leaves = {f.name: np.asarray(getattr(ref.consts, f.name))
              for f in dataclasses.fields(port.consts)}
    for name, leaf in leaves.items():
        np.testing.assert_array_equal(getattr(port.consts, name).numpy(),
                                      leaf, err_msg=name)
    port.consts = convert.qp_constants_from_numpy(device="cpu", **leaves)
    return ref, port


def _rel(got, want):
    scale = np.abs(want).max() if want.size else 0.0
    return np.abs(got - want).max() / scale if scale else 0.0


@pytest.mark.parametrize("name", list(CASES))
def test_solve_matches_reference(name):
    make, settings, status = CASES[name]
    P, A, q, l, u = make()
    ref, port = _pair(P, A, q, l, u, settings)
    r = ref.solve(q, l, u)
    p = port.solve(q, l, u)
    assert int(p.status) == int(r.status) == status
    assert int(p.iterations) == int(r.iterations)
    # how far one float32 ulp of q moves the port's own solution
    q_ulp = np.nextafter(np.float32(q), np.float32(np.inf))
    nudged = port.solve(q_ulp, l, u)
    for field in ("x", "y", "z"):
        got = getattr(p, field).numpy()
        want = np.asarray(getattr(r, field))
        assert got.shape == want.shape and got.dtype == np.float32
        sens = _rel(getattr(nudged, field).numpy(), got)
        bound = REL if sens <= 1e-6 else 10 * sens
        assert _rel(got, want) <= bound, (field, _rel(got, want), sens)
    assert np.isfinite(float(p.prim_res)) and np.isfinite(float(p.dual_res))
    if status == qp.SOLVED:
        x, y = p.x.numpy().astype(float), p.y.numpy().astype(float)
        tol = 1e-3 if name == "tight_tolerance" else 5e-3
        check_kkt(P, A, q, np.where(np.isinf(l), -1e30, l),
                  np.where(np.isinf(u), 1e30, u), x, y, tol=tol)


def test_closed_forms():
    """The closed-form assertions of ``tests/test_qp.py``."""
    P, A, q, l, u = CASES["unconstrained"][0]()
    sol = qp.DenseQP(P, A, q_pattern=q, device="cpu").solve(q, l, u)
    np.testing.assert_allclose(sol.x.numpy(), [1.0, 2.0], atol=1e-3)
    P, A, q, l, u = CASES["box_clipped"][0]()
    sol = qp.DenseQP(P, A, l, u, q, device="cpu").solve(q, l, u)
    np.testing.assert_allclose(sol.x.numpy(), [1.0, 0.5, -1.0], atol=1e-3)
    P, A, q, b, _ = _equality()
    n, p = A.shape[1], A.shape[0]
    kkt = np.block([[P, A.T], [A, np.zeros((p, p))]])
    x_star = np.linalg.solve(kkt, np.concatenate([-q, b]))[:n]
    sol = qp.DenseQP(P, A, b, b, q, device="cpu").solve(q, b, b)
    assert int(sol.status) == qp.SOLVED
    np.testing.assert_allclose(sol.x.numpy(), x_star, atol=5e-3)


def test_warm_start_matches_reference():
    """The OSQP pattern: fixed (P, A), shifted bounds, warm start from
    the last solution; fewer iterations than cold, as the reference."""
    P, A, q, l, u = make_random_qp(12, 18, 9)
    ref, port = _pair(P, A, q, l, u, {})
    r1, p1 = ref.solve(q, l, u), port.solve(q, l, u)
    l2, u2 = l + 0.05, u + 0.05
    r2 = ref.solve(q, l2, u2, x0=r1.x, y0=r1.y)
    p2 = port.solve(q, l2, u2, x0=p1.x, y0=p1.y)
    assert int(p2.status) == int(r2.status) == qp.SOLVED
    assert int(p2.iterations) == int(r2.iterations)
    assert int(p2.iterations) <= int(port.solve(q, l2, u2).iterations)
    np.testing.assert_allclose(p2.x.numpy(), np.asarray(r2.x),
                               atol=REL * np.abs(np.asarray(r2.x)).max())
    check_kkt(P, A, q, l2, u2, p2.x.numpy().astype(float),
              p2.y.numpy().astype(float))


def _batch(P, A, q, l, u, port):
    """Members that stop at different checks: the problem, its bounds
    shifted, its cost scaled, a warm start from the solution."""
    first = port.solve(q, l, u)
    qs = np.stack([q, q, 3.0 * q, q])
    ls = np.stack([l, l + 0.05, l, l - 0.2])
    us = np.stack([u, u + 0.05, u, u + 0.1])
    x0s = np.zeros((4, P.shape[0]), np.float32)
    y0s = np.zeros((4, A.shape[0]), np.float32)
    x0s[1], y0s[1] = first.x.numpy(), first.y.numpy()
    return qs, ls, us, x0s, y0s


@pytest.mark.parametrize("problem", ["random", "identity"])
def test_solve_batch_equals_single_solves(problem):
    settings = qp.QPSettings()
    if problem == "random":
        P, A, q, l, u = make_random_qp(12, 18, 9)
    else:   # the MPC's mode: identity Hessian, Woodbury with m = 2
        rng = np.random.default_rng(2)
        n = 40
        P, A = np.eye(n), rng.normal(size=(2, n)) * np.array([[1.0], [30.0]])
        q = 10.0 * rng.normal(size=n)
        l, u = np.array([-0.5, -np.inf]), np.array([np.inf, 0.3])
        settings = qp.QPSettings(eps_abs=1e-6, eps_rel=1e-6)
    port = qp.DenseQP(P, A, l, u, q, settings=settings, device="cpu")
    assert port.settings.identity_hessian == (problem == "identity")
    qs, ls, us, x0s, y0s = _batch(P, A, q, l, u, port)
    batch = port.solve_batch(qs, ls, us, x0s, y0s)
    iters = batch.iterations.tolist()
    assert len(set(iters)) > 1, iters
    assert batch.status.tolist() == [qp.SOLVED] * 4
    for i in range(4):
        one = port.solve(qs[i], ls[i], us[i], x0s[i], y0s[i])
        for f in dataclasses.fields(one):
            assert torch.equal(getattr(batch, f.name)[i], getattr(one, f.name)), (
                i, f.name)


def test_tf32_off_inside_and_restored(monkeypatch):
    """Every product of a solve runs at "highest" float32 matmul
    precision (TF32 off), and the caller's setting comes back."""
    seen = []
    mv = qp._mv

    def spy(M, v):
        seen.append(torch.get_float32_matmul_precision())
        return mv(M, v)

    monkeypatch.setattr(qp, "_mv", spy)
    P, A, q, l, u = make_random_qp(6, 8, 1)
    port = qp.DenseQP(P, A, l, u, q, device="cpu")
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        port.solve(q, l, u)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert seen and set(seen) == {"highest"}


def test_one_read_per_check(monkeypatch):
    """The loop reads the device at most once per check: no value comes
    back inside a check interval."""
    reads = []
    for name in ("tolist", "item", "__bool__", "__int__", "__float__"):
        orig = getattr(torch.Tensor, name)

        def wrap(self, *a, _orig=orig, _name=name, **k):
            reads.append(_name)
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, wrap)
    P, A, q, l, u = make_random_qp(20, 30, 1)
    port = qp.DenseQP(P, A, l, u, q, device="cpu")
    sol = port.solve(q, l, u)
    monkeypatch.undo()
    checks = int(sol.iterations) // port.settings.check_every
    assert checks > 1 and reads == ["tolist"] * checks, reads
