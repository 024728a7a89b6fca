"""The QP solve split into the parts its device loop is built from, on
the CPU.

``control/qp._Loop`` holds the ADMM's carry and the parts that act on it
(``prepare``, ``chunk``, ``refactor_where``, ``tail``, ``result``). On
the CPU a Python loop drives them (``host_solve``), reading the flags
``go``, ``refac`` and ``more`` once a chunk; on the card one graph holds
them, the loop a conditional WHILE node (``ops/graph_cond``). Here:

* the host loop against the JAX reference's ``DenseQP.solve`` at
  ``tests/test_torch_qp.py``'s tolerance (statuses and iterations
  exact), on instances that take the adaptive-rho refactorization, that
  stall at ``max_iter``, and whose ``max_iter`` is no multiple of
  ``check_every``;
* batch members bit-equal to their single solves;
* the device loop's structure (``_device_solve``: prepare, WHILE(go) {
  chunk; IF(refac) { refactor } }, IF(more) { tail }, result) run by a
  stand-in for the conditional nodes, bit-equal to the host loop;
* the conditional nodes' wrapper refuses a CPU flag and a call outside a
  capture, and its C symbols are declared.

The card's side (the device loop bit-equal to ``qp.host_driven()``) is in
``tests/test_torch_kernels.py`` (``gpu``).
"""
import re

import numpy as np
import pytest
import torch

from gpu_se_tpu_torch import rig
from gpu_se_tpu_torch.control import qp
from gpu_se_tpu_torch.ops import _build, graph_cond

from tests.test_qp import make_random_qp
from tests.test_torch_qp import REL, _pair, _rel

CPU = torch.device("cpu")


# name: (problem, settings, expected status, refactorizations at least):
# the card's cases (``rig.QP_CASES``) and two more
CASES = {
    **rig.QP_CASES,
    "general_short": (lambda: make_random_qp(20, 30, 1),
                      dict(max_iter=60), qp.MAX_ITER_REACHED, 1),
    "under_one_chunk": (lambda: make_random_qp(8, 12, 3), dict(max_iter=20),
                        qp.MAX_ITER_REACHED, 0),
}


def test_rig_draws_the_test_problems():
    for a, b in zip(rig.random_qp(12, 18, 3), make_random_qp(12, 18, 3)):
        np.testing.assert_array_equal(a, b)


def _t(v):
    return torch.as_tensor(np.asarray(v), dtype=torch.float32)


def _loop(port, b):
    return qp._Loop(port.consts, b, port.settings, torch.float32, CPU)


def _solve(loop, q, l, u, solver="host_solve"):
    b = q.shape[0]
    with torch.no_grad():
        return getattr(loop, solver)(q, l, u, q.new_zeros((b, loop.n)),
                                     q.new_zeros((b, loop.m)))


def _fields(sol):
    return [getattr(sol, f) for f in ("x", "y", "z", "status", "iterations",
                                      "prim_res", "dual_res")]


@pytest.mark.parametrize("name", list(CASES))
def test_host_loop_matches_reference(name):
    """The parts driven from the host against the reference's
    ``lax.while_loop``: statuses and iterations equal, the iterate within
    ``tests/test_torch_qp.py``'s bound (1e-5, or 10 times what one ulp of
    ``q`` moves it)."""
    make, settings, status, refactors = CASES[name]
    P, A, q, l, u = make()
    ref, port = _pair(P, A, q, l, u, settings)
    r = ref.solve(q, l, u)
    loop = _loop(port, 1)
    p = _solve(loop, _t(q)[None], _t(l)[None], _t(u)[None])
    assert int(p.status[0]) == int(r.status) == status
    assert int(p.iterations[0]) == int(r.iterations)
    assert int(loop.refactors[0]) >= refactors
    q_ulp = np.nextafter(np.float32(q), np.float32(np.inf))
    nudged = port.solve(q_ulp, l, u)
    # the public solve is the same host loop
    again = port.solve(q, l, u)
    for got, want in zip(_fields(again), _fields(p)):
        assert torch.equal(got, want[0])
    for field in ("x", "y", "z"):
        got = getattr(p, field)[0].numpy()
        want = np.asarray(getattr(r, field))
        sens = _rel(getattr(nudged, field).numpy(), got)
        bound = REL if sens <= 1e-6 else 10 * sens
        assert _rel(got, want) <= bound, (field, _rel(got, want), sens)


@pytest.mark.parametrize("name", ["general_ragged", "identity_stall"])
def test_batch_members_equal_single_solves(name):
    """Three members, each with its own ``q``, stop and refactorize at
    their own checks; each equals its single solve bit for bit (at n <=
    12, where the CPU's ``bmm`` takes the same path at every batch
    size, as in ``tests/test_torch_qp.py``)."""
    make, settings, _, _ = CASES[name]
    P, A, q, l, u = make()
    _, port = _pair(P, A, q, l, u, settings)
    qs = np.stack([q, 0.5 * q, -q])
    batch = port.solve_batch(qs, np.stack([l] * 3), np.stack([u] * 3))
    for i in range(3):
        single = port.solve(qs[i], l, u)
        for got, want in zip(_fields(batch), _fields(single)):
            assert torch.equal(got[i], want)


def test_host_loop_reads_once_a_chunk(monkeypatch):
    """One read of the flags after each chunk, none after the tail."""
    P, A, q, l, u = make_random_qp(20, 30, 1)
    _, port = _pair(P, A, q, l, u, dict(max_iter=110))
    reads = []
    tolist = torch.Tensor.tolist
    monkeypatch.setattr(torch.Tensor, "tolist",
                        lambda t: reads.append(t.shape) or tolist(t))
    sol = port.solve(q, l, u)
    chunks = int(sol.iterations) // port.settings.check_every
    assert reads == [(3,)] * chunks


class StandInPart:
    """A captured part: its replay runs the part."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


def _run(items):
    for item in items:
        if isinstance(item, graph_cond.If):
            if bool(item.flag):
                _run(item.body)
        else:
            item.replay()


def _stand_in_while(flag, body):
    """A WHILE node: the body once, then again while ``flag`` holds."""
    _run(body)
    while bool(flag):
        _run(body)


@pytest.mark.parametrize("name", list(CASES) + ["unconstrained"])
def test_device_structure_equals_host_loop(name, monkeypatch):
    """``_device_solve``, its conditional nodes run by a stand-in,
    computes what the host loop does, bit for bit, batched."""
    monkeypatch.setattr(graph_cond, "while_loop", _stand_in_while)
    monkeypatch.setattr(graph_cond, "if_then",
                        lambda flag, body: _run(body) if bool(flag) else None)
    if name == "unconstrained":
        P, A, q, l, u = (np.diag([2.0, 4.0]), np.zeros((0, 2)),
                         np.array([-2.0, -8.0]), np.zeros(0), np.zeros(0))
        settings = {}
    else:
        make, settings, _, _ = CASES[name]
        P, A, q, l, u = make()
    _, port = _pair(P, A, q, l, u, settings)
    qs, ls, us = (_t(np.stack([v, 0.5 * v])) for v in (q, l, u))
    loop = _loop(port, 2)
    want = _fields(_solve(loop, qs, ls, us))
    loop.parts = {k: StandInPart(fn) for k, fn in loop.fns.items()}
    got = _fields(_solve(loop, qs, ls, us, "_device_solve"))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_graph_cond_refuses_cpu_and_no_capture(monkeypatch):
    """No plain version: a flag on the CPU raises, and so does a call
    outside a capture."""
    flag = torch.zeros((), dtype=torch.bool)
    for insert in (graph_cond.while_loop, graph_cond.if_then):
        with pytest.raises(ValueError, match="only on a CUDA card"):
            insert(flag, [])
    with pytest.raises(TypeError):
        graph_cond.while_loop(torch.zeros(1, dtype=torch.bool), [])
    with pytest.raises(ValueError):
        graph_cond.prepare("cpu")
    monkeypatch.setattr(graph_cond, "_check_flag", lambda flag: None)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    for insert in (graph_cond.while_loop, graph_cond.if_then):
        with pytest.raises(RuntimeError, match="no capture is underway"):
            insert(flag, [])
    assert _build._lib is None


def test_graph_cond_symbols_are_declared():
    """Every C function of ``csrc/graph_cond.cu`` has its argument types
    in ``_build._SIGNATURES``, one per parameter."""
    src = (_build.CSRC / "graph_cond.cu").read_text()
    extern = src[src.index('extern "C" {'):]
    found = dict(re.findall(r"^int (gst_\w+)\(([^)]*)\)", extern, re.M))
    assert set(found) == {
        "gst_cond_prepare", "gst_capture_handle", "gst_capture_set",
        "gst_capture_cond", "gst_graph_handle", "gst_graph_child",
        "gst_graph_set", "gst_graph_cond", "gst_cond_count",
        "gst_cond_count_reset"}
    for name, params in found.items():
        n = 0 if params.strip() in ("", "void") else params.count(",") + 1
        assert len(_build._SIGNATURES[name]) == n, name
