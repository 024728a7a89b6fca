"""Shared filter-benchmark machinery for the run-sequence experiments.

Counterpart of the reference's ``results/_filter_bench.py``: builds the
canonical-rig filter at a given particle (or Gaussian) count on the card
(``gpu=True``) or the CPU (``gpu=False``), the same code on either, then
times predict / update / resample / full step with chained inputs.

As the reference wraps each op in ``jax.jit``, each op here is a
:class:`~gpu_se_tpu_torch.graphs.Graphed` function: one CUDA graph
replay a call on the card (its first calls capture it), run directly on
the CPU. The ops hand out the graph's own tensors (``copy_out=False``),
which the chained timing feeds back, so a timed call is the copy of the
state into the graph's static input and the replay. Under
``graphs.disabled()`` they run eagerly, the eager side of a comparison.

``gpu=True`` raises where torch sees no CUDA card: the reference only
warns there, which would put CPU data under the card's label.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from gpu_se_tpu_torch import graphs
from gpu_se_tpu_torch.distributions import GaussianSum
from gpu_se_tpu_torch.filters import gs_ukf
from gpu_se_tpu_torch.filters import particle as pf_core
from gpu_se_tpu_torch.filters.resampling import systematic_resample_indices
from gpu_se_tpu_torch.models import bioreactor as bio

X_SS = np.array([280 / 180, 640 / 24.6, 1000 / 116, 0.0, 0.0])
U = (0.06, 0.2)
DT = 0.1


def rig_dists(device="cpu"):
    """``(x_ss, x0, state_pdf, meas_pdf)``: the steady state and the rig's
    three Gaussian mixtures on ``device``."""
    x0 = GaussianSum.create(
        np.stack([X_SS, X_SS]),
        np.stack([np.eye(5) * 1e-4, np.eye(5) * 1e-3]),
        np.array([0.75, 0.25]),
        device=device,
    )
    state_pdf = GaussianSum.create(
        np.zeros((2, 5)),
        np.stack(
            [
                np.diag([1e-4, 1e-7, 1e-3, 1e-3, 1e-7]),
                np.diag([1e-3, 1e-6, 1e-2, 1e-2, 1e-6]),
            ]
        ),
        np.array([0.75, 0.25]),
        device=device,
    )
    meas_pdf = GaussianSum.create(
        np.array([[1e-1, 0], [0, -1e-1]]),
        np.array([[[6e-2, 0], [0, 8e-2]], [[500, 100], [100, 700]]]),
        np.array([0.85, 0.15]),
        device=device,
    )
    return X_SS, x0, state_pdf, meas_pdf


def get_device(gpu: bool) -> torch.device:
    """``gpu=True``: the current CUDA card, and a ``RuntimeError`` where
    there is none; ``gpu=False``: the CPU."""
    if gpu:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "gpu=True needs a CUDA card and torch sees none: a card "
                "leg run here would put CPU times under the card's label")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def rig_inputs(device):
    """``(u, z, dt)`` of the rig on ``device``: the input, the noiseless
    measurement at the steady state (float32) and the step."""
    u = torch.tensor(U, dtype=torch.float32, device=device)
    z = bio.static_outputs(torch.from_numpy(X_SS)).to(torch.float32).to(device)
    dt = torch.tensor(DT, dtype=torch.float32, device=device)
    return u, z, dt


def graphed(fn: Callable) -> graphs.Graphed:
    """``fn``, a function of the state, as an op: one graph replay a call
    on the card, handing out the graph's own tensors."""
    return graphs.Graphed(fn, copy_out=False)


def build(kind: str, n: int, gpu: bool):
    """Return ``(state, ops)`` for ``kind`` in {'pf', 'gsf'} on the
    device: the state drawn from a generator seeded 0, and ``predict``,
    ``update``, ``resample`` and ``step`` as graphed functions of the
    state (:func:`graphed`)."""
    dev = get_device(gpu)
    _, x0, state_pdf, meas_pdf = rig_dists(dev)
    f = bio.Bioreactor.homeostatic_DEs
    g = bio.Bioreactor.static_outputs
    u, z, dt = rig_inputs(dev)
    core = pf_core if kind == "pf" else gs_ukf
    gen = torch.Generator(device=dev).manual_seed(0)
    if kind == "pf":
        state = pf_core.init(gen, n, x0)
    else:
        state = gs_ukf.init(gen, n, x0, state_pdf)
    ops = dict(
        predict=graphed(lambda s: core.predict(s, u, dt, f, state_pdf)),
        update=graphed(lambda s: core.update(s, u, z, g, meas_pdf)),
        resample=graphed(core.resample),
        step=graphed(lambda s: core.step(s, u, z, dt, f, g, state_pdf,
                                         meas_pdf)),
    )
    return state, ops


def release(ops) -> None:
    """Free the graphs of ``ops`` (a dict of ops or one op) and their
    memory pools: each size's before the next."""
    for op in ops.values() if isinstance(ops, dict) else (ops,):
        if isinstance(op, graphs.Graphed):
            op.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _leaf(s) -> torch.Tensor:
    """The state's first tensor."""
    if isinstance(s, torch.Tensor):
        return s
    return next(getattr(s, f.name) for f in dataclasses.fields(s)
                if isinstance(getattr(s, f.name), torch.Tensor))


def _sync(s) -> None:
    leaf = _leaf(s)
    if leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)


_TALLIES: list = []      # the open ``warm_calls`` blocks' lists


@contextlib.contextmanager
def warm_calls():
    """Yield a list that gains, for each :func:`warm` run inside the
    block, the count of calls it made: a graphed op's warm-up launches
    its kernels as a timed call does."""
    tally: list = []
    _TALLIES.append(tally)
    try:
        yield tally
    finally:
        # by identity: two tallies may hold equal counts
        _TALLIES[:] = [t for t in _TALLIES if t is not tally]


def warm(op, s):
    """``op`` called on ``s`` once, and for a graphed op on the card again
    until a call replays: a key is also its inputs' layout, and an op's
    output (fed back) may key a graph of its own. Returns the last state
    and the count of calls (also added to each open :func:`warm_calls`
    tally); raises if three more calls do not settle."""
    s, calls = op(s), 1
    if (isinstance(op, graphs.Graphed) and graphs.on_card(_leaf(s).device)
            and not graphs.is_disabled(op)):
        for _ in range(3):
            before = op.captures
            s, calls = op(s), calls + 1
            if op.captures == before:
                break
        else:
            raise RuntimeError(
                "a graphed op captured at each of its warm-up calls")
    for tally in _TALLIES:
        tally.append(calls)
    return s, calls


def time_op(op, state, runs: int, chunk: int = 5) -> np.ndarray:
    """Chained wall-clock run sequence.

    Each call takes the previous call's state. After the warm-up
    (:func:`warm`: one call, and for a graphed op on the card its
    captures), calls are timed in chunks of ``chunk`` with one
    synchronise per chunk (none on the CPU, whose ops return finished);
    each run's recorded time is its chunk's mean, in seconds. A timed
    call of a graphed op is a replay: one that captured raises.
    """
    s, _ = warm(op, state)
    _sync(s)
    captures = getattr(op, "captures", None)
    out = np.empty(runs)
    done = 0
    while done < runs:
        c = min(chunk, runs - done)
        t0 = time.perf_counter()
        for _ in range(c):
            s = op(s)
        _sync(s)
        out[done:done + c] = (time.perf_counter() - t0) / c
        done += c
    if captures is not None and op.captures != captures:
        raise RuntimeError("a timed call of a graphed op captured")
    return out


def run_seq(kind: str, op_name: str, n: int, runs: int, gpu: bool) -> np.ndarray:
    state, ops = build(kind, n, gpu)
    try:
        return time_op(ops[op_name], state, runs)
    finally:
        release(ops)


def breakdown_ops(n: int, gpu: bool):
    """``(state, ops)`` of the PF cycle's stages: ``dynamics`` and
    ``noise`` (predict split), ``indices`` and ``gather`` (resample
    split), and ``full_step``; each a graphed op, as the reference jits
    each."""
    dev = get_device(gpu)
    _, _, state_pdf, _ = rig_dists(dev)
    f = bio.Bioreactor.homeostatic_DEs
    u, _, dt = rig_inputs(dev)
    state, ops = build("pf", n, gpu)
    replace = dataclasses.replace

    @graphed
    def dyn(s):
        return replace(s, particles=s.particles + f(s.particles.T, u, dt).T)

    @graphed
    def noi(s):
        return replace(s, particles=s.particles
                       + state_pdf.draw(s.generator, (n,)))

    @graphed
    def idxf(s):
        r = torch.rand((), generator=s.generator, dtype=torch.float32,
                       device=dev)
        idx = systematic_resample_indices(s.weights + 1e-12, r)
        # fold the indices back into the weights, scaled tiny, so that
        # each call depends on the last
        return replace(s, weights=s.weights + idx.to(s.weights.dtype) * 1e-30
                       + 1e-12)

    @graphed
    def gat(s):
        shift = torch.randint(0, n, (), generator=s.generator, device=dev)
        idx = (torch.arange(n, device=dev) + shift) % n
        return replace(s, particles=torch.index_select(s.particles, 0, idx))

    return state, {"dynamics": dyn, "noise": noi, "indices": idxf,
                   "gather": gat, "full_step": ops["step"]}


def breakdown_pf(n: int, runs: int, gpu: bool):
    """Per-stage timings of the PF cycle (:func:`breakdown_ops`), each
    stage's graphs freed before the next."""
    state, ops = breakdown_ops(n, gpu)
    rows = {}
    for name, op in ops.items():
        rows[name] = time_op(op, state, runs)
        release(op)
    return rows
