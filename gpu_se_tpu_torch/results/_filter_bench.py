"""Shared filter-benchmark machinery for the run-sequence experiments.

Counterpart of the reference's ``results/_filter_bench.py``: builds the
canonical-rig filter at a given particle (or Gaussian) count on the card
(``gpu=True``) or the CPU (``gpu=False``), the same code on either, then
times predict / update / resample / full step with chained inputs.

``gpu=True`` raises where torch sees no CUDA card: the reference only
warns there, which would put CPU data under the card's label.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

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


def build(kind: str, n: int, gpu: bool):
    """Return ``(state, ops)`` for ``kind`` in {'pf', 'gsf'} on the
    device: the state drawn from a generator seeded 0, and ``predict``,
    ``update``, ``resample`` and ``step`` as functions of the state."""
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
        predict=lambda s: core.predict(s, u, dt, f, state_pdf),
        update=lambda s: core.update(s, u, z, g, meas_pdf),
        resample=core.resample,
        step=lambda s: core.step(s, u, z, dt, f, g, state_pdf, meas_pdf),
    )
    return state, ops


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


def time_op(op, state, runs: int, chunk: int = 5) -> np.ndarray:
    """Chained wall-clock run sequence.

    Each call takes the previous call's state. After one warm-up call,
    calls are timed in chunks of ``chunk`` with one synchronise per chunk
    (none on the CPU, whose ops return finished); each run's recorded
    time is its chunk's mean, in seconds.
    """
    s = op(state)
    _sync(s)
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
    return out


def run_seq(kind: str, op_name: str, n: int, runs: int, gpu: bool) -> np.ndarray:
    state, ops = build(kind, n, gpu)
    return time_op(ops[op_name], state, runs)


def breakdown_pf(n: int, runs: int, gpu: bool):
    """Per-stage timings of the PF cycle: predict split into the dynamics
    and the noise draw, resample into the ancestor indices and the gather;
    and the full step."""
    dev = get_device(gpu)
    _, _, state_pdf, _ = rig_dists(dev)
    f = bio.Bioreactor.homeostatic_DEs
    u, _, dt = rig_inputs(dev)
    state, ops = build("pf", n, gpu)
    replace = dataclasses.replace

    def dyn(s):
        return replace(s, particles=s.particles + f(s.particles.T, u, dt).T)

    def noi(s):
        return replace(s, particles=s.particles
                       + state_pdf.draw(s.generator, (n,)))

    def idxf(s):
        r = torch.rand((), generator=s.generator, dtype=torch.float32,
                       device=dev)
        idx = systematic_resample_indices(s.weights + 1e-12, r)
        # fold the indices back into the weights, scaled tiny, so that
        # each call depends on the last
        return replace(s, weights=s.weights + idx.to(s.weights.dtype) * 1e-30
                       + 1e-12)

    def gat(s):
        shift = torch.randint(0, n, (), generator=s.generator, device=dev)
        idx = (torch.arange(n, device=dev) + shift) % n
        return replace(s, particles=torch.index_select(s.particles, 0, idx))

    return {
        "dynamics": time_op(dyn, state, runs),
        "noise": time_op(noi, state, runs),
        "indices": time_op(idxf, state, runs),
        "gather": time_op(gat, state, runs),
        "full_step": time_op(ops["step"], state, runs),
    }
