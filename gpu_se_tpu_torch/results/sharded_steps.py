"""Peak memory and time a step of the sharded flat and GSUKF steps, a
rank, at W = 1 and W = 2 on one card.

Each width runs as a gloo group of spawned processes on card 0
(``parallel/launch.run_group``: NCCL refuses two ranks on one card), so
both widths pay the same transport. Each rank holds ``n_local`` = 2^20
particles (the flat step, ``kernel`` and ``a2a`` routes) or 2^18
Gaussians (the GSUKF, ``kernel`` route) of one global state drawn from
the seed on ``bench.py``'s rig. :func:`step_rows` steps once, then takes
one more step's peak device memory above what was allocated before it
(``torch.cuda.max_memory_allocated``, after a garbage collection), then
the ms a step of ``STEPS`` chained steps by CUDA events, after a
barrier.

It drives the entry points only, so a copy of this file in an older tree
of the package measures that tree the same way. ``chip_smoke.py``'s
W = 2 phase takes its memory and times from :func:`step_rows` too, its
sharded phase builds each entry point with :func:`entry_step`, and the
tests and the smoke run count a rank's draws with :func:`counted_draws`.

Usage (the card): ``python -m gpu_se_tpu_torch.results.sharded_steps``
prints the card's ``nvidia-smi`` line and one JSON line.
"""
import contextlib
import gc
import json
import subprocess

import torch
import torch.distributed as dist

from gpu_se_tpu_torch import rig
from gpu_se_tpu_torch.distributions import GaussianSum
from gpu_se_tpu_torch.filters import gs_ukf as gsf
from gpu_se_tpu_torch.filters import particle as pf
from gpu_se_tpu_torch.filters import particle_tiled as pft
from gpu_se_tpu_torch.models import bioreactor as bio
from gpu_se_tpu_torch.parallel import (
    make_mesh,
    make_shard_map_gsukf_step,
    make_shard_map_step,
    make_shard_map_tiled_step,
    shard_gsukf_state,
    shard_pf_state,
    shard_tiled_pf_state,
)
from gpu_se_tpu_torch.parallel.launch import run_group

N_LOCAL = {"flat": 2**20, "gsukf": 2**18, "tiled": 2**20}
STEPS = {"flat kernel": 20, "flat a2a": 20, "gsukf kernel": 10}
WIDTHS = (1, 2)
SEED = 0
TIMEOUT_S = 600


@contextlib.contextmanager
def counted_draws():
    """A list that gains ``(start, count, nx)`` for every counter-stream
    draw (``GaussianSum.draw_inputs_at`` and its lanes-last twin) made
    while the block runs."""
    draws = []
    real = {name: getattr(GaussianSum, name)
            for name in ("draw_inputs_at", "draw_inputs_at_t")}

    def spy(name):
        def draw(self, key, start, count):
            draws.append((int(start), int(count), self.n_dim))
            return real[name](self, key, start, count)
        return draw

    for name in real:
        setattr(GaussianSum, name, spy(name))
    try:
        yield draws
    finally:
        for name, fn in real.items():
            setattr(GaussianSum, name, fn)


def step_rows(step, state, steps: int, dev):
    """``(first, peak_bytes, ms)`` of the one-argument ``step`` on a rank
    of a group: ``first`` the state after one step from ``state``; the
    peak device memory of the next step above what was allocated before
    it; the ms a step of ``steps`` more chained steps, by CUDA events
    after a barrier."""
    first = step(state)
    # free earlier steps' cyclic garbage now, not during the measured
    # step; the peak is reset before the base is read, so a free between
    # the two cannot make the difference negative
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    state = step(first)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    dist.barrier()
    start.record()
    for _ in range(steps):
        state = step(state)
    end.record()
    torch.cuda.synchronize(dev)
    return first, int(peak), start.elapsed_time(end) / steps


def entry_step(mesh, name: str, seed: int, rig_parts, width=None):
    """``(state, fn, step)`` on this rank: its slice of one global state
    of ``N_LOCAL * width`` particles (Gaussians; ``width`` defaults to
    the mesh's) drawn from ``seed`` on ``bench.py``'s rig
    (``rig_parts``: its ``x0``, ``state_pdf`` and ``meas_pdf`` on the
    mesh's device), the entry point ``name`` ("<filter> <route>") and
    ``step(state)`` at its inputs."""
    dev = mesh.device
    x0, state_pdf, meas_pdf = rig_parts
    f, g = bio.homeostatic_des, bio.static_outputs
    u = torch.tensor([0.06, 0.2], dtype=torch.float32, device=dev)
    z = g(torch.from_numpy(rig.X_SS)).to(torch.float32).to(dev)
    dt = torch.tensor(0.1, device=dev)
    kind, route = name.split()
    n_global = N_LOCAL[kind] * (width or mesh.size)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if kind == "flat":
        state = shard_pf_state(pf.init(gen, n_global, x0), mesh)
        fn = make_shard_map_step(mesh, f, g, resample_impl=route)
    elif kind == "gsukf":
        state = shard_gsukf_state(gsf.init(gen, n_global, x0, state_pdf),
                                  mesh)
        fn = make_shard_map_gsukf_step(mesh, f, g, resample_impl=route)
    else:
        state = shard_tiled_pf_state(pft.init(gen, n_global, x0), mesh)
        fn = make_shard_map_tiled_step(mesh, f, g, exchange=route)
    return state, fn, lambda s: fn(s, u, z, dt, state_pdf, meas_pdf)


def rank_run(seed: int) -> dict:
    """This rank's ``{step: (peak_bytes, ms a step)}`` for every entry of
    :data:`STEPS` at this group's width."""
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh()
    dev = mesh.device
    torch.cuda.set_device(dev)
    rig_parts = tuple(GaussianSum.create(*a, device=dev)
                      for a in rig.bench_rig())
    rows = {}
    for name, steps in STEPS.items():
        state, _, step = entry_step(mesh, name, seed, rig_parts)
        _, peak, ms = step_rows(step, state, steps, dev)
        rows[name] = (peak, ms)
    return rows


def measure(widths=WIDTHS, seed: int = SEED) -> dict:
    """``{"W=<w>": {step: {"n_local", "peak_bytes" (a rank), "ms" (a
    step, a rank)}}}``."""
    out = {}
    for w in widths:
        ranks = run_group(rank_run, w, seed, timeout_s=TIMEOUT_S)
        out[f"W={w}"] = {
            name: {"n_local": N_LOCAL[name.split()[0]],
                   "peak_bytes": [r[name][0] for r in ranks],
                   "ms": [r[name][1] for r in ranks]}
            for name in STEPS}
    return out


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("the sharded steps are measured on a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    print(json.dumps(measure()), flush=True)
