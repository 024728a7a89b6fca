"""A run sequence of the tiled PF step built to pass the pacf gate.

Counterpart of the reference's ``scripts/pacf_series.py``. The reference
gates every run sequence on max |pacf| < 0.2 over lags 1..10. The
chunked sequences of ``_filter_bench.time_op`` cannot pass it: each holds
every chunk mean ``chunk`` times in a row. Here each rep is one K-step
chain of the tiled step (``filters/particle_tiled``) at 2^20 particles,
ended by one synchronise, so no rep waits on its predecessor's queue;
max |pacf| is taken over the reps.

The reference makes each rep one jitted call of the whole chain. Its
counterpart on a CUDA card is one CUDA graph of the K steps
(:class:`GraphedChain`): captured once after a warm-up chain, replayed
once a rep after the rep's perturbed start is copied into its static
input, the noise drawn from a generator registered with the graph,
whose state every replay advances. A capture that fails raises. On the
CPU (``gpu=False``) the chain runs eagerly, step by step, from a
freshly seeded generator a rep, as it also can on the card
(``graphed=False``), for comparison.
Each rep starts from the same particles shifted by :func:`rep_offset`,
at most ~4e-5 as the reference's ``tiled0 + 1e-9 * seed`` is, so every
rep filters the same cloud. Each rep records its host ms (the
perf-counter around the copy, the chain and the synchronise), split into
the part up to the synchronise (the copy and the replay's launch, or the
eager chain's launches) and the synchronise, and its device ms (CUDA
events on the stream, the card only); the card's SM clock is read by
``nvidia-smi`` before and after the series.

Usage: ``python -m gpu_se_tpu_torch.results.pacf_series`` (the card)
prints the series' summary as one JSON line.
"""
import json
import subprocess
import time

import numpy as np
import torch

from gpu_se_tpu_torch.filters import particle_tiled as pft
from gpu_se_tpu_torch.models import bioreactor as bio
from gpu_se_tpu_torch.results._filter_bench import (
    _sync,
    get_device,
    rig_dists,
    rig_inputs,
)
from gpu_se_tpu_torch.utils import max_abs_pacf
from gpu_se_tpu_torch.utils.power import _card_id

N = 2**20
K = 8
REPS = 100
NULL_REPS = 30
DRIFT_REPS = 30      # the reps at each end of a series its drift compares


def chain_steps(x, generator, k, u, z, dt, state_pdf, meas_pdf):
    """``k`` tiled steps from the particles ``x``, drawing from
    ``generator``; the body of a rep, eager or captured."""
    f, g = bio.homeostatic_des, bio.static_outputs
    st = pft.TiledPFState(x=x, generator=generator)
    for _ in range(k):
        st = pft.step(st, u, z, dt, f, g, state_pdf, meas_pdf)
    return st.x


class GraphedChain:
    """The ``k``-step chain as one CUDA graph: ``replay(x)`` copies ``x``
    into the static input and replays. The noise comes from a generator
    seeded ``seed`` and registered with the graph
    (``register_generator_state``), whose state each replay advances.
    ``replays`` counts replays; the kernels' launch counters tick once a
    step at the warm-up and at the capture only."""

    def __init__(self, x, seed, k, u, z, dt, state_pdf, meas_pdf):
        dev = x.device
        self.graph = torch.cuda.CUDAGraph()
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self.graph.register_generator_state(self.generator)
        self.static = x.clone()
        body = (k, u, z, dt, state_pdf, meas_pdf)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            chain_steps(self.static, self.generator, *body)
        torch.cuda.current_stream(dev).wait_stream(side)
        with torch.cuda.graph(self.graph):
            self.out = chain_steps(self.static, self.generator, *body)
        self.replays = 0

    def replay(self, x):
        self.static.copy_(x)
        self.graph.replay()
        self.replays += 1
        return self.out


def rep_offset(rng) -> float:
    """A rep's shift of every input coordinate: the reference's ``1e-9 *
    seed`` with ``seed = |N(0, 1)| 1e4`` in float32
    (``scripts/pacf_series.py:62``, ``:92-94``), about 4e-5 at most."""
    seed = np.float32(abs(rng.standard_normal()) * 1e4)
    return float(np.float32(1e-9) * seed)


def sm_clock_mhz():
    """The card's SM clock by ``nvidia-smi``, MHz; None without a card or
    a reading."""
    card = _card_id()
    if card is None:
        return None
    try:
        return float(subprocess.check_output(
            ["nvidia-smi", "-i", card, "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits"],
            stderr=subprocess.DEVNULL, timeout=5))
    except (OSError, ValueError, subprocess.SubprocessError):
        return None


def drift(series) -> float:
    """The median of the last :data:`DRIFT_REPS` reps over that of the
    first, minus one."""
    series = np.asarray(series)
    return float(np.median(series[-DRIFT_REPS:])
                 / np.median(series[:DRIFT_REPS]) - 1.0)


def pacf_series(n=N, k=K, reps=REPS, gpu=True, graphed=None):
    """Time ``reps`` synchronised chains of ``k`` tiled steps at ``n``
    particles after one warm-up chain; returns the series (host ms a
    rep, split into the launch and the synchronise, and device ms a rep
    on the card), its median, the time of an empty synchronise, max
    |pacf|, the drift and the card's SM clock before and after.
    ``graphed`` (default: ``gpu``) runs each rep as one graph replay;
    ``gpu=False`` needs ``graphed`` false."""
    dev = get_device(gpu)
    graphed = gpu if graphed is None else graphed
    if graphed and not gpu:
        raise ValueError("a graphed chain needs the card (gpu=True)")
    _, x0, state_pdf, meas_pdf = rig_dists(dev)
    u, z, dt = rig_inputs(dev)
    body = (k, u, z, dt, state_pdf, meas_pdf)
    rng = np.random.default_rng(time.time_ns() % 2**32)

    def generator(seed):
        return torch.Generator(device=dev).manual_seed(int(seed))

    x_init = x0.draw_t(generator(rng.integers(2**31)), n)
    if graphed:
        runner = GraphedChain(x_init, int(rng.integers(2**31)), *body)
        run = runner.replay
    else:
        def run(x):
            return chain_steps(x, generator(rng.integers(2**31)), *body)

    run(x_init)                       # warm-up
    _sync(x_init)
    nulls = []
    for _ in range(NULL_REPS):
        t0 = time.perf_counter()
        _sync(x_init)
        nulls.append((time.perf_counter() - t0) * 1e3)
    null_ms = float(np.median(nulls))

    clock_before = sm_clock_mhz() if gpu else None
    series, device = np.empty(reps), np.full(reps, np.nan)
    launch, sync = np.empty(reps), np.empty(reps)
    for i in range(reps):
        x = x_init + rep_offset(rng)
        _sync(x)
        if gpu:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        if gpu:
            start.record()
        run(x)
        if gpu:
            end.record()
        t1 = time.perf_counter()
        _sync(x)
        t2 = time.perf_counter()
        series[i] = (t2 - t0) * 1e3
        launch[i], sync[i] = (t1 - t0) * 1e3, (t2 - t1) * 1e3
        if gpu:
            device[i] = start.elapsed_time(end)
    clock_after = sm_clock_mhz() if gpu else None
    pacf = float(max_abs_pacf(series / 1e3))
    med = float(np.median(series))
    out = {
        "metric": "per-rep wall time of a K-step synchronised tiled-PF chain",
        "device": str(dev),
        "chain": "one CUDA graph replay a rep" if graphed
                 else "eager, one launch a kernel",
        "n": n, "k_steps": k, "reps": reps,
        "null_sync_ms": null_ms,
        "median_rep_ms": med,
        "per_step_ms_est": (med - null_ms) / k,
        "max_abs_pacf": pacf,
        "gate_passed": bool(pacf < 0.2),
        "drift": drift(series) if reps >= 2 * DRIFT_REPS else None,
        "series_ms": series.tolist(),
        "launch_series_ms": launch.tolist(),
        "sync_series_ms": sync.tolist(),
        "launch_median_ms": float(np.median(launch)),
        "sync_median_ms": float(np.median(sync)),
        "launch_max_abs_pacf": float(max_abs_pacf(launch / 1e3)),
        "sync_max_abs_pacf": float(max_abs_pacf(sync / 1e3)),
        "sm_clock_mhz": {"before": clock_before, "after": clock_after},
    }
    if gpu:
        out.update(
            device_series_ms=device.tolist(),
            device_median_rep_ms=float(np.median(device)),
            device_max_abs_pacf=float(max_abs_pacf(device / 1e3)),
            device_drift=(drift(device) if reps >= 2 * DRIFT_REPS
                          else None))
    if graphed:
        out["replays"] = runner.replays
    return out


if __name__ == "__main__":
    print(json.dumps(pacf_series()))
