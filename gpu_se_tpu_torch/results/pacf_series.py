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
events on the stream around the copy, the launch and the chain, the card
only); a replay also records the graph's steps alone (events captured in
the graph, ``graph_series_ms``); the card's SM clock is read by
``nvidia-smi`` before and after the series, and the SM and memory
clocks and the temperature by NVML before each rep.

Usage: ``python -m gpu_se_tpu_torch.results.pacf_series`` (the card)
prints the series' summary as one JSON line; ``--idle-gap-s 0.05``
leaves the card idle 50 ms before each rep, a diagnostic series kept out
of the series of record.
"""
import argparse
import ctypes
import json
import subprocess
import time

import numpy as np
import torch

from gpu_se_tpu_torch import graphs
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
    """The ``k``-step chain as one CUDA graph (``gpu_se_tpu_torch.graphs``):
    built by one warm-up chain and the capture, then ``replay(x)`` copies
    ``x`` into the static input and replays. The noise comes from a
    generator seeded ``seed`` and registered with the graph, whose state
    each replay advances. ``replays`` counts replays; the kernels' launch
    counters tick once a step at the warm-up and at every replay. Two
    timing events are recorded around the steps, on the capture stream,
    as event nodes of the graph: :meth:`graph_ms` reads the last replay's
    steps alone, with neither the input's copy nor the host's launch."""

    def __init__(self, x, seed, k, u, z, dt, state_pdf, meas_pdf):
        self.generator = torch.Generator(device=x.device).manual_seed(seed)
        self.begin, self.end = (
            torch.cuda.Event(enable_timing=True, external=True)
            for _ in range(2))
        body = (k, u, z, dt, state_pdf, meas_pdf)

        def chain(x, generator):
            # external events are recorded at the capture only (the
            # warm-up's eager chain runs without them)
            capturing = torch.cuda.is_current_stream_capturing()
            if capturing:
                self.begin.record()
            out = chain_steps(x, generator, *body)
            if capturing:
                self.end.record()
            return out

        self.graphed = graphs.Graphed(chain, copy_out=False)
        self.graphed(x, self.generator)

    @property
    def replays(self) -> int:
        return self.graphed.replays

    def replay(self, x):
        return self.graphed(x, self.generator)

    def graph_ms(self) -> float:
        """The device ms of the last replay's steps; call after it has
        finished."""
        return self.begin.elapsed_time(self.end)


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


class CardSensors:
    """The card's SM and memory clocks (MHz) and its temperature (C),
    read through NVML (``libnvidia-ml``, the library ``nvidia-smi``
    reads) in well under a millisecond, so between reps. Each reading is
    None without a card or the library."""

    FIELDS = ("sm_clock_mhz", "mem_clock_mhz", "temperature_c")

    def __init__(self):
        self._lib = self._dev = None
        card = _card_id()
        if card is None:
            return
        try:
            lib = ctypes.CDLL("libnvidia-ml.so.1")
        except OSError:
            return
        lib.nvmlInit_v2.argtypes = []
        lib.nvmlShutdown.argtypes = []
        lib.nvmlDeviceGetHandleByUUID.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)]
        lib.nvmlDeviceGetClockInfo.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint)]
        lib.nvmlDeviceGetTemperature.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint)]
        for fn in (lib.nvmlInit_v2, lib.nvmlShutdown,
                   lib.nvmlDeviceGetHandleByUUID, lib.nvmlDeviceGetClockInfo,
                   lib.nvmlDeviceGetTemperature):
            fn.restype = ctypes.c_int
        if lib.nvmlInit_v2() != 0:
            return
        dev = ctypes.c_void_p()
        if lib.nvmlDeviceGetHandleByUUID(card.encode(),
                                         ctypes.byref(dev)) != 0:
            lib.nvmlShutdown()
            return
        self._lib, self._dev = lib, dev

    def read(self) -> dict:
        """``{"sm_clock_mhz", "mem_clock_mhz", "temperature_c"}``."""
        if self._lib is None:
            return dict.fromkeys(self.FIELDS)
        out = {}
        # NVML_CLOCK_SM = 1, NVML_CLOCK_MEM = 2, NVML_TEMPERATURE_GPU = 0
        for name, fn, kind in (
                ("sm_clock_mhz", self._lib.nvmlDeviceGetClockInfo, 1),
                ("mem_clock_mhz", self._lib.nvmlDeviceGetClockInfo, 2),
                ("temperature_c", self._lib.nvmlDeviceGetTemperature, 0)):
            v = ctypes.c_uint()
            out[name] = (float(v.value)
                         if fn(self._dev, kind, ctypes.byref(v)) == 0
                         else None)
        return out

    def close(self) -> None:
        if self._lib is not None:
            self._lib.nvmlShutdown()
            self._lib = self._dev = None


def correlation(a, b):
    """Pearson's r of two series, None where either is missing or
    constant."""
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    if not (np.isfinite(a).all() and np.isfinite(b).all()) \
            or a.std() == 0 or b.std() == 0:
        return None
    return float(np.corrcoef(a, b)[0, 1])


def drift(series) -> float:
    """The median of the last :data:`DRIFT_REPS` reps over that of the
    first, minus one."""
    series = np.asarray(series)
    return float(np.median(series[-DRIFT_REPS:])
                 / np.median(series[:DRIFT_REPS]) - 1.0)


def pacf_series(n=N, k=K, reps=REPS, gpu=True, graphed=None,
                idle_gap_s=0.0):
    """Time ``reps`` synchronised chains of ``k`` tiled steps at ``n``
    particles after one warm-up chain; returns the series (host ms a
    rep, split into the launch and the synchronise, and device ms a rep
    on the card), its median, the time of an empty synchronise, max
    |pacf|, the drift, the card's SM clock before and after, and beside
    each rep the SM and memory clocks and the temperature read just
    before it (:class:`CardSensors`), with each one's correlation with
    the rep's own device time (the graph's, for a replay).
    ``graphed`` (default: ``gpu``) runs each rep as one graph replay;
    ``gpu=False`` needs ``graphed`` false. ``idle_gap_s`` leaves the card
    idle that long before each rep: a diagnostic, never the series of
    record."""
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
    sensors = CardSensors() if gpu else None
    readings = []
    series, device = np.empty(reps), np.full(reps, np.nan)
    graph = np.full(reps, np.nan)
    launch, sync = np.empty(reps), np.empty(reps)
    for i in range(reps):
        if idle_gap_s:
            time.sleep(idle_gap_s)
        if sensors is not None:
            readings.append(sensors.read())
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
        if graphed:
            graph[i] = runner.graph_ms()
    clock_after = sm_clock_mhz() if gpu else None
    if sensors is not None:
        sensors.close()
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
        "idle_gap_s": idle_gap_s,
    }
    if gpu:
        own = graph if graphed else device
        out["sensor_series"] = {f: [r[f] for r in readings]
                                for f in CardSensors.FIELDS}
        out["correlation_with_own_ms"] = {
            f: correlation(own, out["sensor_series"][f])
            for f in CardSensors.FIELDS}
        out["correlation_with_own_ms"]["rep"] = correlation(
            own, np.arange(reps))
    if gpu:
        out.update(
            device_series_ms=device.tolist(),
            device_median_rep_ms=float(np.median(device)),
            device_max_abs_pacf=float(max_abs_pacf(device / 1e3)),
            device_drift=(drift(device) if reps >= 2 * DRIFT_REPS
                          else None))
    if graphed:
        out.update(
            replays=runner.replays,
            graph_series_ms=graph.tolist(),
            graph_median_rep_ms=float(np.median(graph)),
            graph_max_abs_pacf=float(max_abs_pacf(graph / 1e3)))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="The pacf series of record, "
                                             "or with --idle-gap-s a "
                                             "diagnostic series")
    ap.add_argument("--idle-gap-s", type=float, default=0.0)
    print(json.dumps(pacf_series(idle_gap_s=ap.parse_args().idle_gap_s)))
