"""A run sequence of the tiled PF step built to pass the pacf gate.

Counterpart of the reference's ``scripts/pacf_series.py``. The reference
gates every run sequence on max |pacf| < 0.2 over lags 1..10. The
chunked sequences of ``_filter_bench.time_op`` cannot pass it: each holds
every chunk mean ``chunk`` times in a row. Here each rep is one K-step
chain of the tiled step (``filters/particle_tiled``) at 2^20 particles
from a freshly seeded generator, ended by one synchronise, so no rep
waits on its predecessor's queue; max |pacf| is taken over the reps.

Usage: ``python -m gpu_se_tpu_torch.results.pacf_series`` (the card)
prints the series' summary as one JSON line.
"""
import json
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

N = 2**20
K = 8
REPS = 100
NULL_REPS = 30


def pacf_series(n=N, k=K, reps=REPS, gpu=True):
    """Time ``reps`` synchronised chains of ``k`` tiled steps at ``n``
    particles after one warm-up chain; returns the series (ms a rep),
    its median, the time of an empty synchronise and max |pacf|."""
    dev = get_device(gpu)
    _, x0, state_pdf, meas_pdf = rig_dists(dev)
    u, z, dt = rig_inputs(dev)
    f, g = bio.homeostatic_des, bio.static_outputs
    rng = np.random.default_rng(time.time_ns() % 2**32)

    def generator(seed):
        return torch.Generator(device=dev).manual_seed(int(seed))

    x_init = x0.draw_t(generator(rng.integers(2**31)), n)

    def chain(seed):
        st = pft.TiledPFState(x=x_init + 1e-9 * float(seed),
                              generator=generator(seed))
        for _ in range(k):
            st = pft.step(st, u, z, dt, f, g, state_pdf, meas_pdf)
        _sync(st.x)
        return st

    chain(rng.integers(2**31))
    nulls = []
    for _ in range(NULL_REPS):
        t0 = time.perf_counter()
        _sync(x_init)
        nulls.append((time.perf_counter() - t0) * 1e3)
    null_ms = float(np.median(nulls))

    series = np.empty(reps)
    for i in range(reps):
        seed = rng.integers(2**31)
        t0 = time.perf_counter()
        chain(seed)
        series[i] = (time.perf_counter() - t0) * 1e3
    pacf = float(max_abs_pacf(series / 1e3))
    med = float(np.median(series))
    return {
        "metric": "per-rep wall time of a K-step synchronised tiled-PF chain",
        "device": str(dev),
        "n": n, "k_steps": k, "reps": reps,
        "null_sync_ms": null_ms,
        "median_rep_ms": med,
        "per_step_ms_est": (med - null_ms) / k,
        "max_abs_pacf": pacf,
        "gate_passed": bool(pacf < 0.2),
        "series_ms": series.tolist(),
    }


if __name__ == "__main__":
    print(json.dumps(pacf_series()))
