"""The one generator of the benchmark's traffic: it reads a traffic file's
parameters and the configuration, and makes every input from the seed.

``ss2ss``: the measurement stream of the thesis's open-loop transition
between steady states. The plant (``reference/plant.py``, float64 on the
host) starts at the steady state for the configuration's ``u_start``;
the input holds each of the traffic's ``inputs`` for
``segment_samples`` samples in turn, so every window, however many
steps it completes, holds transitions. One sample every ``dt``: the
plant takes an Euler step plus a draw of the state noise, and is
measured with a draw of the measurement noise.
"""
from __future__ import annotations

import numpy as np

from port_bench.reference import plant


def ss2ss(cfg: dict, traffic: dict, seed: int, n: int, mixtures: dict):
    """``(x_start, us (n, 2), zs (n, 2))``: step ``i`` moves the filter
    by ``us[i]`` over ``dt`` and then measures ``zs[i]``."""
    pl = cfg["plant"]
    x = list(plant.steady_state(pl["u_start"], pl["x_guess"]))
    x_start = np.array(x)
    rng = np.random.default_rng([seed, 0])
    w = mixtures["state"].draw(rng, n)
    v = mixtures["measurement"].draw(rng, n)
    inputs = [list(map(float, u)) for u in traffic["inputs"]]
    seg = int(traffic["segment_samples"])
    dt = float(traffic["dt"])
    us = np.empty((n, 2))
    zs = np.empty((n, 2))
    for i in range(n):
        u = inputs[(i // seg) % len(inputs)]
        x = plant.euler(x, u, dt)
        x = [x[j] + w[i, j] for j in range(5)]
        us[i] = u
        zs[i] = plant.measure(x)
        zs[i] += v[i]
    return x_start, us, zs


def episode_order(traffic: dict, seed: int) -> list:
    """The closed loop's pool of episodes (``pool``: each an index whose
    noise is drawn from ``noise_seed`` plus it) in the order this seed
    runs them: every seed runs the same episodes."""
    pool = [int(e) for e in traffic["pool"]]
    return [pool[k] for k in np.random.default_rng([seed, 2]).permutation(
        len(pool))]
