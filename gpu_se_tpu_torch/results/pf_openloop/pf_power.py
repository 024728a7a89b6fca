"""Energy per PF step, CPU against the card.

Counterpart of the reference's ``results/pf_openloop/pf_power.py``: run
fused PF steps for ``t_run`` seconds under ``PowerMeasurement``'s sampler
and report joules per step, the CPU's and the card's. A probe that gives
no reading reports NaN, never 0 (on the card's host the CPU's counters
do not advance, so its CPU energy is NaN).
"""
import time

import numpy as np

from gpu_se_tpu_torch.results._common import card_label, pyplot, save_fig
from gpu_se_tpu_torch.results._filter_bench import _sync, build, release, warm
from gpu_se_tpu_torch.utils import PickleJar, PowerMeasurement, RunSequences

N_LOG2 = np.arange(0, 21, 2.0)
PACE = 5        # steps between synchronises


def paced_steps(kind, N, t_run, gpu):
    """Step the ``kind`` filter for ``t_run`` seconds, synchronising once
    every ``PACE`` steps so that the queue never runs ahead of the
    window; returns the count of steps. The step is ``build``'s graphed
    op, warmed (captured) before the window."""
    state, ops = build(kind, N, gpu)
    op = ops["step"]
    try:
        s, _ = warm(op, state)
        _sync(s)
        t_end = time.time() + t_run
        count = 0
        while time.time() < t_end:
            for _ in range(PACE):
                s = op(s)
            count += PACE
            _sync(s)
        return count
    finally:
        release(ops)


@RunSequences.vectorize
@PickleJar.pickle(path="pf/power")
@PowerMeasurement.measure
def step_energy(N, t_run, gpu):
    """Runs fused PF steps for ``t_run`` seconds; returns the count."""
    return paced_steps("pf", N, t_run, gpu)


def per_step(ns, results):
    """``(n, cpu J/step, card J/step)`` rows of ``step_energy``'s
    ``(count, [E_cpu, E_card])`` results."""
    return [(int(n), float(e[0] / c), float(e[1] / c))
            for n, (c, e) in zip(ns, results)]


def energy_per_run(t_run=5.0, gpu=True, log2s=N_LOG2):
    ns = (2.0 ** np.asarray(log2s)).astype(int)
    _, results = step_energy(ns, t_run, gpu)
    return per_step(ns, results)


def plot_energy(energy_fn, t_run, xlabel, name):
    """Each leg's card and CPU joules per step, where the probe gave a
    reading."""
    plt = pyplot()
    missing = []
    for gpu, leg in ((True, card_label()), (False, "CPU")):
        rows = energy_fn(t_run, gpu)
        ns = [r[0] for r in rows]
        for col, what in ((2, "card"), (1, "CPU")):
            vals = np.array([r[col] for r in rows])
            if np.isfinite(vals).all():
                plt.loglog(ns, vals, ".-" if what == "card" else ".--",
                           label=f"{leg} leg: {what} J/step")
            else:
                missing.append(f"{what} J/step of the {leg} leg")
    if missing:
        plt.title("no probe reading (NaN), not drawn: " + "; ".join(missing),
                  fontsize=8)
    plt.xlabel(xlabel)
    plt.ylabel("J / step")
    plt.legend()
    return save_fig(name)


def plot(t_run=5.0):
    return plot_energy(energy_per_run, t_run, "N particles", "pf_power.png")


if __name__ == "__main__":
    plot()
