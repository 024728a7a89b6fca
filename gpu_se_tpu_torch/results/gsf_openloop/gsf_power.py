"""Energy per GSF step (twin of ``pf_power``).

Counterpart of the reference's ``results/gsf_openloop/gsf_power.py``.
The fused step resamples every cycle (normalizing the weights), so no
rescue factor against float32 underflow is needed.
"""
import numpy as np

from gpu_se_tpu_torch.results.pf_openloop.pf_power import (
    paced_steps,
    per_step,
    plot_energy,
)
from gpu_se_tpu_torch.utils import PickleJar, PowerMeasurement, RunSequences

N_LOG2 = np.arange(0, 17, 2.0)


@RunSequences.vectorize
@PickleJar.pickle(path="gsf/power")
@PowerMeasurement.measure
def step_energy(N, t_run, gpu):
    """Runs fused GSF steps for ``t_run`` seconds; returns the count."""
    return paced_steps("gsf", N, t_run, gpu)


def energy_per_run(t_run=5.0, gpu=True, log2s=N_LOG2):
    ns = (2.0 ** np.asarray(log2s)).astype(int)
    _, results = step_energy(ns, t_run, gpu)
    return per_step(ns, results)


def plot(t_run=5.0):
    return plot_energy(energy_per_run, t_run, "N Gaussians", "gsf_power.png")


if __name__ == "__main__":
    plot()
