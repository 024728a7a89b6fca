"""GSF closed-loop quality and cost frontier (twin of the PF's).

Counterpart of the reference's
``results/gsf_closedloop/bioreactor_performance_gsf.py``, through the
PF module's shared bodies with the GSUKF as the filter.
"""
import numpy as np

from gpu_se_tpu_torch.results.pf_closedloop.bioreactor_performance_pf import (
    DT_CONTROL,
    plot_frontier,
    sim_summary,
    sim_summary_device,
    utilization,
)
from gpu_se_tpu_torch.utils import PickleJar

N_LOG2 = np.arange(1, 15, 2.0)


@PickleJar.pickle(path="gsf/closedloop")
def get_sim_summary(N_particles, dt_control, dt_predict, monte_carlo=0,
                    end_time=50, device="cuda"):
    """Run one closed-loop simulation with the GSUKF; summarize its
    quality and runtime."""
    return sim_summary(N_particles, dt_control, dt_predict, monte_carlo,
                       end_time, False, device)


@PickleJar.pickle(path="gsf/closedloop_device")
def get_sim_summary_device(N_particles, dt_control, dt_predict,
                           monte_carlo=0, end_time=50, device="cuda"):
    """Device twin of :func:`get_sim_summary`: the loop of
    ``sim.loop.make_scan_loop`` with the GSUKF."""
    return sim_summary_device(N_particles, dt_control, dt_predict,
                              monte_carlo, end_time, False, device)


def frontier_device(log2s=N_LOG2, dt_control=DT_CONTROL, end_time=50):
    rows = []
    for log2 in log2s:
        n = int(2**log2)
        s = get_sim_summary_device(n, dt_control, dt_control, 0, end_time)
        rows.append((n, s["performance"], utilization(s, dt_control)))
    return np.array(rows)


def frontier(log2s=N_LOG2, dt_control=DT_CONTROL, end_time=50):
    rows = []
    for log2 in log2s:
        n = int(2**log2)
        s = get_sim_summary(n, dt_control, dt_control, 0, end_time)
        rows.append((n, s["performance"], utilization(s, dt_control)))
    return np.array(rows)


def plot(log2s=N_LOG2):
    return plot_frontier(frontier, frontier_device, get_sim_summary, log2s,
                         "N Gaussians", "bioreactor_performance_gsf.png")


if __name__ == "__main__":
    plot()
