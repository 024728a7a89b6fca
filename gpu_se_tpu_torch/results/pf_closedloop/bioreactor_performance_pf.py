"""PF closed-loop quality and cost frontier: ITSE against real-time
utilisation, and the filter covariance's convergence against N.

Counterpart of the reference's
``results/pf_closedloop/bioreactor_performance_pf.py``. The host shell
(``sim.Simulation``: the plant on the host, the filter and the QP on the
card) and its device twin (``sim.loop.make_scan_loop``: the whole loop's
state on the card) are each timed over one closed loop.
"""
import time

import numpy as np
import torch

from gpu_se_tpu_torch import sim
from gpu_se_tpu_torch.filters import gs_ukf
from gpu_se_tpu_torch.filters import particle as pf_core
from gpu_se_tpu_torch.models import bioreactor as bio
from gpu_se_tpu_torch.results._common import host_array, pyplot, save_fig
from gpu_se_tpu_torch.sim.loop import make_scan_loop
from gpu_se_tpu_torch.utils import PickleJar

N_LOG2 = np.arange(2, 21, 2.0)
DT_CONTROL = 0.1


def sim_summary(N_particles, dt_control, dt_predict, monte_carlo, end_time,
                pf, device):
    """One ``Simulation``'s quality and wall-clock runtime."""
    s = sim.Simulation(
        int(N_particles), dt_control, dt_predict, end_time, pf=pf,
        seed=monte_carlo, device=device,
    )
    t0 = time.perf_counter()
    s.simulate()
    runtime = time.perf_counter() - t0
    return dict(
        performance=float(s.performance),
        mpc_frac=float(s.mpc_frac),
        predict_count=s.predict_count,
        update_count=s.update_count,
        runtime=runtime,
        covariance_point_size=np.asarray(s.covariance_point_size),
        ts=s.ts,
    )


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sim_summary_device(N_particles, dt_control, dt_predict, monte_carlo,
                       end_time, pf, device):
    """One run of the loop whose state stays on the device: a warm-up
    run, then a timed run from a fresh generator ended by one
    synchronise; ``null_rtt``, an empty synchronise's time, is taken off
    ``runtime_raw`` to give ``runtime``."""
    bioreactor, lin_model, K, est = sim.get_parts(
        dt_control, int(N_particles), pf=pf, seed=monte_carlo, device=device,
    )
    state_pdf, measurement_pdf = sim.get_noise(device=device)
    run, ts = make_scan_loop(
        K, lin_model, state_pdf.dist, measurement_pdf.dist,
        end_time=end_time, dt_control=dt_control, dt_predict=dt_predict,
        filter_core=pf_core if pf else gs_ukf,
    )
    dev = K.qp.device
    x0 = np.asarray(bioreactor.X, dtype=np.float32)

    def generator(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    rec = run(est.state, x0, generator(int(monte_carlo) + 1))
    _sync(dev)
    # the timed run draws other noise than the warm-up's
    timed_gen = generator(time.time_ns() % (2**31 - 1))
    t0 = time.perf_counter()
    run(est.state, x0, timed_gen)
    _sync(dev)
    t1 = time.perf_counter()
    _sync(dev)
    t2 = time.perf_counter()
    runtime = max((t1 - t0) - (t2 - t1), 0.0)

    xs = rec.xs.T.to(torch.float64)
    xs_f = rec.xs_f.T.to(torch.float64)
    ys = host_array(bio.all_outputs(xs)).T
    ys_f = host_array(bio.all_outputs(xs_f)).T
    sel = np.asarray(lin_model.outputs, dtype=int)
    perf = sim.performance(ys[:, sel], ys_f[:, sel], ts[1:])
    status = host_array(rec.status)
    return dict(
        performance=float(perf),
        mpc_frac=float(np.mean(status == 1)),
        runtime=float(runtime),
        runtime_raw=float(t1 - t0),
        null_rtt=float(t2 - t1),
        ts=ts,
    )


@PickleJar.pickle(path="pf/closedloop")
def get_sim_summary(N_particles, dt_control, dt_predict, monte_carlo=0,
                    end_time=50, device="cuda"):
    """Run one closed-loop simulation with the PF; summarize its quality
    and runtime."""
    return sim_summary(N_particles, dt_control, dt_predict, monte_carlo,
                       end_time, True, device)


def utilization(summary, dt_control=DT_CONTROL):
    """Runtime over the real-time budget, ``dt_control * 60`` s a control
    period: ``runtime / (end_time * 60)``, one simulated time unit being
    one minute."""
    total_budget = summary["ts"][-1] * 60.0
    return summary["runtime"] / total_budget


@PickleJar.pickle(path="pf/closedloop_device")
def get_sim_summary_device(N_particles, dt_control, dt_predict,
                           monte_carlo=0, end_time=50, device="cuda"):
    """Device twin of :func:`get_sim_summary`: the loop of
    ``sim.loop.make_scan_loop`` with the PF."""
    return sim_summary_device(N_particles, dt_control, dt_predict,
                              monte_carlo, end_time, True, device)


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


def plot_frontier(frontier_fn, frontier_device_fn, summary_fn, log2s, xlabel,
                  name):
    """The three panels of either filter's frontier figure: ITSE and
    utilisation of the host shell and the device loop, and the host
    shell's covariance against time."""
    plt = pyplot()
    rows = frontier_fn(log2s)
    drows = frontier_device_fn(log2s)
    fig, axes = plt.subplots(1, 3, figsize=(18, 5))
    axes[0].semilogx(rows[:, 0], rows[:, 1], "k.-", label="host shell")
    axes[0].semilogx(drows[:, 0], drows[:, 1], "b.-", label="device loop")
    axes[0].set_xlabel(xlabel)
    axes[0].set_ylabel("ITSE")
    axes[0].legend(fontsize=8)
    axes[1].loglog(rows[:, 0], rows[:, 2], "k.-", label="host shell")
    axes[1].loglog(drows[:, 0], drows[:, 2], "b.-", label="device loop")
    axes[1].axhline(1.0, color="red")
    axes[1].legend(fontsize=8)
    axes[1].set_xlabel(xlabel)
    axes[1].set_ylabel("utilization")
    for log2 in log2s[:: max(1, len(log2s) // 4)]:
        n = int(2**log2)
        s = summary_fn(n, DT_CONTROL, DT_CONTROL, 0, 50)
        axes[2].semilogy(s["ts"], s["covariance_point_size"],
                         label=f"N=2^{int(log2)}")
    axes[2].set_xlabel("t (min)")
    axes[2].set_ylabel(r"max $\sigma$(cov)")
    axes[2].legend()
    return save_fig(name)


def plot(log2s=N_LOG2):
    return plot_frontier(frontier, frontier_device, get_sim_summary, log2s,
                         "N particles", "bioreactor_performance_pf.png")


if __name__ == "__main__":
    plot()
