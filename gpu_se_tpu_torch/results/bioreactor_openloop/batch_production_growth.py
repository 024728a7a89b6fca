"""Open-loop staged batch -> growth -> production run, on the host.

Counterpart of the reference's
``results/bioreactor_openloop/batch_production_growth.py``: the batch
phase (< 25 min, high N, no feed), then low-N production with two feed
increases at t = 200 and t = 500, with plant and measurement noise.
"""
import numpy as np

from gpu_se_tpu_torch.results._common import (
    openloop_staged_run,
    pyplot,
    save_fig,
)


def simulate(end_time=800):
    schedule = [
        (25.0, np.array([0.0, 0.0])),
        (200.0, np.array([0.03, 0.0])),
        (500.0, np.array([0.058, 0.0])),
        (np.inf, np.array([0.074, 0.0])),
    ]
    return openloop_staged_run(
        end_time=end_time,
        schedule=schedule,
        X0=[3000 / 180, 1 / 24.6, 0.0, 0.0, 0.0],
        noisy=True,
        high_N=True,
    )


def plot():
    plt = pyplot()
    ts, us, xs, ys, ys_meas = simulate()
    fig, axes = plt.subplots(1, 3, figsize=(18, 5))
    axes[0].plot(ts, us[:, 0], "k", label=r"$F_{G,in}$")
    axes[0].plot(ts, us[:, 1], "k--", label=r"$F_{M,in}$")
    axes[0].set_title("Inputs")
    axes[0].legend()
    axes[1].plot(ts, ys[:, 0], "grey", label=r"$C_G$")
    axes[1].plot(ts, ys[:, 2], "k", label=r"$C_{FA}$")
    axes[1].plot(ts, ys[:, 3], "k--", label=r"$C_E$")
    axes[1].set_title("Outputs (mg/L)")
    axes[1].legend()
    axes[2].plot(ts, ys_meas[:, 0], "grey", alpha=0.6)
    axes[2].plot(ts, ys_meas[:, 2], "k", alpha=0.6)
    axes[2].set_title("Measured outputs")
    for ax in axes:
        ax.set_xlabel("t (min)")
    return save_fig("batch_production_growth.png")


if __name__ == "__main__":
    plot()
