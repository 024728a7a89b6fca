"""Open-loop transition between operating steady states, on the host.

Counterpart of the reference's ``results/bioreactor_openloop/ss2ss.py``:
u = [0.06, 0.2] until t = 400, then [0.04, 0.1].
"""
import numpy as np

from gpu_se_tpu_torch.results._common import (
    openloop_staged_run,
    pyplot,
    save_fig,
)


def simulate(end_time=1000):
    schedule = [
        (25.0, np.array([0.0, 0.0])),
        (400.0, np.array([0.06, 0.2])),
        (1000.0, np.array([0.04, 0.1])),
        (np.inf, np.array([0.04, 0.1])),
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
    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    axes[0].plot(ts, us)
    axes[0].set_title("Inputs (L/min)")
    axes[1].plot(ts, ys_meas[:, 0], "grey", label=r"$C_G$")
    axes[1].plot(ts, ys_meas[:, 2], "k", label=r"$C_{FA}$")
    axes[1].set_title("Measured outputs (mg/L)")
    axes[1].legend()
    for ax in axes:
        ax.set_xlabel("t (min)")
    return save_fig("ss2ss.png")


if __name__ == "__main__":
    plot()
