"""Deterministic closed-loop MPC (no filter, no noise): the plant on the
host, the MPC's QP on ``device``.

Counterpart of the reference's ``results/bioreactor_closedloop/no_noise.py``.
:func:`trajectory` memoizes what :func:`simulate` returns, on the host
and labelled with the device; :func:`plot` reads the card's memo, and
raises where it is missing and this host has no card.
"""
import numpy as np

from gpu_se_tpu_torch import sim
from gpu_se_tpu_torch.results._common import device_label, pyplot, save_fig
from gpu_se_tpu_torch.utils import PickleJar


def simulate(end_time=50, dt_control=1, device="cuda"):
    ts = np.linspace(0, end_time, end_time * 10)
    dt = ts[1]
    assert dt <= dt_control

    bioreactor, lin_model, K, _ = sim.get_parts(dt_control=dt_control,
                                                device=device)

    us = [np.array([0.06, 0.2])]
    xs = [bioreactor.X.copy()]
    ys = [bioreactor.outputs(us[-1])]
    biass = []

    t_next = 0.0
    for t in ts[1:]:
        if t > t_next:
            u_temp = us[-1].copy()
            if K.y_predicted is not None:
                biass.append(lin_model.yn2d(ys[-1]) - K.y_predicted)
            u = K.step(
                lin_model.xn2d(xs[-1]), lin_model.un2d(us[-1]), lin_model.yn2d(ys[-1])
            )
            u_temp[lin_model.inputs] = lin_model.ud2n(u)
            us.append(u_temp.copy())
            t_next += dt_control
        else:
            us.append(us[-1])
        bioreactor.step(dt, us[-1])
        ys.append(bioreactor.outputs(us[-1]))
        xs.append(bioreactor.X.copy())

    ys = np.array(ys)
    us = np.array(us)
    biass = np.array(biass)
    perf = sim.performance(ys[:, lin_model.outputs], lin_model.yd2n(K.ysp), ts)
    print("Performance: ", perf)
    return ts, ys, lin_model, K, us, dt_control, biass, end_time


@PickleJar.pickle(path="bioreactor/closedloop")
def trajectory(end_time=50, dt_control=1, device="cuda"):
    """:func:`simulate`'s result as host arrays: ``ts``, ``ys``, ``us``,
    ``biass``, the set point in natural units ``ysp``, the model's
    ``inputs`` and ``outputs``, the ``itse`` and the ``device`` label."""
    label = device_label(device)
    ts, ys, lin_model, K, us, dt_control, biass, end_time = simulate(
        end_time, dt_control, device)
    return {"device": label, "ts": ts, "ys": ys, "us": us, "biass": biass,
            "ysp": lin_model.yd2n(K.ysp),
            "inputs": list(lin_model.inputs),
            "outputs": list(lin_model.outputs),
            "itse": float(sim.performance(ys[:, lin_model.outputs],
                                          lin_model.yd2n(K.ysp), ts)),
            "dt_control": dt_control, "end_time": end_time}


def plot():
    plt = pyplot()
    tr = trajectory()
    ts, ys, us, biass = tr["ts"], tr["ys"], tr["us"], tr["biass"]
    dt_control, end_time = tr["dt_control"], tr["end_time"]
    fig, axes = plt.subplots(1, 3, figsize=(18.75, 5), gridspec_kw={"wspace": 0.3})
    axes[0].plot(ts, us[:, tr["inputs"][1]], "k")
    axes[0].plot(ts, us[:, tr["inputs"][0]], "k--")
    axes[0].set_title("Inputs")
    axes[0].legend([r"$F_{m,in}$", r"$F_{G,in}$"])
    axes[1].plot(ts, ys[:, 2], "k")
    axes[1].plot(ts, ys[:, 0], "grey")
    axes[1].plot(ts, ys[:, 3], "k--")
    ysp_nat = tr["ysp"]
    axes[1].axhline(ysp_nat[0], color="red", alpha=0.5)
    axes[1].axhline(ysp_nat[1], color="red", alpha=0.5)
    axes[1].set_title("Outputs (mg/L)")
    axes[2].plot(np.arange(dt_control, end_time, dt_control), biass)
    axes[2].set_title("bias")
    for ax in axes:
        ax.set_xlabel("t (min)")
    fig.suptitle(tr["device"])
    return save_fig("no_noise.png")


if __name__ == "__main__":
    plot()
