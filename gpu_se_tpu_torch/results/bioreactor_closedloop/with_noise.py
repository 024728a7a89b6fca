"""Closed-loop MPC with state and measurement noise injected into the
plant (no state estimator: raw measurements drive the controller).

Counterpart of the reference's
``results/bioreactor_closedloop/with_noise.py``, including its fallback
input ``[0.04, 0.1]`` where the solver raises. The noise is drawn on
``device`` from generators seeded ``seed + 31`` and ``seed + 41``.
:func:`trajectory` memoizes what :func:`simulate` returns, on the host
and labelled with the device; :func:`plot` reads the card's memo, and
raises where it is missing and this host has no card.
"""
import numpy as np

from gpu_se_tpu_torch import sim
from gpu_se_tpu_torch.results._common import (
    device_label,
    host_array,
    pyplot,
    save_fig,
)
from gpu_se_tpu_torch.utils import PickleJar


def simulate(end_time=50, dt_control=1, seed=0, device="cuda"):
    ts = np.linspace(0, end_time, end_time * 10)
    dt = ts[1]

    bioreactor, lin_model, K, _ = sim.get_parts(dt_control=dt_control,
                                                device=device)
    state_pdf, measurement_pdf = sim.get_noise(device=device)
    state_pdf.generator.manual_seed(seed + 31)
    measurement_pdf.generator.manual_seed(seed + 41)

    us = [np.array([0.06, 0.2])]
    xs = [bioreactor.X.copy()]
    ys = [bioreactor.outputs(us[-1])]
    ys_meas = [bioreactor.outputs(us[-1])]
    biass = []

    t_next = 0.0
    for t in ts[1:]:
        if t > t_next:
            u_temp = us[-1].copy()
            if K.y_predicted is not None:
                biass.append(lin_model.yn2d(ys_meas[-1]) - K.y_predicted)
            try:
                u = K.step(
                    lin_model.xn2d(xs[-1]),
                    lin_model.un2d(us[-1]),
                    lin_model.yn2d(ys_meas[-1]),
                )
            except ValueError:
                u = np.array([0.04, 0.1]) - lin_model.u_bar
            u_temp[lin_model.inputs] = lin_model.ud2n(u)
            us.append(u_temp.copy())
            t_next += dt_control
        else:
            us.append(us[-1])

        bioreactor.step(dt, us[-1])
        bioreactor.X = bioreactor.X + host_array(state_pdf.draw()).squeeze()
        outputs = bioreactor.outputs(us[-1])
        ys.append(outputs.copy())
        outputs = outputs.copy()
        outputs[lin_model.outputs] += host_array(measurement_pdf.draw()).squeeze()
        ys_meas.append(outputs)
        xs.append(bioreactor.X.copy())

    ys = np.array(ys)
    ys_meas = np.array(ys_meas)
    us = np.array(us)
    biass = np.array(biass)
    perf = sim.performance(ys[:, lin_model.outputs], lin_model.yd2n(K.ysp), ts)
    print("Performance: ", perf)
    return ts, ys, ys_meas, lin_model, K, us, dt_control, biass, end_time


@PickleJar.pickle(path="bioreactor/closedloop")
def noisy_trajectory(end_time=50, dt_control=1, seed=0, device="cuda"):
    """:func:`simulate`'s result as host arrays: ``ts``, ``ys``,
    ``ys_meas``, ``us``, ``biass``, the ``itse`` and the ``device``
    label."""
    label = device_label(device)
    ts, ys, ys_meas, lin_model, K, us, dt_control, biass, end_time = \
        simulate(end_time, dt_control, seed, device)
    return {"device": label, "ts": ts, "ys": ys, "ys_meas": ys_meas,
            "us": us, "biass": biass,
            "itse": float(sim.performance(ys[:, lin_model.outputs],
                                          lin_model.yd2n(K.ysp), ts)),
            "dt_control": dt_control, "end_time": end_time}


def plot():
    plt = pyplot()
    tr = noisy_trajectory()
    ts, ys, ys_meas, us = tr["ts"], tr["ys"], tr["ys_meas"], tr["us"]
    dt_control, biass, end_time = tr["dt_control"], tr["biass"], \
        tr["end_time"]
    fig, axes = plt.subplots(1, 3, figsize=(18.75, 5), gridspec_kw={"wspace": 0.3})
    axes[0].plot(ts, us[:, 1], "k")
    axes[0].plot(ts, us[:, 0], "k--")
    axes[0].set_title("Inputs")
    axes[1].plot(ts, ys_meas[:, 2], color="silver")
    axes[1].plot(ts, ys_meas[:, 0], color="silver")
    axes[1].plot(ts, ys[:, 2], "k")
    axes[1].plot(ts, ys[:, 0], "grey")
    axes[1].set_title("Outputs (mg/L)")
    axes[2].plot(np.arange(dt_control, end_time, dt_control), biass)
    axes[2].set_title("bias")
    fig.suptitle(tr["device"])
    return save_fig("with_noise.png")


if __name__ == "__main__":
    plot()
