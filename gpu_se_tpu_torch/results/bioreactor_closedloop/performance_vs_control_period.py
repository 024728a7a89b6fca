"""ITSE against the control period (20 periods x 5 Monte-Carlo runs).

Counterpart of the reference's
``results/bioreactor_closedloop/performance_vs_control_period.py``,
including its > 1e8 outlier filter: the plant on the host, the MPC's QP
and the noise draws on ``device``. :func:`plot` draws the sweep the
campaign's ``openloop`` leg writes on the card (``campaign.PERF_VS_CP``,
12 periods x 3 runs, the reference's own campaign reduction), reading
the card's memos; a missing one raises where this host has no card.
"""
import numpy as np

from gpu_se_tpu_torch import sim
from gpu_se_tpu_torch.results._common import (
    card_label,
    device_label,
    host_array,
    pyplot,
    save_fig,
)
from gpu_se_tpu_torch.utils import PickleJar


@PickleJar.pickle(path="bioreactor/perf_vs_cp/raw")
def get_simulation_performance(dt_control, monte_carlo, device="cuda"):
    """ITSE of one noisy closed-loop run at the given control period; the
    noise generators are seeded ``7 monte_carlo + 1`` and ``+ 2``."""
    device_label(device)
    end_time = 50
    ts = np.linspace(0, end_time, end_time * 20)
    dt = ts[1]
    assert dt <= dt_control

    bioreactor, lin_model, K, _ = sim.get_parts(dt_control=dt_control,
                                                device=device)
    state_pdf, measurement_pdf = sim.get_noise(device=device)
    state_pdf.generator.manual_seed(monte_carlo * 7 + 1)
    measurement_pdf.generator.manual_seed(monte_carlo * 7 + 2)

    us = [np.array([0.06, 0.2])]
    xs = [bioreactor.X.copy()]
    ys = [bioreactor.outputs(us[-1])]
    ys_meas = [bioreactor.outputs(us[-1])]

    t_next = 0.0
    for t in ts[1:]:
        if t > t_next:
            u_temp = us[-1].copy()
            try:
                u = K.step(
                    lin_model.xn2d(xs[-1]),
                    lin_model.un2d(us[-1]),
                    lin_model.yn2d(ys_meas[-1]),
                )
            except ValueError:
                u = np.array([0.06, 0.2]) - lin_model.u_bar
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
    return sim.performance(ys[:, lin_model.outputs], lin_model.yd2n(K.ysp), ts)


def sweep(n_periods=20, n_mc=5, device="cuda"):
    dt_controls = np.logspace(np.log10(0.1), np.log10(30), n_periods)
    table = np.full((n_periods, n_mc), np.nan)
    for i, dtc in enumerate(dt_controls):
        for mc in range(n_mc):
            table[i, mc] = get_simulation_performance(float(dtc), mc, device)
    return dt_controls, table


def plot(n_periods=None, n_mc=None):
    """The sweep's median ITSE and 10-90% band against the control
    period; ``n_periods`` and ``n_mc`` default to the campaign's
    ``PERF_VS_CP``."""
    from gpu_se_tpu_torch.results.campaign import PERF_VS_CP

    plt = pyplot()
    n_periods = PERF_VS_CP[0] if n_periods is None else n_periods
    n_mc = PERF_VS_CP[1] if n_mc is None else n_mc
    dt_controls, table = sweep(n_periods, n_mc)
    masked = np.where(table > 1e8, np.nan, table)
    med = np.nanmedian(masked, axis=1)
    lo = np.nanquantile(masked, 0.1, axis=1)
    hi = np.nanquantile(masked, 0.9, axis=1)
    plt.figure(figsize=(6.25, 5))
    plt.loglog(dt_controls, med, "k.-")
    plt.fill_between(dt_controls, lo, hi, alpha=0.3, color="grey")
    plt.xlabel("control period (min)")
    plt.ylabel("ITSE")
    plt.title(f"{card_label()}: {n_periods} periods x {n_mc} runs")
    return save_fig("performance_vs_control_period.png")


if __name__ == "__main__":
    plot()
