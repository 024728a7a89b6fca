"""Input step-test grid: a 7 x 7 grid of scaled inputs and the largest
output slope, on the host.

Counterpart of the reference's ``results/bioreactor_openloop/step_tests.py``:
percents 0.5..1.5 on u = [0.06, 0.2], memoized runs, and the largest
C_G slope, used to choose the sampling period.
"""
import itertools

import numpy as np

from gpu_se_tpu_torch.results._common import canonical_plant, pyplot, save_fig
from gpu_se_tpu_torch.utils import PickleJar

PERCENTS = np.array([0.5, 0.7, 0.8, 1, 1.2, 1.3, 1.5])


@PickleJar.pickle(path="bioreactor")
def step_test(percent, dt):
    """Open-loop response of the canonical plant to a scaled constant
    input."""
    end_time = 300
    ts = np.linspace(0, end_time, int(end_time // dt))
    bioreactor = canonical_plant()
    u = np.array([0.06, 0.2]) * np.asarray(percent)
    ys = [bioreactor.outputs(u)]
    for _ in ts[1:]:
        bioreactor.step(ts[1], u)
        ys.append(bioreactor.outputs(u).copy())
    return ts, np.array(ys)


def max_slope(dt=0.1, percents=PERCENTS):
    """The largest |dC_G| / t over the step grid, and where."""
    best, arg = 0.0, None
    for p1, p2 in itertools.product(percents, percents):
        ts, ys = step_test((float(p1), float(p2)), dt)
        cg = ys[:, 0]
        cga = np.abs(cg - cg[0])
        i = int(np.argmax(cga))
        if ts[i] > 0:
            slope = cga[i] / ts[i]
            if slope > best:
                best, arg = slope, (p1, p2, ts[i])
    return best, arg


def plot(dt=0.1):
    plt = pyplot()
    fig, axes = plt.subplots(1, 2, sharey="row", figsize=(12.5, 5))
    for p1, p2 in itertools.product(PERCENTS, PERCENTS):
        ts, ys = step_test((float(p1), float(p2)), dt)
        axes[0].plot(ts, ys[:, 2])
        axes[1].plot(ts, ys[:, 0])
    axes[0].set_title(r"$C_{FA}$")
    axes[1].set_title(r"$C_G$")
    slope, arg = max_slope(dt)
    print("max |dCg|/t slope:", slope, "at", arg)
    return save_fig("step_tests.png")


if __name__ == "__main__":
    plot()
