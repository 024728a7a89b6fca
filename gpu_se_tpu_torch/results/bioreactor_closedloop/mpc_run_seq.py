"""MPC latency: closed-loop ``K.step`` times at dt_control = 0.1 (the
reference's P = 3000, M = 2000, which ``int(300 // 0.1)`` makes 2999 and
1999) as a run sequence with its pacf, and the device-side time of one
solve.

Counterpart of the reference's
``results/bioreactor_closedloop/mpc_run_seq.py``. Its device time is the
slope of a ``lax.scan`` of warm-started solves inside ``jax.jit``; here
:func:`device_solve_ms` chains ``k1`` and then ``k2`` calls of
``control.mpc.make_device_step``'s step on the card, each chain one CUDA
graph replay (``graphs.Graphed``: each solve's WHILE node inside it, no
read to the host) ended by one synchronise, and takes the slope.
``graphed=False`` times the chain as a Python loop of the solves' own
replays instead.
"""
import contextlib
import time

import numpy as np
import torch

from gpu_se_tpu_torch import graphs, sim
from gpu_se_tpu_torch.control import mpc as mpc_mod
from gpu_se_tpu_torch.results._common import pyplot, save_fig
from gpu_se_tpu_torch.utils import PickleJar, max_abs_pacf


@PickleJar.pickle(path="bioreactor/mpc_run_seq")
def mpc_run_seq(n_runs=1000, dt_control=0.1, device="cuda"):
    """Wall-clock seconds of ``n_runs`` warm-started closed-loop MPC
    solves, the host's latency of ``K.step``; a solve that raises falls
    back to ``u = [0.06, 0.2]`` and is timed all the same."""
    end_time = 50
    ts = np.linspace(0, end_time, int(end_time * 10))
    dt = ts[1]
    bioreactor, lin_model, K, _ = sim.get_parts(dt_control=dt_control,
                                                device=device)

    us = [np.array([0.06, 0.2])]
    xs = [bioreactor.X.copy()]
    ys = [bioreactor.outputs(us[-1])]

    times = []
    while len(times) < n_runs:
        for t in ts[1:]:
            u_temp = us[-1].copy()
            t0 = time.perf_counter()
            try:
                u = K.step(
                    lin_model.xn2d(xs[-1]),
                    lin_model.un2d(us[-1]),
                    lin_model.yn2d(ys[-1]),
                )
            except ValueError:
                u = np.array([0.06, 0.2]) - lin_model.u_bar
            times.append(time.perf_counter() - t0)
            u_temp[lin_model.inputs] = lin_model.ud2n(u)
            us.append(u_temp.copy())
            bioreactor.step(dt, us[-1])
            ys.append(bioreactor.outputs(us[-1]))
            xs.append(bioreactor.X.copy())
            if len(times) >= n_runs:
                break
    return np.array(times)


def device_solve_ms(dt_control=0.1, k1=2, k2=10, reps=3, device="cuda",
                    graphed=True):
    """Device-side ms per solve: the slope between chains of ``k1`` and
    ``k2`` warm-started solves of ``make_device_step``'s step, each chain
    from a fresh random ``x0`` and ended by one synchronise, median of
    ``reps`` chains after one warm-up. Each chain is one graph replay
    (its first call captures it, untimed), or with ``graphed=False`` a
    Python loop of solves. Returns ``(ms_per_solve,
    cold_start_admm_iterations)``."""
    _, _, K, _ = sim.get_parts(dt_control=dt_control, device=device)
    consts, step_fn = mpc_mod.make_device_step(K)
    dev = K.qp.device
    n_d = (K.M + 1) * K.Ni
    m_rows = int(K.qp.m)

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def make_chain(k):
        def chain(x0):
            um1, bias = zeros(K.Ni), zeros(K.No)
            wv, wy = zeros(n_d), zeros(m_rows)
            for i in range(k):
                ctrl, _y, sol = step_fn(consts, x0, um1, bias, wv, wy)
                x0 = x0 + 0.005 * torch.tanh(ctrl) + 1e-4 * i
                um1, wv, wy = ctrl, sol.x, sol.y
            return um1

        return graphs.Graphed(chain, copy_out=False)

    gen = torch.Generator().manual_seed(time.time_ns() % 2**31)

    def x0():
        return (0.05 * torch.randn(K.Nx, generator=gen)).to(dev)

    times = {}
    for k in (k1, k2):
        chain = make_chain(k)
        ts = []
        with (contextlib.nullcontext() if graphed
              else graphs.disabled(chain)):
            chain(x0())                      # the capture, untimed
            for _ in range(reps + 1):
                start = x0()
                sync()
                t0 = time.perf_counter()
                chain(start)
                sync()
                ts.append((time.perf_counter() - t0) * 1e3)
        times[k] = float(np.median(ts[1:]))
        chain.clear()
    ms = (times[k2] - times[k1]) / (k2 - k1)
    _, _, sol = step_fn(consts, torch.tensor([0.01, -0.01], device=dev),
                        zeros(K.Ni), zeros(K.No), zeros(n_d), zeros(m_rows))
    return ms, float(sol.iterations)


def plot(n_runs=1000):
    plt = pyplot()
    times = mpc_run_seq(n_runs)
    times = times[1:]  # drop the first, cold call
    print(f"median MPC solve (end-to-end K.step): {np.median(times) * 1000:.2f} ms")
    print(f"max |pacf|: {max_abs_pacf(times):.3f} (gate: < 0.2)")
    fig, axes = plt.subplots(1, 2, figsize=(12.5, 5))
    axes[0].plot(times * 1000, "k.", markersize=2)
    axes[0].set_xlabel("run")
    axes[0].set_ylabel("solve time (ms)")
    axes[1].plot(times[:-1] * 1000, times[1:] * 1000, "k.", markersize=2)
    axes[1].set_xlabel("run i (ms)")
    axes[1].set_ylabel("run i+1 (ms)")
    return save_fig("mpc_run_seq.png")


if __name__ == "__main__":
    plot()
