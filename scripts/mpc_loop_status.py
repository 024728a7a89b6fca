"""Per-step QP status of the no-noise closed loop
(``results/bioreactor_closedloop/no_noise.py``), for the JAX package or
its PyTorch port.

Each control step prints the solve's status, iterations and residuals
and whether ``K.step`` raised ``ValueError``; a raised step falls back to
the nominal input, as ``results/bioreactor_closedloop/mpc_run_seq.py``
does, so the loop runs on. The last line counts the raised and the
near-solved steps. The JAX package runs on the CPU; the port on
``--device``::

    python scripts/mpc_loop_status.py --package jax --dt-control 0.1
    python scripts/mpc_loop_status.py --package torch --device cuda
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--dt-control", type=float, default=0.1)
    ap.add_argument("--end-time", type=float, default=5.0)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    if args.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from gpu_se_tpu import sim
        from gpu_se_tpu.models import Bioreactor

        kw = {}
    else:
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        from gpu_se_tpu_torch import sim
        from gpu_se_tpu_torch.models import Bioreactor

        kw = {"device": args.device}
    t0 = time.perf_counter()
    _, lin, K, _ = sim.get_parts(dt_control=args.dt_control, N_particles=8,
                                 **kw)
    print(f"{args.package}: MPC P={K.P}, M={K.M}, setup "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    plant = Bioreactor(
        X0=Bioreactor.find_SS(np.array([0.06, 0.2]),
                              np.array([260 / 180, 640 / 24.6, 1000 / 116, 0, 0])),
        high_N=False)
    ts = np.linspace(0, args.end_time, int(args.end_time * 10))
    dt = ts[1]
    us, xs, ys = [np.array([0.06, 0.2])], [plant.X.copy()], [plant.outputs(None)]
    t_next, step, raised, near = 0.0, 0, 0, 0
    for t in ts[1:]:
        if t > t_next:
            t1 = time.perf_counter()
            try:
                u = K.step(lin.xn2d(xs[-1]), lin.un2d(us[-1]), lin.yn2d(ys[-1]))
                what = "ok"
            except ValueError:
                u = np.array([0.06, 0.2]) - lin.u_bar
                what = "raised"
                raised += 1
            sol = K.last_solution
            status = int(sol.status)
            near += what == "ok" and status == 0
            print(f"step {step}: {what}, status {status}, iterations "
                  f"{int(sol.iterations)}, prim {float(sol.prim_res):.3e}, dual "
                  f"{float(sol.dual_res):.3e}, {time.perf_counter() - t1:.3f} s",
                  flush=True)
            step += 1
            u_temp = us[-1].copy()
            u_temp[lin.inputs] = lin.ud2n(u)
            us.append(u_temp)
            t_next += args.dt_control
        else:
            us.append(us[-1])
        plant.step(dt, us[-1])
        ys.append(plant.outputs(us[-1]))
        xs.append(plant.X.copy())
    print(f"{args.package}: {step} steps, {raised} raised ValueError, {near} "
          f"accepted as near-solved")
    return 0


if __name__ == "__main__":
    sys.exit(main())
