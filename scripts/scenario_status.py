"""The scenario MPC at the canonical rig's width (dt_control = 1: P =
300, M = 200), for the JAX package or its PyTorch port: the inputs of
``chip_smoke.py``'s phase (f), ``gpu_se_tpu_torch/rig.py``'s scenarios
about the first step's ``x2d``.

It prints the stacked ``ScenarioMPC`` step (status, iterations,
control), each independent solve's status (the MPC's float32 ADMM at
1e-6 stops at max_iter on some rows), and the consensus step at
``n_outer`` outer iterations with ``consensus_consts``'s default
``rho_consensus`` and with the mean diagonal of the du_0 block's Schur
complement, each beside the stacked control. The JAX package runs on the
CPU; the port on ``--device``::

    python scripts/scenario_status.py --package jax --scenarios 4
    python scripts/scenario_status.py --package torch --device cuda
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpu_se_tpu_torch import rig  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--scenarios", type=int, default=rig.SCENARIOS)
    ap.add_argument("--n-outer", type=int, default=40)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    if args.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        import jax.numpy as xp
        from gpu_se_tpu import sim
        from gpu_se_tpu.control import scenario_mpc as smpc
        from gpu_se_tpu.parallel import scenario

        kw = {}

        def arr(a):
            return xp.asarray(np.asarray(a, np.float32))
    else:
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        from gpu_se_tpu_torch import sim
        from gpu_se_tpu_torch.control import scenario_mpc as smpc
        from gpu_se_tpu_torch.parallel import scenario

        kw = {"device": args.device}

        def arr(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=args.device)

    plant, lin, K, _ = sim.get_parts(dt_control=1, N_particles=8, **kw)
    x2d, um1 = lin.xn2d(plant.X), lin.un2d(np.array([0.06, 0.2]))
    S = args.scenarios
    x0s = x2d[None, :] + rig.scenario_offsets(S, x2d.shape[0])
    biases = np.zeros((S, lin.No))
    u_bounds = [np.array([0, np.inf]) - lin.u_bar[i] for i in range(2)]
    t0 = time.perf_counter()
    stacked = smpc.ScenarioMPC(K.P, K.M, K.Q, K.R, lin, K.ysp, n_scenarios=S,
                               u_bounds=u_bounds, **kw)
    setup_s = time.perf_counter() - t0
    ctrl = stacked.step(x0s, um1, biases)[0]
    sol = stacked.last_solution
    print(f"{args.package}: stacked S={S} n_D={stacked.n_D}, setup "
          f"{setup_s:.2f} s: status {int(sol.status)}, iterations "
          f"{int(sol.iterations)}, u {ctrl.tolist()}", flush=True)

    _, _, st = scenario.make_scenario_solver(K)(
        arr(x0s), arr(np.tile(um1, (S, 1))), arr(biases))
    st = np.asarray(st.cpu() if hasattr(st, "cpu") else st)
    print(f"{args.package}: independent solves, statuses {st.tolist()} "
          f"({int((st == 1).sum())} of {S} solved)", flush=True)

    P_dd = smpc.condense(lin, K.P, K.M, K.Q, K.R, K.ysp,
                         u_bounds=u_bounds).P_dd
    ni = lin.Ni
    schur = P_dd[:ni, :ni] - P_dd[:ni, ni:] @ np.linalg.solve(
        P_dd[ni:, ni:], P_dd[ni:, :ni])
    for name, rho in (("default", None),
                      ("Schur", float(np.trace(schur) / ni))):
        consts, settings, dims = smpc.consensus_consts(
            lin, K.P, K.M, K.Q, K.R, K.ysp, u_bounds=u_bounds,
            rho_consensus=rho, **kw)
        step = scenario.make_consensus_scenario_step(settings, dims,
                                                     n_outer=args.n_outer)
        cons, gap, worst = step(consts, arr(x0s), arr(um1), arr(biases))
        cons = np.asarray(cons.cpu() if hasattr(cons, "cpu") else cons,
                          float)
        print(f"{args.package}: consensus, {args.n_outer} outer, rho "
              f"{name} {float(consts['rho_c']):.6g}: u {cons.tolist()}, "
              f"gap {float(gap):.3e}, worst {int(worst)}; "
              f"{np.abs(cons - ctrl).max():.3e} from the stacked control",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
