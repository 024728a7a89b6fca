"""The closed loop's records, judged step by step.

For each time step of an episode the program records the input it
applied, the plant's state after the step, the measurement, the filter's
point estimate and the solve's status; ``run.start`` drew the plant's
and the measurement's noise (one scalar each a step, added to every
coordinate), which the reference takes as given. From the program's own
records, step by step:

* the measurement: the plant's outputs plus the step's noise;
* the MPC: at every solved control event, the input of the exact float64
  solution (``reference/mpc.py``) for the program's estimate, last
  input and output bias (the bias from the reference's own last
  prediction); at every other event, the fallback input exactly;
* the plant: one Euler step from the last state under the applied
  input, plus the step's noise;
* the filter: the program does not hand out its particles, so the
  reference runs a float64 particle filter of its own, as large, over
  the same inputs and measurements; the root mean square, over the
  episode's steps, of the gap between the two estimates over the spread
  of the reference's particles must stay small, in the measured states
  (``estimate_rms_gap``) and apart in the unmeasured ones
  (``estimate_rms_gap_unmeasured``), where two sound filters part
  further through their own sampling: ``control="twin"`` puts a second
  reference filter, on its own stream, in the program's place, the
  witness of how far.
"""
from __future__ import annotations

import numpy as np
import torch

from port_bench.reference import pf as ref_pf
from port_bench.reference import plant


def check_episode(rec: dict, x_start, mpc_ref, cfg: dict, mix: dict,
                  dt: float, solved: int, seed: int, device,
                  control: str = "none") -> dict:
    """The numbers compared for one episode. With ``control="reduced"``
    each of the program's outputs is replaced by the control's: the
    reference's, its products from TF32 operands (the MPC, the filter's
    density) and its other float32 work rounded to bfloat16 (measurement,
    plant, the filter's particles and estimate: the reference filter
    on the same draws in bfloat16); with ``control="twin"`` the
    estimates are a second reference filter's, on its own draws."""
    reduced = control == "reduced"

    def bf(a):
        return np.asarray(ref_pf.round_bf16(torch.as_tensor(a)), dtype=float)

    m = cfg["mpc"]
    fallback = np.asarray(m["fallback_u"], dtype=np.float32).astype(float)
    us, xs, zs = rec["us"], rec["xs"], rec["zs"]
    xf, status, noise = rec["xs_f"], rec["status"], rec["noise"]
    states, inputs = mpc_ref.states, mpc_ref.inputs
    x_prev = np.asarray(x_start, dtype=np.float32).astype(float)
    u_prev = fallback
    have, y_pred = False, np.zeros(mpc_ref.No)
    out = {"plant_gap": 0.0, "measurement_gap": 0.0, "control_gap": 0.0,
           "fallback_misses": 0}
    u_inputs = []
    predict, control_mask = rec["predict"], rec["control"]
    for t in range(len(status)):
        u_inputs.append(u_prev)
        z_ref = np.asarray(plant.measure(x_prev)) + noise[t, 0]
        z_out = bf(z_ref) if reduced else zs[t]
        out["measurement_gap"] = max(out["measurement_gap"], float(np.max(
            np.abs(z_out - z_ref) / np.maximum(np.abs(z_ref), 1.0))))
        x0d = xf[t][states] - mpc_ref.x_bar
        um1 = u_prev[inputs] - mpc_ref.u_bar
        bias = (zs[t] - mpc_ref.y_bar) - y_pred if have \
            else np.zeros(mpc_ref.No)
        if not control_mask[t]:
            pass
        elif status[t] == solved:
            ctrl, y_new = mpc_ref.solve(x0d, um1, bias)
            applied = us[t][inputs]
            if reduced:
                applied = mpc_ref.solve(x0d, um1, bias,
                                        tf32_ops=True)[0] + mpc_ref.u_bar
            out["control_gap"] = max(out["control_gap"], float(np.max(
                np.abs(applied - (ctrl + mpc_ref.u_bar))
                / np.abs(mpc_ref.u_bar))))
            y_pred, have = y_new, True
        elif np.any(us[t] != fallback):
            out["fallback_misses"] += 1
        if not control_mask[t] and np.any(us[t] != u_prev):
            out["fallback_misses"] += 1
        x_ref = np.asarray(plant.euler(list(x_prev), list(us[t]), dt)) \
            + noise[t, 1]
        x_out = bf(x_ref) if reduced else xs[t]
        out["plant_gap"] = max(out["plant_gap"], float(np.max(
            np.abs(x_out - x_ref) / np.maximum(np.abs(x_ref), 1.0))))
        x_prev, u_prev = xs[t], us[t]
    gen = torch.Generator(device=device).manual_seed(seed)
    est, sd = ref_pf.filter_run(
        mix["state"].shifted(x_start), mix["state"], mix["measurement"],
        2 ** cfg["n_log2"], u_inputs, list(zs), dt, gen, device,
        predict=predict, control=control_mask)
    if reduced or control == "twin":
        est_out, _ = ref_pf.filter_run(
            mix["state"].shifted(x_start), mix["state"], mix["measurement"],
            2 ** cfg["n_log2"], u_inputs, list(zs), dt,
            torch.Generator(device=device).manual_seed(
                seed if reduced else seed + 1),
            device, predict=predict, control=control_mask, reduced=reduced)
    else:
        est_out = torch.as_tensor(xf, dtype=torch.float64, device=device)
    gap = (est_out - est).abs() / (sd + 1e-12)
    measured = list(plant.MEASURED)
    unmeasured = [k for k in range(gap.shape[1]) if k not in measured]
    out["estimate_rms_gap"] = float(gap[:, measured].pow(2).mean().sqrt())
    out["estimate_rms_gap_unmeasured"] = float(
        gap[:, unmeasured].pow(2).mean().sqrt())
    out["_estimate_gap_by_state"] = {
        "rms": [round(float(v), 4) for v in gap.pow(2).mean(0).sqrt()],
        "max": [round(float(v), 4) for v in gap.max(dim=0).values]}
    return out
