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
* the filter: the program does not hand out its filter's state, so the
  reference runs a float64 filter of its own of the estimator the
  configuration names, as large, over the same inputs and measurements
  (the ``loop_filter`` of ``estimators/<estimator>.py``); the root mean
  square, over the episode's steps, of the gap between the two estimates
  over the spread of the reference filter's state must stay small, in
  the measured states (``estimate_rms_gap``) and apart in the unmeasured
  ones (``estimate_rms_gap_unmeasured``), where two sound filters part
  further through their own sampling: ``control="twin"`` puts a second
  reference filter, on its own stream, in the program's place, the
  witness of how far;
* the filter's weights, where the estimator's module reads the
  program's bank (``bank_survivors``: the GSUKF, whose local updates
  carry the estimate whatever the weights): the share of the bank that
  each control event's resample kept, in the record's ``survivors``,
  against the reference filter's at the same event
  (``survivor_share_gap``, the mean gap over the episode's control
  events: the sound program's float32 weights lose a tenth of the bank
  at a few events, a weight left out loses it at every one).
"""
from __future__ import annotations

import numpy as np
import torch

from port_bench.reference import pf as ref_pf
from port_bench.reference import plant


def worse(a, b):
    """The larger of two readings; NaN where either is NaN (``max``
    would keep a NaN only in its first place)."""
    return a + b if a != a or b != b else max(a, b)


def check_episode(rec: dict, x_start, mpc_ref, cfg: dict, mix: dict,
                  dt: float, solved: int, seed: int, device, loop_filter,
                  control: str = "none") -> dict:
    """The numbers compared for one episode; ``loop_filter`` is the
    float64 reference filter of the configuration's estimator
    (``estimators/<estimator>.py``: ``filter_run`` of ``reference/pf.py``
    or ``reference/ukf.py``). With ``control="reduced"`` each of
    the program's outputs is replaced by the control's: the reference's,
    its products from TF32 operands (the MPC, the filter's density) and
    its other float32 work rounded to bfloat16 (measurement, plant, the
    filter's state and estimate: the reference filter on the same draws
    in bfloat16); with ``control="twin"`` the estimates are a second
    reference filter's, on its own draws."""
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
        out["measurement_gap"] = worse(out["measurement_gap"], float(np.max(
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
            out["control_gap"] = worse(out["control_gap"], float(np.max(
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
        out["plant_gap"] = worse(out["plant_gap"], float(np.max(
            np.abs(x_out - x_ref) / np.maximum(np.abs(x_ref), 1.0))))
        x_prev, u_prev = xs[t], us[t]

    bank = rec.get("survivors")

    def reference(mode, survivors):
        gen = torch.Generator(device=device).manual_seed(
            seed + 1 if mode == "twin" else seed)
        kept = {} if bank is None else {"survivors": survivors}
        return loop_filter(
            mix["state"].shifted(x_start), mix["state"], mix["measurement"],
            2 ** cfg["n_log2"], u_inputs, list(zs), dt, gen, device,
            predict=predict, control=control_mask, reduced=mode == "reduced",
            **kept)

    kept_ref, kept_out = [], []
    est, sd = reference("none", kept_ref)
    if reduced or control == "twin":
        est_out, _ = reference(control, kept_out)
    else:
        est_out = torch.as_tensor(xf, dtype=torch.float64, device=device)
        kept_out = bank
    if bank is not None:
        out["survivor_share_gap"] = float(np.mean(np.abs(
            np.asarray(kept_out, dtype=float)
            - np.asarray(kept_ref, dtype=float))))
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
