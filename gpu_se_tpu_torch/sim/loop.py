"""The closed loop with its state on the device.

Counterpart of ``gpu_se_tpu/sim/loop.py``, whose loop is one jitted
``lax.scan``. Here it is a Python loop over the host's static event
masks (the reference's float timers evaluated over the time grid), which
take the place of the scan's ``lax.cond``s. The filter state, the plant,
the input, the prediction and the warm start stay on the device; the
choices that depend on the QP's status (the input, the prediction, the
warm-start reset, ``have_pred``) are ``torch.where``s. On the card each
time step is one replay of a CUDA graph (``gpu_se_tpu_torch.graphs``),
one for each pair of event masks and resample route, captured at the
first run: the predict, the measurement, the control event (update,
resample, point estimate and the MPC's solve, whose ADMM loop is a
conditional WHILE node inside the step's graph, ``control/qp.py``), the
``torch.where``s, the plant's Euler step and the point estimate. From
the first step to the last nothing is read back to the host.

``run.start`` and ``run.steps`` are the recorder's ``loop.start`` and
``loop.steps`` spans (``gpu_se_tpu_torch.trace``), and each step a
``loop.step`` span whose attribute is its event flags ``(predict,
control)``. On the card ``loop.start`` is a device span, and so is each
step's graphed call; ``loop.steps`` is a host span alone, so that the
card's idle time between two steps lies outside every device span.

The plant and measurement noise is drawn up front from the caller's
``torch.Generator``, one state draw and one measurement draw a step. As
in the reference, each step adds the first coordinate of its draw to
every coordinate (``draw(key, ())[0]`` is a scalar there).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from gpu_se_tpu_torch import graphs, trace
from gpu_se_tpu_torch.control import mpc as mpc_mod
from gpu_se_tpu_torch.control.qp import SOLVED
from gpu_se_tpu_torch.distributions.gaussian_sum import GaussianSum
from gpu_se_tpu_torch.filters import particle as pf_core
from gpu_se_tpu_torch.filters import resampling
from gpu_se_tpu_torch.models import bioreactor as bio


def event_masks(ts: np.ndarray, dt_control: float, dt_predict: float):
    """Replicate the reference timer logic over the time grid."""
    t_next_control, t_next_predict = 0.0, 0.0
    predict_mask = np.zeros(len(ts) - 1, dtype=bool)
    control_mask = np.zeros(len(ts) - 1, dtype=bool)
    for i, t in enumerate(ts[1:]):
        if t > t_next_predict:
            predict_mask[i] = True
            t_next_predict += dt_predict
        if t > t_next_control:
            control_mask[i] = True
            t_next_control += dt_control
    return predict_mask, control_mask


class LoopRecord(NamedTuple):
    us: torch.Tensor
    xs: torch.Tensor
    ys_meas: torch.Tensor
    xs_f: torch.Tensor
    status: torch.Tensor


def make_scan_loop(
    mpc,
    lin_model,
    state_pdf: GaussianSum,
    measurement_pdf: GaussianSum,
    end_time: float = 50.0,
    dt_control: float = 1.0,
    dt_predict: float = 0.1,
    fallback_u=np.array([0.06, 0.2]),
    filter_core=None,
):
    """Build ``run(filter_state, x_plant, generator) -> LoopRecord`` for
    the canonical rig, on the MPC's device.

    ``filter_core`` selects the estimator module
    (``gpu_se_tpu_torch.filters.particle`` by default, or
    ``gpu_se_tpu_torch.filters.gs_ukf``: both expose the same functional
    predict/update/resample/point_estimate surface). ``generator`` is a
    ``torch.Generator`` on that device: the plant and measurement noise.
    The records come back as stacked tensors, one row a step. ``run`` is
    ``run.steps(*run.start(filter_state, x_plant, generator))``: ``start``
    copies the plant's state to the device and draws the noise,
    ``steps`` runs the loop; ``run.graphs`` holds its graphed step
    (``gpu_se_tpu_torch.graphs``).
    """
    core = filter_core if filter_core is not None else pf_core

    ts = np.linspace(0, end_time, int(end_time * 10))
    dt = float(ts[1])
    predict_mask, control_mask = event_masks(ts, dt_control, dt_predict)
    flags = list(zip(predict_mask.tolist(), control_mask.tolist()))

    mpc_consts, mpc_step = mpc_mod.make_device_step(mpc)
    n_d = (mpc.M + 1) * mpc.Ni
    m_rows = mpc.qp.m
    device = mpc.qp.device

    def dev(v, dtype=torch.float32):
        return torch.as_tensor(np.asarray(v), dtype=dtype, device=device)

    f = bio.Bioreactor.homeostatic_DEs
    g = bio.Bioreactor.static_outputs
    out_idx = dev(lin_model.outputs, torch.long)
    in_idx = dev(lin_model.inputs, torch.long)
    state_sel = dev(lin_model.states, torch.long)
    x_bar = dev(lin_model.x_bar)
    u_bar = dev(lin_model.u_bar)
    y_bar = dev(lin_model.y_bar)
    fallback = dev(fallback_u)
    dt_t = dev(dt)
    solved = torch.tensor(SOLVED, dtype=torch.int32, device=device)
    state_pdf = state_pdf.to(device)
    measurement_pdf = measurement_pdf.to(device)

    # the filter's stream in each run: set to the caller's state's, so a
    # run leaves the caller's state as it was and two runs of one state
    # draw the same numbers (the reference's state holds an immutable
    # key); one generator for every run, so the graphs stay valid
    filter_gen = torch.Generator(device=device)

    def step(state, x, u, y_pred, have_pred, warm_v, warm_y, noise,
             predict: bool, control: bool):
        """One time step; ``noise`` holds its measurement and state noise.
        Returns the carry and the step's records."""
        # --- filter predict (every dt_predict) ---
        if predict:
            state = core.predict(state, u, dt_t, f, state_pdf)

        # --- measurement of the current plant output ---
        z = bio.all_outputs(x)[out_idx] + noise[0]

        # --- control event: update + resample + MPC ---
        status = solved
        if control:
            state = core.resample(core.update(state, u, z, g,
                                              measurement_pdf))
        x_f = core.point_estimate(state)
        if control:
            x0_dev = x_f[state_sel] - x_bar
            um1_dev = u[in_idx] - u_bar
            bias = torch.where(have_pred, (z - y_bar) - y_pred,
                               torch.zeros_like(y_pred))
            ctrl, y_pred_new, sol = mpc_step(
                mpc_consts, x0_dev, um1_dev, bias, warm_v, warm_y)
            ok = sol.status == SOLVED
            u = torch.where(ok, ctrl + u_bar, fallback)
            y_pred = torch.where(ok, y_pred_new, y_pred)
            warm_v = torch.where(ok, sol.x, torch.zeros_like(sol.x))
            warm_y = torch.where(ok, sol.y, torch.zeros_like(sol.y))
            have_pred = ok | have_pred
            status = sol.status

        # --- plant Euler step + state noise ---
        x = bio.euler_step(x, u, dt_t) + noise[1]
        return (state, x, u, y_pred, have_pred, warm_v, warm_y), (
            u, x, z, x_f, status)

    step_g = graphs.Graphed(step, key=resampling.route)

    def start(filter_state, x_plant, generator: torch.Generator):
        """The carry at t = 0 and every step's noise, ``(n_steps, 4)``
        (the measurement's and the state's draw in the first two columns:
        each row a whole 16 bytes, so every step's row is laid out
        alike)."""
        n_steps = len(ts) - 1
        with trace.span("loop.start", device):
            filter_gen.set_state(filter_state.generator.get_state())
            state = dataclasses.replace(filter_state, generator=filter_gen)
            noise = torch.zeros((n_steps, 4), dtype=torch.float32,
                                device=device)
            noise[:, 0] = measurement_pdf.draw(generator, (n_steps,))[:, 0]
            noise[:, 1] = state_pdf.draw(generator, (n_steps,))[:, 0]
            carry = (state, dev(x_plant), fallback.clone(),
                     torch.zeros(mpc.No, dtype=torch.float32, device=device),
                     torch.zeros((), dtype=torch.bool, device=device),
                     torch.zeros(n_d, dtype=torch.float32, device=device),
                     torch.zeros(m_rows, dtype=torch.float32, device=device))
        return carry, noise

    def steps(carry, noise) -> LoopRecord:
        """Every step from ``start``'s carry: one replay a step on the
        card, no read to the host."""
        rec = []
        with trace.span("loop.steps"):
            for i in range(len(ts) - 1):
                span = trace.begin("loop.step", flags[i])
                carry, out = step_g(*carry, noise[i], *flags[i])
                trace.end(span)
                rec.append(out)
            return LoopRecord(*(torch.stack(v) for v in zip(*rec)))

    def run(filter_state, x_plant, generator: torch.Generator) -> LoopRecord:
        return steps(*start(filter_state, x_plant, generator))

    run.start, run.steps = start, steps
    run.graphs = {"step": step_g}
    return run, ts
