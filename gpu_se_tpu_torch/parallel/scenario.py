"""The scenario axis of the MPC, on one device or sharded over a mesh.

Counterpart of ``gpu_se_tpu/parallel/scenario.py``. Two entry points
over a batch of disturbance scenarios ``(x0, u_-1, bias)``:

* :func:`make_scenario_solver`: one independent QP per scenario row
  (Monte-Carlo evaluation, control-period sweeps), all rows in one
  batched ADMM solve;
* :func:`make_consensus_scenario_step`: the stochastic MPC, one shared
  first move du_0 over every scenario with per-scenario recourse and
  constraints, by consensus ADMM. Each outer iteration solves every
  scenario's proximal QP in one batched ADMM solve and averages the
  first moves; it converges to the stacked optimum of
  :class:`~gpu_se_tpu_torch.control.scenario_mpc.ScenarioMPC`.

With a :class:`~gpu_se_tpu_torch.parallel.mesh.Mesh`, both take the whole
batch on every rank and each rank solves its contiguous rows (the
scenario count must divide over the ranks). The solver all-gathers the
rows' results, so every rank returns the whole batch's; the consensus
step sums the first moves over the ranks with one all-reduce an outer
iteration, and reduces the last iteration's gap (a sum) and worst status
(a min) over them, as the reference's ``psum``/``pmin`` do. On a mesh
of one rank the collectives are the identity and the results equal
``mesh=None``'s bit for bit.
"""
from __future__ import annotations

import torch

from gpu_se_tpu_torch.control import mpc as mpc_mod
from gpu_se_tpu_torch.control.qp import _admm_solve, _f32_matmul
from gpu_se_tpu_torch.parallel import _comm
from gpu_se_tpu_torch.parallel.mesh import particle_sharding


def make_scenario_solver(mpc, mesh=None):
    """Return ``solve(x0s, um1s, biases) -> (ctrls, y_preds, statuses)``
    solving one independent QP per scenario row, each from a zero warm
    start, as one batched solve on the MPC's device (on a ``mesh``, of
    this rank's rows, the results all-gathered). Each row's result equals
    the single solve of :func:`make_device_step` on that row."""
    consts, step_fn = mpc_mod.make_device_step(mpc)
    n_d = (mpc.M + 1) * mpc.Ni
    m_rows = mpc.qp.m
    dt, device = mpc.qp.settings.dtype, mpc.qp.device

    def solve(x0s, um1s, biases):
        if mesh is not None:
            x0s, um1s, biases = (particle_sharding(mesh, a)
                                 for a in (x0s, um1s, biases))
        s = x0s.shape[0]
        warm_v = torch.zeros((s, n_d), dtype=dt, device=device)
        warm_y = torch.zeros((s, m_rows), dtype=dt, device=device)
        ctrl, y_pred, sol = step_fn(consts, x0s, um1s, biases, warm_v,
                                    warm_y)
        out = (ctrl, y_pred, sol.status)
        if mesh is None:
            return out
        return tuple(_comm.all_gather(mesh, t).reshape(
            (-1,) + tuple(t.shape[1:])) for t in out)

    return solve


def _consensus(c, x0s, um1, biases, *, settings, dims, n_outer, mesh):
    """The consensus-ADMM body over this rank's scenario rows (all of
    them without a ``mesh``): ``n_outer`` outer iterations, no early
    stop."""
    ni, n_d, m = dims["ni"], dims["n_d"], dims["m"]
    s_tot = x0s.shape[0]
    n_total = s_tot * (1 if mesh is None else mesh.size)

    def reduce_sum(t):
        return t if mesh is None else _comm.psum(mesh, t)

    # per-scenario condensed data (fixed across outer iterations)
    bias_terms = (c["k_vec"][None, :, None] * biases[:, None, :]).reshape(
        s_tot, -1)
    y_free = x0s @ c["F_x"].T + (c["F_u"] @ um1)[None, :] + bias_terms
    q_s = (y_free - c["ysp_tile"][None, :]) @ c["theta_t_q"].T  # (S, n_d)

    l_parts, u_parts = [], []
    if dims["has_y"]:
        l_parts.append(c["y_lo"][None, :] - y_free)
        u_parts.append(c["y_hi"][None, :] - y_free)
    if dims["has_du"]:
        l_parts.append(c["du_lo"].expand(s_tot, n_d))
        u_parts.append(c["du_hi"].expand(s_tot, n_d))
    if dims["has_u0"]:
        l_parts.append((c["u_lo"] - um1).expand(s_tot, ni))
        u_parts.append((c["u_hi"] - um1).expand(s_tot, ni))
    if l_parts:
        l = torch.cat(l_parts, dim=1)
        u = torch.cat(u_parts, dim=1)
    else:
        l = x0s.new_zeros((s_tot, 0))
        u = x0s.new_zeros((s_tot, 0))

    ctrl_rows = c["L_invT"][:ni]  # d0 = ctrl_rows @ w
    zbar = x0s.new_zeros(ni)
    lam = x0s.new_zeros((s_tot, ni))
    warm_w = x0s.new_zeros((s_tot, n_d))
    warm_y = x0s.new_zeros((s_tot, m))
    for _ in range(n_outer):
        v = zbar[None, :] - lam  # (S, ni) proximal targets
        q_eff = q_s.clone()
        q_eff[:, :ni] += -c["rho_c"] * v
        q_w = q_eff @ c["L_inv"].T
        sols = _admm_solve(c["qp"], q_w, l, u, warm_w, warm_y, settings)
        d0 = sols.x @ ctrl_rows.T  # (S, ni)
        zbar = reduce_sum(torch.sum(d0 + lam, dim=0)) / n_total
        lam = lam + d0 - zbar[None, :]
        warm_w, warm_y = sols.x, sols.y
    # the last iteration's consensus residual and worst status, over
    # every rank's scenarios
    gap = reduce_sum(torch.amax(torch.abs(d0 - zbar[None, :]), dim=1).sum())
    worst = torch.min(sols.status)
    if mesh is not None:
        worst = _comm.pmin(mesh, worst)
    return zbar + um1, gap, worst


def make_consensus_scenario_step(settings, dims, mesh=None, n_outer: int = 40):
    """Build the consensus scenario-MPC step.

    ``settings`` and ``dims`` come from
    :func:`~gpu_se_tpu_torch.control.scenario_mpc.consensus_consts`.
    Returns ``step(consts, x0s, um1, biases) -> (ctrl, gap, worst_status)``,
    device tensors: ``gap`` the last outer iteration's consensus residual
    ``sum_s max|du_0^s - mean|``, ``worst_status`` the minimum inner QP
    status over the scenarios in that iteration (SOLVED = 1), both over
    every rank's scenarios on a ``mesh``, where ``x0s`` and ``biases``
    hold the whole batch and each rank solves its rows. Every product
    runs with TF32 off: in lower precision the consensus gap stops near
    1e-2.
    """
    def step(consts, x0s, um1, biases):
        if mesh is not None:
            x0s, biases = (particle_sharding(mesh, a) for a in (x0s, biases))
        with _f32_matmul(), torch.no_grad():
            return _consensus(consts, x0s, um1, biases, settings=settings,
                              dims=dims, n_outer=n_outer, mesh=mesh)

    return step
