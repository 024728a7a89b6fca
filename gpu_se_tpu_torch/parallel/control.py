"""The sharded closed-loop control step: a sharded filter step, the point
estimate of the whole population and the MPC's device solve.

Counterpart of the ``control_step`` that the reference's multi-device
dry run jits (its top-level entry module): the sharded PF step, the
psum-reduced point estimate, the selection ``x_hat[states] - x_bar`` and
the solve of ``control/mpc.make_device_step``, one program on every
device. Here every rank runs:

1. the sharded filter step on its slice (``parallel/sharded``: the flat
   PF, the GSUKF or the tiled PF, through the route the caller names);
2. :func:`~gpu_se_tpu_torch.parallel.sharded.point_estimate`, the
   estimate of the whole population, the same bits on every rank;
3. the selection ``x_hat[lin_model.states] - x_bar`` and ``um1[
   lin_model.inputs] - u_bar`` (as ``sim/loop`` selects them);
4. the float32 solve of :func:`~gpu_se_tpu_torch.control.mpc.
   make_device_step` on rank 0, whose control, prediction and solution
   (``x``, ``y``, ``z``, status, iterations, residuals) are broadcast to
   every rank as one float32 buffer, so every rank ends the step with
   the same bits. The reference solves on every device instead; on one
   card shared by two ranks the replicated solve doubles the QP's work,
   and rank 0's solve and broadcast measured faster there.

The step returns ``ctrl + u_bar`` whatever the solve's status, as the
reference's does; the caller reads ``sol.status``.

As the reference jits its control step, the step is one CUDA graph
replay a call wherever its filter step is graphed (``step.graphed``,
``parallel/sharded.graphable``: a mesh of one rank, and a route that
reads nothing on the host): the filter step, the global
estimate, the solve with its WHILE node (``control/qp``) and the
broadcast in one graph. Elsewhere it runs eagerly.
"""
from __future__ import annotations

import numpy as np
import torch

from gpu_se_tpu_torch import graphs
from gpu_se_tpu_torch.control.mpc import make_device_step
from gpu_se_tpu_torch.control.qp import QPSolution
from gpu_se_tpu_torch.filters.gs_ukf import GSUKFState
from gpu_se_tpu_torch.filters.particle import PFState
from gpu_se_tpu_torch.filters.particle_tiled import TiledPFState
from gpu_se_tpu_torch.parallel import _comm
from gpu_se_tpu_torch.parallel.mesh import Mesh
from gpu_se_tpu_torch.parallel.sharded import (
    make_shard_map_gsukf_step,
    make_shard_map_step,
    make_shard_map_tiled_step,
    point_estimate,
)

FILTERS = ("pf", "gsukf", "tiled")


def _filter_step(mesh: Mesh, f, g, filter: str, resample_impl):
    """The sharded step of ``filter`` through ``resample_impl`` (the
    tiled step's exchange), each factory's default where None."""
    route = {} if resample_impl is None else (
        {"exchange": resample_impl} if filter == "tiled"
        else {"resample_impl": resample_impl})
    if filter == "pf":
        return make_shard_map_step(mesh, f, g, **route)
    if filter == "gsukf":
        return make_shard_map_gsukf_step(mesh, f, g, **route)
    if filter == "tiled":
        return make_shard_map_tiled_step(mesh, f, g, **route)
    raise ValueError(f"unknown filter {filter!r}; one of {FILTERS}")


def make_sharded_control_step(mesh: Mesh, mpc, lin_model, f, g, *, dt,
                              filter: str = "pf", resample_impl=None):
    """``step(state, um1, z, bias, warm_v, warm_y, state_pdf,
    measurement_pdf) -> (state, u, y_pred, sol)`` on this rank's slice of
    ``state`` (a ``PFState``, ``GSUKFState`` or ``TiledPFState`` as
    ``filter`` says): the sharded filter step with input ``um1``,
    measurement ``z`` and time step ``dt``, then the MPC's solve at the
    global estimate on rank 0, broadcast (module docstring). ``mpc``'s
    constants must lie on the mesh's device. ``u`` is ``ctrl + u_bar``; ``warm_v`` and
    ``warm_y`` warm-start the solve (the last ``sol.x`` and ``sol.y``,
    or zeros).

    ``step.from_noise(state, um1, z, bias, warm_v, warm_y,
    measurement_pdf, noise, r)`` takes this rank's slice of the global
    noise and ``r`` instead, as the sharded steps' ``from_noise`` does,
    and keeps ``state``'s generator. ``step.graphed`` says whether the
    step is one graph replay a call (module docstring); ``from_noise``
    runs eagerly."""
    if mpc.qp.device != mesh.device:
        raise ValueError(f"the MPC's constants lie on {mpc.qp.device}, the "
                         f"mesh's rank on {mesh.device}")
    fstep = _filter_step(mesh, f, g, filter, resample_impl)
    consts, solve = make_device_step(mpc)

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=mesh.device)

    states, inputs = (dev(lin_model.states, torch.long),
                      dev(lin_model.inputs, torch.long))
    x_bar, u_bar = dev(lin_model.x_bar), dev(lin_model.u_bar)
    dt = torch.as_tensor(dt, dtype=torch.float32, device=mesh.device)
    n_d, m = (mpc.M + 1) * mpc.Ni, mpc.qp.m
    # ctrl, y_pred, x, y, z, status, iterations, prim_res, dual_res
    sizes = [mpc.Ni, mpc.No, n_d, m, m, 1, 1, 1, 1]

    def control(state, um1, bias, warm_v, warm_y):
        x_hat = point_estimate(state, mesh)
        if mesh.rank == 0:
            ctrl, y_pred, sol = solve(consts, x_hat[states] - x_bar,
                                      um1[inputs] - u_bar, bias, warm_v,
                                      warm_y)
            packed = torch.cat([t.reshape(-1).to(torch.float32) for t in (
                ctrl, y_pred, sol.x, sol.y, sol.z, sol.status,
                sol.iterations, sol.prim_res, sol.dual_res)])
        else:
            packed = x_hat.new_empty(sum(sizes))
        ctrl, y_pred, x, y, z, status, its, prim, dual = torch.split(
            _comm.broadcast(mesh, packed, 0), sizes)
        sol = QPSolution(x, y, z, status[0].to(torch.int32),
                         its[0].to(torch.int32), prim[0], dual[0])
        return state, ctrl + u_bar, y_pred, sol

    # the filter step's own function: a graph of the control step holds it
    filter_fn = fstep.fn if fstep.graphed else fstep

    def step(state, um1, z, bias, warm_v, warm_y, state_pdf,
             measurement_pdf):
        state = filter_fn(state, um1, z, dt, state_pdf, measurement_pdf)
        return control(state, um1, bias, warm_v, warm_y)

    def from_noise(state, um1, z, bias, warm_v, warm_y, measurement_pdf,
                   noise, r):
        args = (um1, z, dt, measurement_pdf, noise, r)
        gen = state.generator
        if filter == "pf":
            state = PFState(*fstep.from_noise(state.particles, state.weights,
                                              *args), gen)
        elif filter == "gsukf":
            (means, covs), weights = fstep.from_noise(
                state.means, state.covariances, state.weights, *args)
            state = GSUKFState(means, covs, weights, gen)
        else:
            state = TiledPFState(fstep.from_noise(state.x, *args), gen)
        return control(state, um1, bias, warm_v, warm_y)

    if fstep.graphed:
        step = graphs.Graphed(step)
    step.from_noise = from_noise
    step.graphed = fstep.graphed
    return step
