"""The port's two top-level entry points: the single-card step check and
the multi-rank dry run.

Counterpart of the reference's top-level entry module: ``entry()`` gives
the tiled particle-filter step (the main path of ``bench.py``) with
example arguments, and ``dryrun_multichip(n)`` runs every leg of the
reference's multi-device dry run once, at its own small shapes, on ``n``
ranks: the sharded closed-loop control step (sharded PF step, global
estimate, MPC solve), the sharded GSUKF step, the ``kernel``,
``a2a_ring`` and ``a2a_tiled_ring`` resample routes, the tiled-state
step and the consensus scenario step.

Both run on the card unless the caller passes ``device="cpu"``. The dry
run's ranks are processes of a gloo group (``parallel/launch.run_group``):
on one card they share it.
"""
from __future__ import annotations

import numpy as np
import torch

from gpu_se_tpu_torch.control import MPC, consensus_consts
from gpu_se_tpu_torch.distributions import GaussianSum
from gpu_se_tpu_torch.filters import gs_ukf as gsf
from gpu_se_tpu_torch.filters import particle as pf
from gpu_se_tpu_torch.filters import particle_tiled as pft
from gpu_se_tpu_torch.models import LinearModel
from gpu_se_tpu_torch.models import bioreactor as bio
from gpu_se_tpu_torch.parallel import (
    make_consensus_scenario_step,
    make_mesh,
    make_shard_map_gsukf_step,
    make_shard_map_step,
    make_shard_map_tiled_step,
    shard_gsukf_state,
    shard_pf_state,
    shard_tiled_pf_state,
)
from gpu_se_tpu_torch.parallel.control import make_sharded_control_step
from gpu_se_tpu_torch.parallel.launch import run_group
from gpu_se_tpu_torch.parallel.sharded import point_estimate

X_SS = np.array([280 / 180, 640 / 24.6, 1000 / 116, 0.0, 0.0])
U = (0.06, 0.2)
DT = 0.1
ENTRY_N = 4096
# the dry run's particles (Gaussians) a rank, leg by leg
DRY_N = 16
DRY_KERNEL_N = 128
DRY_TILED_N = 4096


def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


def toy_dists(device):
    """The reference's entry-point mixtures ``(x0, state_pdf, meas_pdf)``
    on ``device``: the initial cloud about the steady state, the state
    noise and the measurement noise."""
    x0 = GaussianSum.create(
        np.stack([X_SS, X_SS]),
        np.stack([np.eye(5) * 1e-4, np.eye(5) * 1e-3]),
        np.array([0.75, 0.25]), device=device)
    state_pdf = GaussianSum.create(
        np.zeros((2, 5)),
        np.stack([np.diag([1e-4, 1e-7, 1e-3, 1e-3, 1e-7]),
                  np.diag([1e-3, 1e-6, 1e-2, 1e-2, 1e-6])]),
        np.array([0.75, 0.25]), device=device)
    meas_pdf = GaussianSum.create(
        np.array([[1e-1, 0], [0, -1e-1]]),
        np.array([[[6e-2, 0], [0, 8e-2]], [[500, 100], [100, 700]]]),
        np.array([0.85, 0.15]), device=device)
    return x0, state_pdf, meas_pdf


def _inputs(device):
    """``(u, z)``: the input and the steady state's outputs, float32."""
    u = torch.tensor(U, dtype=torch.float32, device=device)
    z = bio.static_outputs(torch.from_numpy(X_SS)).to(torch.float32)
    return u, z.to(device)


def entry(device=None):
    """``(fn, (state, u, z))``: ``fn(state, u, z)`` is the tiled
    particle-filter step (``filters/particle_tiled.step``, dt = 0.1) on
    the bioreactor model with :func:`toy_dists`, and ``state`` holds
    4096 particles drawn from a generator seeded 0, on ``device`` (the
    card unless ``"cpu"``)."""
    dev = _device(device)
    x0, state_pdf, meas_pdf = toy_dists(dev)
    state = pft.init(torch.Generator(device=dev).manual_seed(0), ENTRY_N, x0)
    u, z = _inputs(dev)
    dt = torch.tensor(DT, device=dev)

    def fn(state, u, z):
        return pft.step(state, u, z, dt, bio.homeostatic_des,
                        bio.static_outputs, state_pdf, meas_pdf)

    return fn, (state, u, z)


def toy_control(device):
    """The dry run's ``(lin_model, mpc)``: a two-state linear model of
    the bioreactor's glucose and fumaric acid (states 0 and 2) and its
    MPC (P = 20, M = 8), on ``device``."""
    lin = LinearModel(
        A=np.array([[0.7, 0.0], [0.1, 0.9]]),
        B=np.array([[25.0, 0.1], [0.2, 8.0]]),
        C=np.eye(2) * np.array([180.0, 116.0]),
        D=np.zeros((2, 2)),
        dt=1.0,
        x_bar=X_SS[[0, 2]],
        u_bar=np.array([0.04, 0.1]),
        f_bar=np.zeros(2),
        y_bar=X_SS[[0, 2]] * np.array([180.0, 116.0]),
    )
    lin.states = [0, 2]          # its states' places in the full state
    mpc = MPC(P=20, M=8, Q=np.diag([0.1, 1.0]), R=np.diag([1.0, 1.0]),
              lin_model=lin, ysp=np.array([1.0, -1.0]),
              u_bounds=[np.array([0, np.inf]) - 0.04,
                        np.array([0, np.inf]) - 0.1], device=device)
    return lin, mpc


def _finite(name: str, t: torch.Tensor) -> None:
    if not torch.isfinite(t).all():
        raise AssertionError(f"dry run, {name}: non-finite")


def dryrun_rank(device):
    """Every leg of the dry run on this rank of the default group; returns
    ``(u, qp_status, scenario_status, ranks)``."""
    mesh = make_mesh(device=device)
    dev, w = mesh.device, mesh.size
    f, g = bio.homeostatic_des, bio.static_outputs
    x0, state_pdf, meas_pdf = toy_dists(dev)
    um1, z = _inputs(dev)
    dt = torch.tensor(DT, device=dev)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    # the closed-loop control step: sharded PF step, global estimate, MPC
    lin, mpc = toy_control(dev)
    control = make_sharded_control_step(mesh, mpc, lin, f, g, dt=DT)
    state = shard_pf_state(pf.init(gen(0), DRY_N * w, x0), mesh)
    n_d, m = (mpc.M + 1) * mpc.Ni, mpc.qp.m
    state, u, _, sol = control(
        state, um1, z, torch.zeros(2, device=dev),
        torch.zeros(n_d, device=dev), torch.zeros(m, device=dev),
        state_pdf, meas_pdf)
    _finite("control", u)
    _finite("control estimate", point_estimate(state, mesh))

    # the GSUKF step
    gs = shard_gsukf_state(gsf.init(gen(1), DRY_N * w, x0, state_pdf), mesh)
    gs = make_shard_map_gsukf_step(mesh, f, g)(gs, um1, z, dt, state_pdf,
                                               meas_pdf)
    _finite("GSUKF estimate", point_estimate(gs, mesh))

    # the kernel and survivor all-to-all routes of the flat step
    for route, n_rank in (("kernel", DRY_KERNEL_N), ("a2a_ring", DRY_KERNEL_N),
                          ("a2a_tiled_ring", DRY_TILED_N)):
        st = shard_pf_state(pf.init(gen(0), n_rank * w, x0), mesh)
        st = make_shard_map_step(mesh, f, g, resample_impl=route)(
            st, um1, z, dt, state_pdf, meas_pdf)
        _finite(f"{route} estimate", point_estimate(st, mesh))

    # the tiled-state step, two steps over the ring exchange
    ts_step = make_shard_map_tiled_step(mesh, f, g, exchange="ring")
    ts = shard_tiled_pf_state(pft.init(gen(2), DRY_TILED_N * w, x0), mesh)
    for _ in range(2):
        ts = ts_step(ts, um1, z, dt, state_pdf, meas_pdf)
    _finite("tiled estimate", point_estimate(ts, mesh))

    # the consensus scenario step over the ranks' scenarios
    consts, settings, dims = consensus_consts(
        lin, 10, 4, np.diag([0.1, 1.0]), np.eye(2), np.array([1.0, -1.0]),
        y_bounds=[np.array([-50.0, 50.0]), np.array([-50.0, 50.0])],
        device=dev)
    x0s = torch.tensor(np.random.default_rng(0).normal(
        scale=0.05, size=(2 * w, 2)), dtype=torch.float32, device=dev)
    sc_ctrl, _, sc_status = make_consensus_scenario_step(
        settings, dims, mesh, n_outer=10)(
        consts, x0s, torch.zeros(2, device=dev),
        torch.zeros((2 * w, 2), device=dev))
    _finite("scenario control", sc_ctrl)
    return (u.cpu().numpy(), int(sol.status), int(sc_status), w)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run every leg of the dry run (module docstring) once on
    ``n_devices`` ranks, each a process of a gloo group on ``device``
    (the card unless ``"cpu"``); every output must be finite and every
    rank's control the same. Prints one summary line."""
    outs = run_group(dryrun_rank, n_devices, device)
    u, status, sc_status, ranks = outs[0]
    for other in outs[1:]:
        if not np.array_equal(other[0].view(np.int32), u.view(np.int32)):
            raise AssertionError("dry run: the ranks' controls differ")
    print(f"dryrun_multichip({n_devices}): ok — u={u}, qp_status={status}, "
          f"gsukf_est_finite=True, scenario_status={sc_status}, "
          f"devices={ranks}", flush=True)
