"""What each rank runs in the port's multi-device tests.

The ranks are processes spawned by ``gpu_se_tpu_torch.parallel.launch``
(``run_group``), which import this module: it imports no JAX. Each
function takes the global inputs as numpy arrays, builds this rank's
mesh on the CPU, computes and returns this rank's slices as numpy; the
test concatenates them in rank order. On a mesh of one process (no
group started) the same function is the width-1 run.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from gpu_se_tpu_torch import convert
from gpu_se_tpu_torch.control import MPC, consensus_consts
from gpu_se_tpu_torch.filters import gs_ukf as gsf
from gpu_se_tpu_torch.filters import particle as pf
from gpu_se_tpu_torch.filters import particle_tiled as pft
from gpu_se_tpu_torch.models import LinearModel
from gpu_se_tpu_torch.models import bioreactor as bio
from gpu_se_tpu_torch.parallel import (
    global_mesh,
    make_auto_sharded_gsukf_step,
    make_auto_sharded_step,
    make_consensus_scenario_step,
    make_mesh,
    make_scenario_solver,
    make_shard_map_gsukf_step,
    make_shard_map_step,
    make_shard_map_tiled_step,
    particle_sharding,
    shard_gsukf_state,
    shard_pf_state,
    shard_tiled_pf_state,
)
from gpu_se_tpu_torch.parallel import sharded as S
from gpu_se_tpu_torch.parallel.control import make_sharded_control_step
from gpu_se_tpu_torch.results.sharded_steps import counted_draws

F, G = bio.homeostatic_des, bio.static_outputs


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.detach().cpu().numpy()


def _gs(fields):
    return convert.gaussian_sum_from_numpy(*fields, device="cpu")


@contextlib.contextmanager
def injected_ends(mesh, ends_global):
    """``S._segmented_ends`` returns this rank's slice of ``ends_global``
    and the entry before it (``-1`` on rank 0) while the block runs."""
    n_local = len(ends_global) // mesh.size
    slot0 = mesh.rank * n_local
    ends = _t(ends_global[slot0:slot0 + n_local].astype(np.int32))
    prev = torch.tensor(int(ends_global[slot0 - 1]) if slot0 else -1,
                        dtype=torch.int32)
    real = S._segmented_ends
    S._segmented_ends = lambda weights, r, mesh_: (ends, prev)
    try:
        yield
    finally:
        S._segmented_ends = real


def _bank(payload):
    """``(means (n, 5), covariances (n, 5, 5))`` of a ``(n, 30)`` array."""
    return payload[:, :5], payload[:, 5:].reshape(-1, 5, 5)


def sharding_suite(d):
    """Every check of ``tests/test_torch_sharding.py`` on this rank."""
    mesh = make_mesh(device="cpu")
    rows = lambda a, dim=0: particle_sharding(mesh, a, dim)  # noqa: E731
    r = torch.tensor(d["r"], dtype=torch.float32)
    out = {"ends": {}, "prev": {}, "routes": {}, "gsukf_routes": {},
           "pin": {}}

    # the port's own segmented ends, then every route at the
    # reference's ends
    for fam, w in d["weights"].items():
        ends, prev = S._segmented_ends(rows(w), r, mesh)
        out["ends"][fam], out["prev"][fam] = _np(ends), int(prev)
        out["routes"][fam] = {}
        with injected_ends(mesh, d["ref_ends"][fam]):
            for name, route in S._FLAT_ROUTES.items():
                got, weights = S._resample(rows(d["parts"]), rows(w), r,
                                           mesh, route)
                assert torch.equal(weights, torch.full_like(
                    weights, 1.0 / len(w)))
                out["routes"][fam][name] = _np(got)
    fam = d["bank_family"]
    with injected_ends(mesh, d["ref_ends"][fam]):
        for name, route in S._GSUKF_ROUTES.items():
            (m, c), _ = S._resample(_bank(rows(d["bank"])),
                                    rows(d["weights"][fam]), r, mesh, route)
            out["gsukf_routes"][name] = (_np(m), _np(c))
        # -0.0, infinities and NaNs are copied as they are
        for name, route in S._FLAT_ROUTES.items():
            got, _ = S._resample(rows(d["odd_parts"]),
                                 rows(d["weights"][fam]), r, mesh, route)
            out["pin"][name] = _np(got).view(np.int32)

    # the steps given the reference's noise and r
    meas = _gs(d["meas"])
    u, z, dt = _t(d["u"]), _t(d["z"]), _t(d["dt"])
    step_r = torch.tensor(d["step_r"], dtype=torch.float32)
    out["flat_step"] = {}
    for name in S._FLAT_ROUTES:
        step = make_shard_map_step(mesh, F, G, resample_impl=name)
        got, _ = step.from_noise(rows(d["step_x"]), rows(d["step_w"]), u, z,
                                 dt, meas, rows(d["step_noise"]), step_r)
        out["flat_step"][name] = _np(got)
    g_r = torch.tensor(d["gsukf_r"], dtype=torch.float32)
    bank = shard_gsukf_state(convert.gsukf_state_from_numpy(
        d["g_means"], d["g_covs"], d["g_weights"], torch.Generator()), mesh)
    out["gsukf_step"] = {}
    for name in S._GSUKF_ROUTES:
        step = make_shard_map_gsukf_step(mesh, F, G, resample_impl=name)
        (m, c), _ = step.from_noise(
            bank.means, bank.covariances, bank.weights, u, z, dt, meas,
            rows(d["g_noise"], 2), g_r)
        out["gsukf_step"][name] = (_np(m), _np(c))

    # the entry points' own steps from a seeded generator, and the
    # counter draws each rank made
    x0, state_pdf = _gs(d["x0"]), _gs(d["state_pdf"])
    out["step"], out["gsukf_own_step"], out["draws"] = {}, {}, {}
    for name in S._FLAT_ROUTES:
        state = shard_pf_state(convert.pf_state_from_numpy(
            d["step_x"], d["step_w"],
            torch.Generator().manual_seed(d["seed"])), mesh)
        with counted_draws() as draws:
            got = make_shard_map_step(mesh, F, G, resample_impl=name)(
                state, u, z, dt, state_pdf, meas)
        out["step"][name] = (_np(got.particles), _np(got.weights))
        out["draws"]["flat " + name] = [draws]
    for name in S._GSUKF_ROUTES:
        bank = shard_gsukf_state(convert.gsukf_state_from_numpy(
            d["g_means"], d["g_covs"], d["g_weights"],
            torch.Generator().manual_seed(d["seed"])), mesh)
        with counted_draws() as draws:
            got = make_shard_map_gsukf_step(mesh, F, G, resample_impl=name)(
                bank, u, z, dt, state_pdf, meas)
        out["gsukf_own_step"][name] = (_np(got.means), _np(got.covariances))
        out["draws"]["gsukf " + name] = [draws]

    # the auto-sharded steps from a seeded state
    state = pf.init(torch.Generator().manual_seed(d["seed"]), d["n_auto"], x0)
    got = make_auto_sharded_step(mesh, F, G)(
        shard_pf_state(state, mesh), u, z, dt, state_pdf, meas)
    out["auto"] = (_np(got.particles), _np(got.weights))
    g_state = gsf.init(torch.Generator().manual_seed(d["seed"]),
                       d["n_auto_gsukf"], x0, state_pdf)
    got = make_auto_sharded_gsukf_step(mesh, F, G)(
        shard_gsukf_state(g_state, mesh), u, z, dt, state_pdf, meas)
    out["auto_gsukf"] = (_np(got.means), _np(got.covariances))

    # the scenario axis
    sc = d["scenario"]
    lin = LinearModel(*sc["model"], 1.0, np.zeros(2), np.zeros(2),
                      np.zeros(2), np.zeros(2))
    K = MPC(10, 4, sc["Q"], sc["R"], lin, sc["ysp"],
            u_bounds=sc["u_bounds"], device="cpu")
    out["solver"] = tuple(_np(t) for t in make_scenario_solver(K, mesh)(
        _t(sc["x0s"]), _t(sc["um1s"]), _t(sc["biases"])))
    cs = d["consensus"]
    lin_b = LinearModel(*cs["model"], 1.0, np.zeros(2), np.zeros(2),
                        np.zeros(2), np.zeros(2))
    consts, settings, dims = consensus_consts(
        lin_b, cs["P"], cs["M"], cs["Q"], cs["R"], cs["ysp"],
        y_bounds=cs["y_bounds"], device="cpu")
    out["consensus"] = tuple(_np(t) for t in make_consensus_scenario_step(
        settings, dims, mesh, n_outer=40)(
        consts, _t(cs["x0s"]), _t(cs["um1"]), _t(cs["biases"])))
    return out


def tiled_suite(d):
    """Every check of ``tests/test_torch_tiled_sharded.py`` on this
    rank: the tiled resample at the port's own and at the reference's
    ``ends``, with both exchanges, then chained steps."""
    mesh = make_mesh(device="cpu")
    x = shard_tiled_pf_state(convert.tiled_state_from_numpy(
        d["tiled"], 5, torch.Generator()), mesh).x
    w = particle_sharding(mesh, d["w"])
    r = torch.tensor(d["r"], dtype=torch.float32)
    out = {}
    for exchange in ("ragged", "ring"):
        ends, prev = S._segmented_ends(w, r, mesh)
        out[exchange] = _np(S._a2a_compact_exchange_merge(
            x, ends, prev, mesh, exchange))
        with injected_ends(mesh, d["ref_ends"]):
            ends, prev = S._segmented_ends(w, r, mesh)
            out[exchange + "_ref_ends"] = _np(S._a2a_compact_exchange_merge(
                x, ends, prev, mesh, exchange))
    out["xla"] = _np(S._distributed_systematic_resample(
        x.T.contiguous(), w, r, mesh)[0])

    x0, state_pdf, meas = (_gs(d[k]) for k in ("x0", "state_pdf", "meas"))
    u, z, dt = _t(d["u"]), _t(d["z"]), _t(d["dt"])
    for exchange in ("ragged", "ring"):
        state = pft.init(torch.Generator().manual_seed(d["seed"]), d["n"], x0)
        state = shard_tiled_pf_state(state, mesh)
        step = make_shard_map_tiled_step(mesh, F, G, exchange=exchange)
        for _ in range(d["steps"]):
            state = step(state, u, z, dt, state_pdf, meas)
        out["chain_" + exchange] = _np(state.x)
    return out


def multihost_step(d):
    """One sharded flat step over the default group (started by
    ``initialize_distributed`` at a TCP address): this rank's particles
    and the point estimate of the gathered population."""
    mesh = global_mesh(device="cpu")
    gen = torch.Generator().manual_seed(d["seed"])
    state = shard_pf_state(
        convert.pf_state_from_numpy(d["parts"], d["weights"], gen), mesh)
    out = make_shard_map_step(mesh, F, G)(
        state, _t(d["u"]), _t(d["z"]), _t(d["dt"]), _gs(d["state_pdf"]),
        _gs(d["meas"]))
    full = S._gathered(mesh, out.particles)
    est = pf.point_estimate(pf.PFState(full, S._gathered(mesh, out.weights),
                                       None))
    return _np(out.particles), _np(est), mesh.size, mesh.rank


def _moment_state(mesh, case):
    """This rank's slice of one moments case (``kind`` "pf", "gsukf" or
    "tiled")."""
    rows = lambda a, dim=0: particle_sharding(mesh, a, dim)  # noqa: E731
    if case["kind"] == "pf":
        return pf.PFState(rows(case["x"]), rows(case["w"]), None)
    if case["kind"] == "gsukf":
        return gsf.GSUKFState(rows(case["x"]), rows(case["covs"]),
                              rows(case["w"]), None)
    return pft.TiledPFState(rows(case["x"].T, 1), None)


def control_suite(d):
    """Every check of ``tests/test_torch_sharded_control.py`` on this
    rank: the global moments of each case, and the sharded control step
    (``from_noise``) fed each case's noise and ``r``, through the MPC
    built in the test's process (its CPU copy, carried by pickle)."""
    mesh = make_mesh(device="cpu")
    out = {"moments": {}, "control": {}}
    for name, case in d["moments"].items():
        state = _moment_state(mesh, case)
        est = _np(S.point_estimate(state, mesh))
        cov = (None if case["kind"] == "tiled"
               else _np(S.point_covariance(state, mesh)))
        out["moments"][name] = (est, cov)
    c = d["control"]
    mpc = c["mpc"].to("cpu")
    meas = _gs(c["meas"])
    step = make_sharded_control_step(mesh, mpc, mpc.model, F, G, dt=c["dt"])
    n_d, m = (mpc.M + 1) * mpc.Ni, mpc.qp.m
    for (nd, n_rank), case in c["cases"].items():
        if nd != mesh.size:
            continue
        state = pf.PFState(particle_sharding(mesh, case["x"]),
                           particle_sharding(mesh, case["w"]), None)
        state, u, y_pred, sol = step.from_noise(
            state, _t(c["um1"]), _t(c["z"]), torch.zeros(2),
            torch.zeros(n_d), torch.zeros(m), meas,
            particle_sharding(mesh, case["noise"]),
            torch.tensor(case["r"], dtype=torch.float32))
        out["control"][(nd, n_rank)] = dict(
            particles=_np(state.particles),
            est=_np(S.point_estimate(state, mesh)), u=_np(u),
            y_pred=_np(y_pred), status=int(sol.status))
    return out


def kernel_skips_suite(d):
    """The kernel route on this rank for each of ``d["cases"]``, at the
    reference's ``ends``: this rank's rows and the rounds it merged (each
    merged block's source rank), the skipped rounds left out."""
    mesh = make_mesh(device="cpu")
    r = torch.tensor(d["r"], dtype=torch.float32)
    sources, merged = [], []
    broadcast, merge = S._comm.broadcast, S.rpb.block_resample_round

    def spy_broadcast(mesh_, t, src):
        sources.append(src)
        return broadcast(mesh_, t, src)

    def spy_merge(*args, **kwargs):
        merged.append(sources[-1])
        return merge(*args, **kwargs)

    S._comm.broadcast, S.rpb.block_resample_round = spy_broadcast, spy_merge
    out = {}
    try:
        for case, (w, ends) in d["cases"].items():
            merged.clear()
            with injected_ends(mesh, ends):
                got, _ = S._resample(particle_sharding(mesh, d["parts"]),
                                     particle_sharding(mesh, w), r, mesh,
                                     S._FLAT_ROUTES["kernel"])
            out[case] = (_np(got), list(merged))
    finally:
        S._comm.broadcast, S.rpb.block_resample_round = broadcast, merge
    return out
