"""The port's sharded protocols against the JAX reference's, on the CPU.

The port runs over gloo in spawned process groups of W = 2 and 4 ranks
(``gpu_se_tpu_torch.parallel.launch.run_group``, one group per width,
every check of a width in one group: ``tests/_torch_parallel_workers.
sharding_suite``) and, at W = 1, in this process on a mesh of one. The
reference runs its ``shard_map`` protocols on the virtual CPU mesh of
``tests/conftest.py`` at the same W, its Pallas routes in interpret mode.
The inputs are numpy arrays from seeds; n = 16384 particles in all
(``n_local`` = 4096 at W = 4). Tolerances:

* the port's segmented ``ends`` are bit-equal across W = 1, 2, 4; against
  the reference's they differ only at float ties of the cumsum, by one:
  0 entries on uniform weights, at most ``ENDS_TIES`` (8 per 4096) on
  the others;
* given the reference's ``ends`` (injected per rank), every flat route
  and every GSUKF route is bit-equal to the reference's rows;
* the flat and GSUKF steps given the reference's noise and ``r``: the
  rows that differ from the reference's eager step (predict, update and
  the single-device resample, as ``tests/test_torch_particle.py`` and
  ``tests/test_torch_gs_ukf.py`` run it) are at most the step's tie
  bound, ``STEP_TIE_ROWS`` per 4096; against the reference's jitted
  ``make_shard_map_step`` / ``make_shard_map_gsukf_step`` at the same W,
  the rows outside the reference's own jitted-against-eager tolerance
  (flat ``rtol=2e-5, atol=1e-6``; GSUKF means ``rtol=1e-4, atol=1e-5``,
  covariances ``rtol=1e-4, atol=3e-6``, ``tests/test_sharding.py``) are
  within the same bound;
* the entry points' own steps (``step``, not ``from_noise``) from one
  seeded generator are bit-equal across W = 1, 2, 4 and every route, and
  equal to ``from_noise`` fed the global counter draw (the key and ``r``
  from that generator); each rank's counter draw covers exactly its own
  ``n_local`` samples (``n_local (2 nx + 1)`` for the GSUKF);
* the auto-sharded steps are bit-equal to the port's single-device step;
* the scenario solvers with a mesh: controls within 1e-4 of the
  reference's with a mesh of the same width, the same worst status (the
  consensus within ``CONSENSUS_ATOL`` of the reference's, the tolerance
  of ``tests/test_torch_scenario_mpc.py``), and at W = 1 equal to the
  port's ``mesh=None`` result bit for bit.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from gpu_se_tpu.control import MPC as RefMPC
from gpu_se_tpu.control import consensus_consts as ref_consensus_consts
from gpu_se_tpu.distributions import GaussianSum as JGS
from gpu_se_tpu.filters import gs_ukf as jgs
from gpu_se_tpu.filters import particle as jpf
from gpu_se_tpu.filters.resampling import systematic_resample_indices
from gpu_se_tpu.models import LinearModel as RefLinearModel
from gpu_se_tpu.models import bioreactor as jbio
from gpu_se_tpu.parallel import make_consensus_scenario_step as ref_consensus
from gpu_se_tpu.parallel import make_mesh as ref_mesh
from gpu_se_tpu.parallel import make_scenario_solver as ref_solver
from gpu_se_tpu.parallel import make_shard_map_gsukf_step as ref_gsukf_step
from gpu_se_tpu.parallel import make_shard_map_step as ref_step
from gpu_se_tpu.parallel import sharded as jS
from gpu_se_tpu.sim import harness
from gpu_se_tpu_torch import convert, rig
from gpu_se_tpu_torch.control import MPC, consensus_consts
from gpu_se_tpu_torch.filters import gs_ukf as tgs
from gpu_se_tpu_torch.filters import particle as tpf
from gpu_se_tpu_torch.models import LinearModel
from gpu_se_tpu_torch.models import bioreactor as tbio
from gpu_se_tpu_torch.ops import counter_draw as tcd
from gpu_se_tpu_torch.parallel import (
    make_consensus_scenario_step,
    make_mesh,
    make_scenario_solver,
    make_shard_map_gsukf_step,
    make_shard_map_step,
)
from gpu_se_tpu_torch.parallel.launch import run_group

from tests import _torch_parallel_workers as workers

AX = "particles"
N = 16384
N_GSUKF = 1024
WIDTHS = (1, 2, 4)
SPAWNED = (2, 4)
R = 0.417
STEP_TIE_ROWS = 8
# ends entries a cumsum tie may move: the step's bound (measured: 13 of
# 16384 on the lognormal weights, 0 on the others)
ENDS_TIES = STEP_TIE_ROWS * N // 4096
CONSENSUS_ATOL = 5e-4
FIELDS = ("means", "covariances", "weights", "chol", "inv_cov", "log_const")
X_SS = np.array([280 / 180, 640 / 24.6, 1000 / 116, 0.0, 0.0])
U = np.array([0.06, 0.2], np.float32)
DT = np.float32(0.1)
# the reference's Pallas routes, interpreted, at these widths only (a few
# seconds a call); its XLA ring runs at every width
REF_KERNEL_WIDTHS = {"kernel_interpret": (2, 4), "a2a_ring": (2, 4),
                     "a2a_ring_v4": (4,), "a2a_tiled_ring": (4,)}
BANK_FAMILY = "zero_blocks"


def _fields(gs):
    return tuple(np.asarray(getattr(gs, f)) for f in FIELDS)


def _families(rng):
    zero_blocks = rng.random(N).astype(np.float32)
    zero_blocks[:N // 3] = 0.0
    zero_blocks[2 * N // 3:] = 0.0
    one_hot = np.zeros(N, np.float32)
    one_hot[-1] = 1.0
    return {
        "uniform": np.full(N, 1.0 / N, np.float32),
        "lognormal": np.exp(4.0 * rng.standard_normal(N)).astype(np.float32),
        "zero_blocks": zero_blocks,
        "one_hot_last": one_hot,
    }


def _sharded(nd, body, args, in_specs, out_specs):
    fn = jax.jit(shard_map(body, mesh=ref_mesh(nd), in_specs=in_specs,
                           out_specs=out_specs, check_vma=False))
    return jax.tree_util.tree_map(np.asarray, fn(*args))


def _ref_ends(nd, w):
    def body(w, r):
        ends, prev = jS._segmented_ends(w, r, AX)
        return ends, prev.reshape(1)

    return _sharded(nd, body, (jnp.asarray(w), jnp.float32(R)),
                    (P(AX), P()), (P(AX), P(AX)))[0]


_REF_ROUTES = {
    "xla": lambda t, w, r: jS._distributed_systematic_resample(t, w, r, AX),
    "kernel_interpret": lambda t, w, r:
        jS._distributed_systematic_resample_kernel(t, w, r, AX,
                                                   interpret=True),
    "a2a_ring": lambda t, w, r: jS._distributed_systematic_resample_a2a(
        t, w, r, AX, exchange="ring", merge="xla"),
    "a2a_ring_v4": lambda t, w, r: jS._distributed_systematic_resample_a2a(
        t, w, r, AX, exchange="ring", merge="v4", compact="v4",
        interpret=True),
    "a2a_tiled_ring": lambda t, w, r:
        jS._distributed_systematic_resample_a2a_tiled(
            t, w, r, AX, exchange="ring", interpret=True),
}


def _ref_rows(nd, name, tree, w):
    """The reference's resample of ``tree`` by route ``name``."""
    specs = jax.tree_util.tree_map(
        lambda a: P(AX, *([None] * (a.ndim - 1))), tree)
    return _sharded(nd, lambda t, w, r: _REF_ROUTES[name](t, w, r)[0],
                    (jax.tree_util.tree_map(jnp.asarray, tree),
                     jnp.asarray(w), jnp.float32(R)),
                    (specs, P(AX), P()), specs)


def _harness_rig():
    state_pdf, meas_pdf = harness.get_noise()
    x0 = JGS.create(np.asarray(state_pdf.dist.means) + X_SS,
                    np.asarray(state_pdf.dist.covariances),
                    np.asarray(state_pdf.dist.weights))
    return x0, state_pdf.dist, meas_pdf.dist


def _inputs():
    rng = np.random.default_rng(0)
    parts = rng.standard_normal((N, 5)).astype(np.float32)
    odd = parts.copy()
    odd[::7, 0] = -0.0
    odd[::11, 1] = np.inf
    odd[::13, 2] = -np.inf
    odd[::17, 3] = np.nan
    half = rng.standard_normal((N, 5, 5)).astype(np.float32)
    covs = half @ half.transpose(0, 2, 1)
    bank = np.concatenate([rng.standard_normal((N, 5)).astype(np.float32),
                           covs.reshape(N, 25)], axis=1)
    x0, state_pdf, meas_pdf = _harness_rig()
    z = (np.asarray(jbio.static_outputs(X_SS, U, xp=np))
         + np.array([5.0, -20.0])).astype(np.float32)
    return dict(parts=parts, odd_parts=odd, bank=bank,
                weights=_families(rng), r=np.float32(R),
                bank_family=BANK_FAMILY, x0=_fields(x0),
                state_pdf=_fields(state_pdf), meas=_fields(meas_pdf),
                u=U, z=z, dt=DT, seed=5, n_auto=4096, n_auto_gsukf=512,
                j=(x0, state_pdf, meas_pdf))


def _flat_step_case(d):
    """The reference's sharded flat step at each width and the noise and
    ``r`` its key schedule draws."""
    x0, state_pdf, meas_pdf = d["j"]
    state = jpf.init(jax.random.PRNGKey(3), N, x0)
    _, k_noise, k_r = jax.random.split(state.key, 3)
    d.update(step_x=np.asarray(state.particles),
             step_w=np.asarray(state.weights),
             step_noise=np.asarray(state_pdf.draw(k_noise, (N,))),
             step_r=np.float32(jax.random.uniform(k_r, ())))
    u, z = jnp.asarray(U), jnp.asarray(d["z"])
    f, g = jbio.Bioreactor.homeostatic_DEs, jbio.Bioreactor.static_outputs
    parts = state.particles + jax.vmap(f, in_axes=(0, None, None))(
        state.particles, u, jnp.float32(DT)) + jnp.asarray(d["step_noise"])
    ys = jax.vmap(g, in_axes=(0, None))(parts, u)
    w = state.weights * meas_pdf.pdf(z - ys)
    idx = systematic_resample_indices(w, jnp.float32(d["step_r"]))
    want = {"eager": np.asarray(parts)[np.asarray(idx)]}
    for nd in WIDTHS:
        out = ref_step(ref_mesh(nd), f, g)(
            jS.shard_pf_state(state, ref_mesh(nd)), u, z, jnp.float32(DT),
            state_pdf, meas_pdf)
        want[nd] = np.asarray(out.particles)
    return want


def _gsukf_step_case(d):
    x0, state_pdf, meas_pdf = d["j"]
    state = jgs.init(jax.random.PRNGKey(4), N_GSUKF, x0, state_pdf)
    nx = 5
    _, k_noise, k_r = jax.random.split(state.key, 3)
    noise = np.asarray(state_pdf.draw(k_noise, (N_GSUKF, 2 * nx + 1)))
    d.update(g_means=np.asarray(state.means),
             g_covs=np.asarray(state.covariances),
             g_weights=np.asarray(state.weights),
             g_noise=np.ascontiguousarray(noise.transpose(1, 2, 0)),
             gsukf_r=np.float32(jax.random.uniform(k_r, ())))
    u, z = jnp.asarray(U), jnp.asarray(d["z"])
    f, g = jbio.Bioreactor.homeostatic_DEs, jbio.Bioreactor.static_outputs
    means, covs = jgs.predict_core(state.means, state.covariances, u,
                                   jnp.float32(DT), jnp.asarray(noise), f)
    means, covs, w = jgs.update_core(means, covs, state.weights, u, z, g,
                                     meas_pdf)
    idx = np.asarray(systematic_resample_indices(
        w, jnp.float32(d["gsukf_r"])))
    want = {"eager": (np.asarray(means)[idx], np.asarray(covs)[idx])}
    for nd in WIDTHS:
        mesh = ref_mesh(nd)
        out = ref_gsukf_step(mesh, f, g)(
            jS.shard_gsukf_state(state, mesh), u, z, jnp.float32(DT),
            state_pdf, meas_pdf)
        want[nd] = (np.asarray(out.means), np.asarray(out.covariances))
    return want


def _scenario_case(d):
    rng = np.random.default_rng(1)
    n_sc = 16
    A, B, C, D = rig.stable_model(11)
    sc = dict(model=(A, B, C, D), Q=np.eye(2), R=0.5 * np.eye(2),
              ysp=np.array([0.3, -0.2]),
              u_bounds=[np.array([-2.0, 2.0]), np.array([-2.0, 2.0])],
              x0s=rng.normal(scale=0.3, size=(n_sc, 2)).astype(np.float32),
              um1s=np.zeros((n_sc, 2), np.float32),
              biases=rng.normal(scale=0.05, size=(n_sc, 2)).astype(
                  np.float32))
    case = rig.binding_case()
    # 8 scenarios so that every width gets whole rows
    cs = dict(case, x0s=np.concatenate([case["x0s"], 0.5 * case["x0s"]]
                                       ).astype(np.float32),
              biases=np.zeros((8, 2), np.float32),
              um1=case["um1"].astype(np.float32))
    d.update(scenario=sc, consensus=cs)

    def ref_lin(model):
        return RefLinearModel(*model, 1.0, np.zeros(2), np.zeros(2),
                              np.zeros(2), np.zeros(2))

    K_ref = RefMPC(10, 4, sc["Q"], sc["R"], ref_lin(sc["model"]), sc["ysp"],
                   u_bounds=sc["u_bounds"])
    consts, settings, dims = ref_consensus_consts(
        ref_lin(cs["model"]), cs["P"], cs["M"], cs["Q"], cs["R"], cs["ysp"],
        y_bounds=cs["y_bounds"])
    want = {}
    for nd in WIDTHS:
        solved = ref_solver(K_ref, ref_mesh(nd))(
            *(jnp.asarray(sc[k]) for k in ("x0s", "um1s", "biases")))
        cons = ref_consensus(settings, dims, ref_mesh(nd), n_outer=40)(
            consts, *(jnp.asarray(cs[k]) for k in ("x0s", "um1", "biases")))
        want[nd] = (tuple(map(np.asarray, solved)),
                    tuple(map(np.asarray, cons)))
    return want


@pytest.fixture(scope="module")
def runs():
    """The reference's results and the port's, by width."""
    d = _inputs()
    ref = {"ends": {}, "rows": {}}
    d["ref_ends"] = {}
    for fam, w in d["weights"].items():
        ends = {nd: _ref_ends(nd, w) for nd in WIDTHS}
        for nd in WIDTHS[1:]:
            np.testing.assert_array_equal(ends[nd], ends[1])
        d["ref_ends"][fam] = ends[1]
        ref["ends"][fam] = ends[1]
        ref["rows"][fam] = _ref_rows(1, "xla", d["parts"], w)
    for name, widths in REF_KERNEL_WIDTHS.items():
        for nd in widths:
            # the reference's routes agree with its own ring, bit for bit
            got = _ref_rows(nd, name, d["parts"], d["weights"][BANK_FAMILY])
            np.testing.assert_array_equal(got, ref["rows"][BANK_FAMILY])
    bank_w = d["weights"][BANK_FAMILY]
    means, covs = d["bank"][:, :5], d["bank"][:, 5:].reshape(N, 5, 5)
    ref["bank"] = _ref_rows(1, "xla", (means, covs), bank_w)
    for name in ("kernel_interpret", "a2a_ring"):
        got = _ref_rows(4, name, (means, covs), bank_w)
        for a, b in zip(got, ref["bank"]):
            np.testing.assert_array_equal(a, b)
    ref["pin"] = d["odd_parts"][np.minimum(np.searchsorted(
        d["ref_ends"][BANK_FAMILY], np.arange(N)), N - 1)]
    ref["flat_step"] = _flat_step_case(d)
    ref["gsukf_step"] = _gsukf_step_case(d)
    ref["scenario"] = _scenario_case(d)
    del d["j"]

    port = {1: _concat([workers.sharding_suite(d)])}
    for nd in SPAWNED:
        outs = run_group(workers.sharding_suite, nd, d, timeout_s=240)
        port[nd] = _concat(outs)
    return d, ref, port


def _concat(outs):
    """The ranks' results joined along rows; ``prev`` as the list by
    rank; the scenario solvers' results, which every rank holds whole, as
    rank 0's after checking that every rank's are the same."""
    def rows(parts):
        if isinstance(parts[0], dict):
            return {k: rows([p[k] for p in parts]) for k in parts[0]}
        if isinstance(parts[0], tuple):
            return tuple(rows(list(z)) for z in zip(*parts))
        return np.concatenate(parts)

    out = {}
    for key in outs[0]:
        if key in ("solver", "consensus"):
            for o in outs[1:]:
                for a, b in zip(o[key], outs[0][key]):
                    np.testing.assert_array_equal(a, b)
            out[key] = outs[0][key]
        elif key == "prev":
            out[key] = {fam: [o[key][fam] for o in outs]
                        for fam in outs[0][key]}
        else:
            out[key] = rows([o[key] for o in outs])
    return out


# ----------------------------------------------------------------------
@pytest.mark.parametrize("nd", WIDTHS)
def test_segmented_ends_width_invariant_and_near_reference(runs, nd):
    d, ref, port = runs
    for fam in d["weights"]:
        got = port[nd]["ends"][fam]
        np.testing.assert_array_equal(got, port[1]["ends"][fam], err_msg=fam)
        ties = np.count_nonzero(got != ref["ends"][fam])
        assert ties <= (0 if fam == "uniform" else ENDS_TIES), (fam, ties)
        assert np.abs(got.astype(np.int64) - ref["ends"][fam]).max(
            initial=0) <= 1, fam
    n_local = N // nd
    for fam in d["weights"]:
        want = [-1] + [int(port[1]["ends"][fam][k * n_local - 1])
                       for k in range(1, nd)]
        assert port[nd]["prev"][fam] == want, fam


@pytest.mark.parametrize("nd", WIDTHS)
def test_flat_routes_bit_equal_given_reference_ends(runs, nd):
    d, ref, port = runs
    for fam in d["weights"]:
        for name, got in port[nd]["routes"][fam].items():
            np.testing.assert_array_equal(got, ref["rows"][fam],
                                          err_msg=f"{name} {fam}")


@pytest.mark.parametrize("nd", WIDTHS)
def test_gsukf_routes_bit_equal_given_reference_ends(runs, nd):
    _, ref, port = runs
    for name, (m, c) in port[nd]["gsukf_routes"].items():
        np.testing.assert_array_equal(m, ref["bank"][0], err_msg=name)
        np.testing.assert_array_equal(c, ref["bank"][1], err_msg=name)


@pytest.mark.parametrize("nd", WIDTHS)
def test_routes_copy_negative_zero_and_non_finite_rows(runs, nd):
    """The kernel route broadcasts each block by a copy (the reference
    sums ``parts * mine``, which turns ``-0.0`` into ``0.0`` and lets a
    NaN or infinity spread): every route gives each slot its ancestor's
    bits, ``-0.0``, infinities and NaNs included."""
    _, ref, port = runs
    want = ref["pin"].view(np.int32)
    for name, got in port[nd]["pin"].items():
        np.testing.assert_array_equal(got, want, err_msg=name)


def _rows_apart(got, want, rtol, atol):
    close = np.isclose(got, want, rtol=rtol, atol=atol)
    return np.count_nonzero(~close.reshape(len(got), -1).all(axis=1))


@pytest.mark.parametrize("nd", WIDTHS)
def test_flat_step_vs_reference(runs, nd):
    _, ref, port = runs
    bound = STEP_TIE_ROWS * N // 4096
    for name, got in port[nd]["flat_step"].items():
        assert _rows_apart(got, ref["flat_step"]["eager"], 0, 0) <= bound
        apart = _rows_apart(got, ref["flat_step"][nd], 2e-5, 1e-6)
        assert apart <= bound, (name, apart)


@pytest.mark.parametrize("nd", WIDTHS)
def test_gsukf_step_vs_reference(runs, nd):
    _, ref, port = runs
    bound = STEP_TIE_ROWS * max(1, N_GSUKF // 4096)
    for name, (m, c) in port[nd]["gsukf_step"].items():
        for got, want in zip((m, c), ref["gsukf_step"]["eager"]):
            assert _rows_apart(got, want, 0, 0) <= bound, name
        want_m, want_c = ref["gsukf_step"][nd]
        assert _rows_apart(m, want_m, 1e-4, 1e-5) <= bound, name
        assert _rows_apart(c, want_c, 1e-4, 3e-6) <= bound, name


def _counter_steps(d):
    """The W = 1 ``from_noise`` steps fed the global counter draw: the key
    and then ``r`` from the generator seeded ``d["seed"]``, as the entry
    points draw them."""
    gs = {k: convert.gaussian_sum_from_numpy(*d[k], device="cpu")
          for k in ("state_pdf", "meas")}
    u, z, dt = (torch.from_numpy(np.asarray(d[k])) for k in ("u", "z", "dt"))
    f, g = tbio.homeostatic_des, tbio.static_outputs
    mesh = make_mesh(device="cpu")

    def key_r():
        gen = torch.Generator().manual_seed(d["seed"])
        key = tcd.key_from(gen, "cpu")
        return key, torch.rand((), generator=gen)

    key, r = key_r()
    noise = gs["state_pdf"].draw_from(*gs["state_pdf"].draw_inputs_at(
        key, 0, N))
    parts, weights = make_shard_map_step(mesh, f, g).from_noise(
        torch.tensor(d["step_x"]), torch.tensor(d["step_w"]), u, z,
        dt, gs["meas"], noise, r)
    nx = d["g_means"].shape[1]
    s = 2 * nx + 1
    key, r = key_r()
    g_noise = gs["state_pdf"].draw_t_from(*gs["state_pdf"].draw_inputs_at_t(
        key, 0, N_GSUKF * s)).reshape(nx, N_GSUKF, s).permute(2, 0, 1)
    (m, c), _ = make_shard_map_gsukf_step(mesh, f, g).from_noise(
        *(torch.tensor(d[k]) for k in ("g_means", "g_covs", "g_weights")),
        u, z, dt, gs["meas"], g_noise, r)
    return (parts.numpy(), weights.numpy()), (m.numpy(), c.numpy())


@pytest.mark.parametrize("nd", WIDTHS)
def test_sharded_steps_bit_equal_across_widths(runs, nd):
    d, _, port = runs
    flat, bank = _counter_steps(d)
    for name, got in port[nd]["step"].items():
        for a, b in zip(got, flat):
            np.testing.assert_array_equal(a, b, err_msg=name)
    for name, got in port[nd]["gsukf_own_step"].items():
        for a, b in zip(got, bank):
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert np.isfinite(flat[0]).all() and np.isfinite(bank[1]).all()


@pytest.mark.parametrize("nd", WIDTHS)
def test_each_rank_draws_only_its_slice(runs, nd):
    _, _, port = runs
    nx = 5
    for path, draws in port[nd]["draws"].items():
        flat = path.startswith("flat")
        n_local = (N if flat else N_GSUKF) // nd
        s = 1 if flat else 2 * nx + 1
        assert draws.shape == (nd, 1, 3), (path, draws.shape)
        for rank in range(nd):
            assert tuple(draws[rank, 0]) == (rank * n_local * s,
                                             n_local * s, nx), (path, rank)


@pytest.mark.parametrize("nd", WIDTHS)
def test_auto_sharded_steps_bit_equal_to_single_device(runs, nd):
    d, _, port = runs
    gs = {k: convert.gaussian_sum_from_numpy(*d[k], device="cpu")
          for k in ("x0", "state_pdf", "meas")}
    u, z, dt = (torch.from_numpy(np.asarray(d[k])) for k in ("u", "z", "dt"))
    f, g = tbio.homeostatic_des, tbio.static_outputs
    state = tpf.init(torch.Generator().manual_seed(d["seed"]), d["n_auto"],
                     gs["x0"])
    want = tpf.step(state, u, z, dt, f, g, gs["state_pdf"], gs["meas"])
    np.testing.assert_array_equal(port[nd]["auto"][0],
                                  want.particles.numpy())
    np.testing.assert_array_equal(port[nd]["auto"][1], want.weights.numpy())
    g_state = tgs.init(torch.Generator().manual_seed(d["seed"]),
                       d["n_auto_gsukf"], gs["x0"], gs["state_pdf"])
    want = tgs.step(g_state, u, z, dt, f, g, gs["state_pdf"], gs["meas"])
    np.testing.assert_array_equal(port[nd]["auto_gsukf"][0],
                                  want.means.numpy())
    np.testing.assert_array_equal(port[nd]["auto_gsukf"][1],
                                  want.covariances.numpy())


@pytest.mark.parametrize("nd", WIDTHS)
def test_scenario_solvers_with_mesh_vs_reference(runs, nd):
    d, ref, port = runs
    (r_ctrl, r_pred, r_st), (r_cons, _, r_worst) = ref["scenario"][nd]
    ctrl, pred, st = port[nd]["solver"]
    np.testing.assert_allclose(ctrl, r_ctrl, atol=1e-4)
    np.testing.assert_allclose(pred, r_pred, atol=1e-3)
    np.testing.assert_array_equal(st, r_st)
    cons, gap, worst = port[nd]["consensus"]
    np.testing.assert_allclose(cons, r_cons, atol=CONSENSUS_ATOL)
    assert int(worst) == int(r_worst)
    assert float(gap) < 1e-3
    if nd == 1:
        # a mesh of one is mesh=None, bit for bit
        sc, cs = d["scenario"], d["consensus"]
        lin = LinearModel(*sc["model"], 1.0, np.zeros(2), np.zeros(2),
                          np.zeros(2), np.zeros(2))
        K = MPC(10, 4, sc["Q"], sc["R"], lin, sc["ysp"],
                u_bounds=sc["u_bounds"], device="cpu")
        plain = make_scenario_solver(K)(
            *(torch.from_numpy(sc[k]) for k in ("x0s", "um1s", "biases")))
        for a, b in zip(port[1]["solver"], plain):
            np.testing.assert_array_equal(a, b.numpy())
        lin_b = LinearModel(*cs["model"], 1.0, np.zeros(2), np.zeros(2),
                            np.zeros(2), np.zeros(2))
        consts, settings, dims = consensus_consts(
            lin_b, cs["P"], cs["M"], cs["Q"], cs["R"], cs["ysp"],
            y_bounds=cs["y_bounds"], device="cpu")
        plain = make_consensus_scenario_step(settings, dims, n_outer=40)(
            consts, *(torch.from_numpy(cs[k])
                      for k in ("x0s", "um1", "biases")))
        for a, b in zip(port[1]["consensus"], plain):
            np.testing.assert_array_equal(a, b.numpy())


def test_spawned_group_failure_raises_with_the_rank_traceback():
    """A rank that raises fails the call at once, with its traceback,
    and takes no other rank's time limit."""
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        run_group(partial(divmod, 1), 2, 0, timeout_s=60)
