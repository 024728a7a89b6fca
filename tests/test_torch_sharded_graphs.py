"""The sharded steps and the sharded control step as graph replays
(``parallel/sharded``, ``parallel/control``), on the CPU.

- ``step.graphed``, the factories' decision, over every route of the
  flat, GSUKF and tiled steps and the control step, on a mesh of one
  rank (no group, NCCL or gloo) and on two-rank NCCL and gloo groups:
  graphed (a ``graphs.Graphed``) at one rank unless the survivors go by
  the ragged exchange, and never at two.
- A host-read guard (``Tensor.tolist``, ``item``, ``__bool__``, ``cpu``
  and ``numpy`` patched to raise): every capturable route at W = 1 runs
  its steps under it, but the kernel route, whose host-driven skips the
  card's capture replaces by IF nodes.
- Through the stand-in graph of ``tests/_torch_graph_stand_in.py``, every
  capturable step at W = 1 and the control step, chained, bit-equal to
  the same step under ``graphs.disabled`` (generators too).
- The kernel route's skips at W = 2 and 4 over gloo (spawned ranks), on
  ``ends`` where every block but the last lies wholly below some rank's
  slots (``full_below``) and where every rank is finished after the
  first round (``all_done``): each rank merges the one block it must,
  and the rows are bit-equal to the reference's distributed kernel route
  (interpret mode, on the virtual CPU mesh) on the same ``ends``.

Sizes: 4096 particles a rank (1024 at W = 2, 512 at W = 4 in the skip
cases), 256 Gaussians.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from gpu_se_tpu.parallel import make_mesh as ref_mesh
from gpu_se_tpu.parallel import sharded as jS
from gpu_se_tpu_torch import entry, graphs, rig
from gpu_se_tpu_torch.distributions import GaussianSum as TGS
from gpu_se_tpu_torch.filters import gs_ukf as tg
from gpu_se_tpu_torch.filters import particle as tpf
from gpu_se_tpu_torch.filters import particle_tiled as tpt
from gpu_se_tpu_torch.models import bioreactor as tbio
from gpu_se_tpu_torch.parallel import mesh as tmesh
from gpu_se_tpu_torch.parallel import sharded as S
from gpu_se_tpu_torch.parallel.control import make_sharded_control_step
from gpu_se_tpu_torch.parallel.launch import run_group
from tests import _torch_parallel_workers as workers
from tests._torch_graph_stand_in import stand_in  # noqa: F401

CPU = torch.device("cpu")
F, G = tbio.homeostatic_des, tbio.static_outputs
N = 4096
N_BANK = 256
ROUTES = {"flat": tuple(S._FLAT_ROUTES), "gsukf": tuple(S._GSUKF_ROUTES),
          "tiled": S.EXCHANGES, "control": ("xla", "kernel", "a2a")}
RAGGED = {"flat": {"a2a", "a2a_xla"}, "gsukf": {"a2a"}, "tiled": {"ragged"},
          "control": {"a2a"}}
MESHES = {"one rank": (1, None), "one rank nccl": (1, "nccl"),
          "one rank gloo": (1, "gloo"), "nccl": (2, "nccl"),
          "gloo": (2, "gloo")}
CAPTURABLE = [(kind, route) for kind in ("flat", "gsukf", "tiled")
              for route in ROUTES[kind]
              if route not in RAGGED[kind] and route != "kernel_interpret"]
STEPS = 3

# the skip cases
AX = "particles"
N_SKIP = 2048
R = np.float32(0.417)
SKIP_WIDTHS = (2, 4)
SKIP_CASES = ("full_below", "all_done")


@pytest.fixture(scope="module")
def toy_mpc():
    return entry.toy_control(CPU)


def _mesh(size, backend):
    """A mesh whose ``backend`` is ``backend``: its group stands for the
    process group, whose backend the factories read and nothing else."""
    return tmesh.Mesh(size, 0, CPU, backend)


def _factory(kind, mesh, route, toy_mpc):
    if kind == "flat":
        return S.make_shard_map_step(mesh, F, G, resample_impl=route)
    if kind == "gsukf":
        return S.make_shard_map_gsukf_step(mesh, F, G, resample_impl=route)
    if kind == "tiled":
        return S.make_shard_map_tiled_step(mesh, F, G, exchange=route)
    lin, mpc = toy_mpc
    return make_sharded_control_step(mesh, mpc, lin, F, G, dt=0.1,
                                     resample_impl=route)


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("kind, route", [(k, r) for k in ROUTES
                                         for r in ROUTES[k]])
def test_step_graphed_truth_table(monkeypatch, toy_mpc, kind, route,
                                  mesh_name):
    monkeypatch.setattr(tmesh.Mesh, "backend",
                        property(lambda self: self.group))
    size, backend = MESHES[mesh_name]
    step = _factory(kind, _mesh(size, backend), route, toy_mpc)
    want = route not in RAGGED[kind] and size == 1
    assert step.graphed is want
    assert isinstance(step, graphs.Graphed) is want
    assert callable(step.from_noise)


# ----------------------------------------------------------------------
# W = 1 on the CPU
# ----------------------------------------------------------------------
def _rig():
    return tuple(TGS.create(*a, device=CPU) for a in rig.bench_rig())


def _entry(kind, route, toy_mpc=None):
    """``(state, step, call)`` at W = 1: ``call(state) -> state`` runs
    ``step`` (the control step: the filter state it returns)."""
    mesh = tmesh.make_mesh(1, device=CPU)
    x0, state_pdf, meas_pdf = _rig()
    u = torch.tensor([0.06, 0.2])
    z = tbio.static_outputs(torch.from_numpy(rig.X_SS)).to(torch.float32)
    dt = torch.tensor(0.1)
    gen = torch.Generator().manual_seed(3)
    step = _factory(kind, mesh, route, toy_mpc)
    if kind == "gsukf":
        state = S.shard_gsukf_state(tg.init(gen, N_BANK, x0, state_pdf),
                                    mesh)
    elif kind == "tiled":
        state = S.shard_tiled_pf_state(tpt.init(gen, N, x0), mesh)
    else:
        state = S.shard_pf_state(tpf.init(gen, N, x0), mesh)
    if kind != "control":
        return state, step, lambda s: step(s, u, z, dt, state_pdf, meas_pdf)
    lin, mpc = toy_mpc
    n_d, m = (mpc.M + 1) * mpc.Ni, mpc.qp.m
    warm = (torch.zeros(n_d), torch.zeros(m))

    def call(s):
        return step(s, u, z, torch.zeros(2), *warm, state_pdf, meas_pdf)[0]

    return state, step, call


def _same(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f.name
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


READS = ("tolist", "item", "__bool__", "cpu", "numpy")


def _refuse(self, *args, **kwargs):
    raise AssertionError("a read to the host")


@pytest.mark.parametrize("kind, route",
                         [c for c in CAPTURABLE if c[1] != "kernel"])
def test_capturable_routes_read_nothing_on_the_host(monkeypatch, kind,
                                                    route):
    state, step, call = _entry(kind, route)
    with monkeypatch.context() as m:
        for name in READS:
            m.setattr(torch.Tensor, name, _refuse)
        for _ in range(2):
            state = call(state)
    assert torch.isfinite(getattr(state, dataclasses.fields(state)[0].name)
                          ).all()


def test_the_guard_catches_the_kernel_routes_host_skips(monkeypatch):
    """The kernel route eager reads its skips on the host: the guard sees
    it (on the card a capture takes them as IF nodes)."""
    state, step, call = _entry("flat", "kernel")
    monkeypatch.setattr(torch.Tensor, "tolist", _refuse)
    with pytest.raises(AssertionError, match="a read to the host"):
        call(state)


@pytest.mark.parametrize("kind, route",
                         CAPTURABLE + [("control", "xla"),
                                       ("control", "kernel")])
def test_graphed_step_bit_equal_to_eager(stand_in, toy_mpc, kind, route):
    state, step, call = _entry(kind, route, toy_mpc)
    assert step.graphed
    a, b = state, graphs.fork(state)
    for _ in range(STEPS):
        a = call(a)
        with graphs.disabled(step):
            b = call(b)
        _same(a, b)
    assert step.captures >= 1 and step.replays >= 1
    assert step.captures + step.replays == STEPS


# ----------------------------------------------------------------------
# the kernel route's skips against the reference, W = 2 and 4
# ----------------------------------------------------------------------
def _ref(nd, body, args, in_specs, out_specs):
    fn = jax.jit(shard_map(body, mesh=ref_mesh(nd), in_specs=in_specs,
                           out_specs=out_specs, check_vma=False))
    return jax.tree_util.tree_map(np.asarray, fn(*args))


def _ref_ends(w):
    def body(w, r):
        return jS._segmented_ends(w, r, AX)[0]

    return _ref(1, body, (jnp.asarray(w), jnp.float32(R)), (P(AX), P()),
                P(AX))


def _ref_kernel_rows(nd, parts, w):
    def body(t, w, r):
        return jS._distributed_systematic_resample_kernel(
            t, w, r, AX, interpret=True)[0]

    return _ref(nd, body, (jnp.asarray(parts), jnp.asarray(w),
                           jnp.float32(R)),
                (P(AX, None), P(AX), P()), P(AX, None))


def _skip_weights(nd, case, rng):
    """All the weight on the last rank's particles (every earlier block
    lies wholly below the slots: ``full_below``) or on the first rank's
    (its block covers every slot: ``all_done`` after round 0)."""
    w = np.zeros(N_SKIP, np.float32)
    n_local = N_SKIP // nd
    lo = N_SKIP - n_local if case == "full_below" else 0
    w[lo:lo + n_local] = rng.random(n_local).astype(np.float32) + 0.1
    return w


@pytest.fixture(scope="module")
def skips():
    rng = np.random.default_rng(7)
    parts = rng.standard_normal((N_SKIP, 5)).astype(np.float32)
    out = {}
    for nd in SKIP_WIDTHS:
        cases = {}
        for case in SKIP_CASES:
            w = _skip_weights(nd, case, rng)
            cases[case] = (w, _ref_ends(w))
        d = {"parts": parts, "r": R, "cases": cases}
        ranks = run_group(workers.kernel_skips_suite, nd, d, timeout_s=240)
        out[nd] = {case: (_ref_kernel_rows(nd, parts, w),
                          [rk[case] for rk in ranks])
                   for case, (w, _) in cases.items()}
    return out


@pytest.mark.parametrize("case", SKIP_CASES)
@pytest.mark.parametrize("nd", SKIP_WIDTHS)
def test_kernel_route_skips_bit_equal_to_reference(skips, nd, case):
    want, ranks = skips[nd][case]
    got = np.concatenate([rows for rows, _ in ranks])
    np.testing.assert_array_equal(got, want)
    merged = [rounds for _, rounds in ranks]
    # the one block each rank must merge; every other round skipped
    only = nd - 1 if case == "full_below" else 0
    assert merged == [[only]] * nd
