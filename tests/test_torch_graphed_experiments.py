"""The experiments' graphed ops (``gpu_se_tpu_torch/results``), the
counterpart of the reference's ``jax.jit`` of each op, and the filter
shells' inputs from the host, on the CPU.

A CUDA graph exists only on the card: the ops run through the stand-in
graph of ``tests/_torch_graph_stand_in.py`` (warm-up, capture, replays),
so the helper's logic runs as on the card.

- ``_filter_bench.build("pf" | "gsf", n, gpu=False)``: each of the four
  ops, each of ``breakdown_ops``' stages and ``gsf_run_seq``'s
  sigma-point op is a ``graphs.Graphed``; three chained calls through the
  graph are bit-equal to the unwrapped function's from the same state
  and generator state (generators too).
- The graphed ``update`` against the reference's jitted ``update``
  (``results/_filter_bench.build("pf", 1024, False)``) on the same
  particles and weights, within the flat parity tests' ``rtol=1e-5``.
- ``time_op`` warms a graphed op until a call replays, times replays
  only, records its warm-up calls, and raises when the warm-up does not
  settle; ``release`` frees the graphs.
- The campaign records a card row's eager timing beside it, under
  ``graphs.disabled``; ``device_solve_ms`` runs both ways.
- ``graphs.as_input``, the shells' staging of ``u``, ``z`` and ``dt``, is
  on the CPU what it was (``torch.as_tensor``), and the shells' steps from
  host values are bit-equal to the functional steps.

Sizes: 1024 particles, 64 Gaussians, nx = 5.
"""
import dataclasses
import importlib
import os
import pathlib

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
os.environ.setdefault("GPU_SE_PICKLEJAR_ROOT",
                      str(REPO / "picklejar" / "test_cache"))

import jax  # noqa: E402,F401  (the reference's jitted ops)

from gpu_se_tpu_torch import graphs  # noqa: E402
from gpu_se_tpu_torch.filters import gs_ukf as tg  # noqa: E402
from gpu_se_tpu_torch.filters import particle as tpf  # noqa: E402
from gpu_se_tpu_torch.models import bioreactor as tbio  # noqa: E402
from gpu_se_tpu_torch.utils import cache  # noqa: E402
from tests._torch_graph_stand_in import stand_in  # noqa: E402,F401

CPU = "cpu"
N_PF = 1024
N_GS = 64
OPS = ("predict", "update", "resample", "step")
STAGES = ("dynamics", "noise", "indices", "gather", "full_step")
CALLS = 3


def port(name):
    return importlib.import_module(f"gpu_se_tpu_torch.results.{name}")


def ref(name):
    return importlib.import_module(f"results.{name}")


@pytest.fixture(autouse=True)
def jar(tmp_path, monkeypatch):
    monkeypatch.setenv(cache.ROOT_ENV, str(tmp_path / "jar"))


def _tensors(state):
    return [getattr(state, f.name) for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), torch.Tensor)]


def _graphed_equals_function(op, state):
    """``CALLS`` chained calls of the graphed ``op`` against its function
    from a fork of ``state``, bit-equal after each."""
    assert isinstance(op, graphs.Graphed)
    a, b = state, graphs.fork(state)
    for _ in range(CALLS):
        a, b = op(a), op.__wrapped__(b)
        for x, y in zip(_tensors(a), _tensors(b), strict=True):
            assert torch.equal(x, y)
        assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert op.captures >= 1 and op.captures + op.replays == CALLS


@pytest.mark.parametrize("kind", ("pf", "gsf"))
@pytest.mark.parametrize("name", OPS)
def test_build_op_graphed_bit_equal_to_its_function(stand_in, kind, name):
    state, ops = port("_filter_bench").build(
        kind, N_PF if kind == "pf" else N_GS, False)
    _graphed_equals_function(ops[name], state)


@pytest.mark.parametrize("name", STAGES)
def test_breakdown_op_graphed_bit_equal_to_its_function(stand_in, name):
    state, ops = port("_filter_bench").breakdown_ops(N_PF, False)
    assert list(ops) == list(STAGES)
    _graphed_equals_function(ops[name], state)


def test_sigma_points_op_graphed_bit_equal_to_its_function(stand_in):
    state, _ = port("_filter_bench").build("gsf", N_GS, False)
    op = port("gsf_openloop.gsf_run_seq").sigma_points_op
    try:
        _graphed_equals_function(op, state)
    finally:
        port("_filter_bench").release(op)


def test_graphed_update_vs_reference_jitted(stand_in):
    """The graphed ``update`` on the reference's particles and weights
    against the reference's jitted ``update``, within ``rtol=1e-5``."""
    state, ops = ref("_filter_bench").build("pf", N_PF, False)
    want = np.asarray(ops["update"](state).weights)
    _, t_ops = port("_filter_bench").build("pf", N_PF, False)
    t_state = tpf.PFState(torch.from_numpy(np.array(state.particles)),
                          torch.from_numpy(np.array(state.weights)),
                          torch.Generator())
    op = t_ops["update"]
    for _ in range(2):          # the warm-up's, then a replay's
        got = op(t_state).weights.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert op.replays == 1


# ----------------------------------------------------------------------
# time_op and release
# ----------------------------------------------------------------------
def _transposed_once(x):
    """``x + 1`` laid out column-major: a row-major input keys one graph,
    the column-major output another, which then replays."""
    return (x + 1).T.contiguous().T


def _shifted(x):
    """``x + 1`` at the next 4-byte alignment each call: every output
    keys a new graph, for four calls."""
    off = (graphs._alignment(x) + 1) % 4
    buf = torch.empty(x.numel() + 4, dtype=x.dtype)
    return buf[off:off + x.numel()].copy_(x + 1)


def test_time_op_warms_a_graphed_op_until_it_replays(stand_in):
    fb = port("_filter_bench")
    op = graphs.Graphed(_transposed_once, copy_out=False)
    with fb.warm_calls() as warms:
        times = fb.time_op(op, torch.zeros((8, 5)), 6, chunk=5)
    assert times.shape == (6,) and warms == [3]
    assert (op.captures, op.replays) == (2, 7)
    fb.release(op)
    assert op.entries == {}


def test_time_op_raises_when_the_warm_up_does_not_settle(stand_in):
    op = graphs.Graphed(_shifted, copy_out=False)
    with pytest.raises(RuntimeError, match="captured at each"):
        port("_filter_bench").time_op(op, torch.zeros(16), 3)


def test_time_op_of_an_eager_or_cpu_op_warms_once():
    fb = port("_filter_bench")
    op = graphs.Graphed(_transposed_once, copy_out=False)
    with fb.warm_calls() as warms:
        fb.time_op(op, torch.zeros((8, 5)), 4)
    assert warms == [1] and op.captures == 0


def test_warm_calls_tallies_only_inside_its_block(stand_in):
    """Each open block gains each warm-up's count; a warm-up outside
    every block, or after a block closed, is tallied nowhere."""
    fb = port("_filter_bench")
    assert fb.warm(graphs.Graphed(_transposed_once, copy_out=False),
                   torch.zeros((8, 5)))[1] == 3
    with fb.warm_calls() as outer:
        with fb.warm_calls() as inner:
            _, calls = fb.warm(graphs.Graphed(_transposed_once,
                                              copy_out=False),
                               torch.zeros((8, 5)))
        fb.warm(lambda x: x + 1, torch.zeros(3))
    fb.warm(lambda x: x + 1, torch.zeros(3))
    assert (calls, inner, outer) == (3, [3], [3, 1])


@pytest.mark.parametrize("module, name", [
    ("pf_openloop.pf_run_seq", "step_run_seq"),
    ("pf_openloop.pf_run_seq", "breakdown_run_seqs"),
    ("gsf_openloop.gsf_run_seq", "sigma_points_run_seq"),
    ("pf_openloop.pf_power", "step_energy"),
])
def test_memo_wrappers_name_their_raw_function(module, name):
    """``raw`` is what the ``PickleJar`` memoizes, under a
    ``RunSequences`` too (``step_energy``'s a ``PowerMeasurement``)."""
    from gpu_se_tpu_torch.utils import PickleJar

    fn = getattr(port(module), name)
    jar = fn if isinstance(fn, PickleJar) else fn.func
    assert isinstance(jar, PickleJar) and fn.raw is jar.func
    assert not isinstance(fn.raw, PickleJar) and callable(fn.raw)


def test_run_seq_frees_its_graphs(stand_in, monkeypatch):
    fb = port("_filter_bench")
    built = []
    real = fb.build

    def build(*args):
        state, ops = real(*args)
        built.append(ops)
        return state, ops

    monkeypatch.setattr(fb, "build", build)
    times = fb.run_seq("pf", "step", N_PF, 3, gpu=False)
    assert times.shape == (3,) and (times > 0).all()
    assert built[0]["step"].captures == 1
    assert all(op.entries == {} for op in built[0].values())


# ----------------------------------------------------------------------
# the campaign's eager rows and the MPC chain
# ----------------------------------------------------------------------
class _RunSeq:
    """A stand-in for ``RunSequences(PickleJar(raw))``: called with the
    sizes, ``.raw`` the unmemoized ``raw``."""

    def __init__(self, raw, memoized):
        self.raw = raw
        self.memoized = memoized

    def __call__(self, ns, runs, gpu):
        return self.memoized(ns, runs, gpu)


def test_campaign_records_eager_beside_each_card_row(tmp_path):
    camp = port("campaign")
    probe = graphs.Graphed(lambda x: x)
    seen = []

    def raw(n, runs, gpu):
        seen.append((n, gpu, graphs.is_disabled(probe)))
        return np.linspace(2e-3, 3e-3, runs)

    def memoized(ns, runs, gpu):
        seen.append((int(ns[0]), gpu, graphs.is_disabled(probe)))
        return ns, [np.linspace(1e-3, 2e-3, runs)]

    art = camp.Artifact(str(tmp_path / "none.json"),
                        str(tmp_path / "out.json"), {"name": "a card"})
    entry = art.start("leg")
    camp.run_seq_legs(art, entry, [("op", _RunSeq(raw, memoized))],
                      {"card": (True, [1.0]), "cpu": (False, [2.0])})
    card, cpu = entry["sizes"]["card"]["op"][0], entry["sizes"]["cpu"]["op"][0]
    assert card["median_s"] == pytest.approx(1.5e-3)
    assert card["eager"]["median_s"] == pytest.approx(2.5e-3)
    assert "eager" not in cpu
    assert seen == [(2, True, False), (2, True, True), (4, False, False)]


@pytest.mark.parametrize("graphed", (True, False))
def test_device_solve_ms_both_ways_on_cpu(graphed):
    ms, iters = port("bioreactor_closedloop.mpc_run_seq").device_solve_ms(
        dt_control=10.0, k1=1, k2=2, reps=1, device=CPU, graphed=graphed)
    assert np.isfinite(ms) and iters >= 1


# ----------------------------------------------------------------------
# the shells' inputs from the host
# ----------------------------------------------------------------------
HOST_VALUES = {
    "float": 0.1,
    "numpy float64": np.float64(0.1),
    "numpy float32 array": np.array([0.06, 0.2], np.float32),
    "numpy float64 array": np.array([0.06, 0.2]),
    "list": [0.06, 0.2],
    "float64 tensor": torch.tensor([0.06, 0.2], dtype=torch.float64),
}


@pytest.mark.parametrize("name", HOST_VALUES)
def test_as_input_on_the_cpu_is_as_tensor(name):
    v = HOST_VALUES[name]
    got = graphs.as_input(v, torch.device(CPU))
    want = torch.as_tensor(v, dtype=torch.float32, device=CPU)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, want)


def _rig():
    x_ss = np.array([280 / 180, 640 / 24.6, 1000 / 116, 0.0, 0.0])
    _, x0, state_pdf, meas_pdf = port("_filter_bench").rig_dists(CPU)
    return x_ss, x0, state_pdf, meas_pdf


@pytest.mark.parametrize("kind", ("pf", "gsukf"))
def test_shell_step_from_host_values_equals_functional_step(kind):
    """``u`` (float64), ``z`` and ``dt`` as the harness passes them: the
    shell's step equals the functional step fed ``torch.as_tensor`` of
    them, bit for bit."""
    x_ss, x0, state_pdf, meas_pdf = _rig()
    f, g = tbio.homeostatic_des, tbio.static_outputs
    u = np.array([0.06, 0.2])
    z = tbio.static_outputs(torch.from_numpy(x_ss)).numpy()
    dt = 0.1
    if kind == "pf":
        filt = tpf.ParticleFilter(f, g, N_PF, x0, state_pdf, meas_pdf,
                                  device=CPU)
        core = tpf
    else:
        filt = tg.GaussianSumUnscentedKalmanFilter(
            f, g, N_GS, x0, state_pdf, meas_pdf, device=CPU)
        core = tg
    want = graphs.fork(filt.state)
    for _ in range(2):
        filt.step(u, z, dt)
        want = core.step(want, *(torch.as_tensor(v, dtype=torch.float32)
                                 for v in (u, z, dt)),
                         f, g, filt.state_pdf, filt.measurement_pdf)
        for a, b in zip(_tensors(filt.state), _tensors(want), strict=True):
            assert torch.equal(a, b)
