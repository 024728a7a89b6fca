"""The port's experiments layer (``gpu_se_tpu_torch/results``) against the
reference's ``results/``, on the CPU.

- ``rig_dists``: every leaf of the three mixtures bit-equal.
- ``build``'s ops: ``u``, ``z`` and ``dt`` equal; ``update`` on the
  reference's particles and weights within rtol 1e-5 (``exp`` and the
  mixture's einsum round differently, as in ``test_torch_particle.py``);
  ``step`` with the reference's noise, ``r`` and ``ends`` injected,
  bit-equal to the reference's eager step.
- The host plant's experiments (``openloop_staged_run``, ``ss2ss`` and
  ``batch_production_growth`` with the noise off, ``step_tests``)
  bit-equal to the reference's.
- ``no_noise.simulate(end_time=5, dt_control=1)``: inputs within 2e-4
  and outputs within 0.5 mg/L of the reference's (the float32 ADMM of
  the two packages parts by ~1e-5 in the inputs over these five solves).
- ``print_latex`` prints what the reference prints.
- ``time_op`` times the same chunks as the reference's, and the summaries
  of the closed loops, the breakdown, the energy and the MPC run sequence
  have the reference's keys and shapes.
- ``gpu=True`` raises without a card, and a figure whose card memos are
  missing raises instead of computing on the CPU.
- The cheap-argument cases of ``tests/test_experiments.py``, one for one.
- On a host like the card's, with ``jax``, ``joblib``, ``matplotlib`` and
  ``sympy`` missing, every module imports and the jar works.

Each test's jar is under ``tmp_path``; the reference's jar is
``picklejar/test_cache/``, as in ``tests/test_experiments.py``.
"""
import contextlib
import importlib
import io
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

# the reference's jar reads its root when its modules are imported
REPO = pathlib.Path(__file__).resolve().parent.parent
os.environ.setdefault("GPU_SE_PICKLEJAR_ROOT",
                      str(REPO / "picklejar" / "test_cache"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gpu_se_tpu.ops.resample_coarse import ends_from_weights as j_ends  # noqa: E402
from gpu_se_tpu_torch.distributions import GaussianSum as TGS  # noqa: E402
from gpu_se_tpu_torch.filters import resampling as trs  # noqa: E402
from gpu_se_tpu_torch.ops import resample_pallas4 as trp4  # noqa: E402
from gpu_se_tpu_torch.ops import resample_pallas_block as trb  # noqa: E402
from gpu_se_tpu_torch.utils import cache  # noqa: E402

CPU = "cpu"
PKG = "gpu_se_tpu_torch.results"
FIELDS = ("means", "covariances", "weights", "chol", "inv_cov", "log_const")
MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in (REPO / "gpu_se_tpu_torch" / "results").rglob("*.py"))


def port(name):
    return importlib.import_module(f"{PKG}.{name}")


def ref(name):
    return importlib.import_module(f"results.{name}")


@pytest.fixture(autouse=True)
def jar(tmp_path, monkeypatch):
    monkeypatch.setenv(cache.ROOT_ENV, str(tmp_path / "jar"))
    return tmp_path / "jar"


# ----------------------------------------------------------------------
# the filter bench against the reference's
# ----------------------------------------------------------------------
def test_rig_dists_bit_equal():
    ours, theirs = port("_filter_bench").rig_dists(CPU), ref(
        "_filter_bench").rig_dists()
    np.testing.assert_array_equal(ours[0], theirs[0])
    for o, t in zip(ours[1:], theirs[1:]):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(o, f).numpy(),
                                          np.asarray(getattr(t, f)),
                                          err_msg=f)


def _closure(fn):
    fn = getattr(fn, "__wrapped__", fn)
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))


@pytest.fixture(scope="module")
def pf_pair():
    """The reference's and the port's PF ops at 1024 particles on the CPU,
    and the reference's initial state."""
    state, ops = ref("_filter_bench").build("pf", 1024, False)
    _, t_ops = port("_filter_bench").build("pf", 1024, False)
    return state, ops, t_ops


@pytest.mark.parametrize("op, names", [("update", ("u", "z")),
                                       ("predict", ("u",))])
def test_build_inputs_equal(pf_pair, op, names):
    """``u`` and ``z`` as the reference's ops hold them; ``dt`` is the
    reference's literal ``jnp.float32(0.1)``."""
    _, ops, t_ops = pf_pair
    theirs, ours = _closure(ops[op]), _closure(t_ops[op])
    for name in names:
        got = ours[name].numpy()
        want = np.asarray(theirs[name])
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    if op == "predict":
        dt = ours["dt"].numpy()
        assert dt.dtype == np.float32 and dt == np.asarray(jnp.float32(0.1))


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


def _port_state(state):
    from gpu_se_tpu_torch.filters import particle as tpf

    return tpf.PFState(_t(state.particles), _t(state.weights),
                       torch.Generator())


def test_build_update_vs_reference(pf_pair):
    state, ops, t_ops = pf_pair
    with jax.disable_jit():
        want = np.asarray(ops["update"](state).weights)
    got = t_ops["update"](_port_state(state)).weights.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_build_step_with_injected_noise_vs_reference(pf_pair, monkeypatch):
    """The port's ``step`` op, given the reference's noise draw, ``r`` and
    ``ends``, equals the reference's eager step bit for bit."""
    from gpu_se_tpu.filters import particle as jpf

    state, ops, t_ops = pf_pair
    _, _, j_state_pdf, j_meas_pdf = ref("_filter_bench").rig_dists()
    n = state.particles.shape[0]
    k1, sub1 = jax.random.split(state.key)
    _, sub2 = jax.random.split(k1)
    noise = np.asarray(j_state_pdf.draw(sub1, (n,)))
    r = np.float32(jax.random.uniform(sub2, ()))
    with jax.disable_jit():
        want = np.asarray(ops["step"](state).particles)
        c = _closure(ops["update"])
        predicted = jpf.predict(state, c["u"], jnp.float32(0.1),
                                _closure(ops["predict"])["f"], j_state_pdf)
        w_upd = jpf.update(predicted, c["u"], c["z"], c["g"],
                           j_meas_pdf).weights
    ends = _t(j_ends(w_upd, jnp.asarray(r)))
    for mod in (trs, trb, trp4):
        monkeypatch.setattr(mod, "ends_from_weights", lambda *_: ends)
    monkeypatch.setattr(TGS, "draw", lambda self, gen, shape: _t(noise))
    monkeypatch.setattr(trs, "_draw_r", lambda w, gen: _t(r))
    got = t_ops["step"](_port_state(state)).particles.numpy()
    np.testing.assert_array_equal(got, want)


def test_time_op_times_the_references_chunks(monkeypatch):
    """Each call of the op moves the clock by its index: both packages
    record the same chunk means, after the same one warm-up call."""
    def clocked(to_next):
        clock = {"t": 0.0, "calls": 0}

        def op(s):
            clock["calls"] += 1
            clock["t"] += clock["calls"]
            return to_next(s)

        return clock, op

    results = []
    for mod, state, to_next in (
            (ref("_filter_bench"), jnp.zeros(3), lambda s: s + 1),
            (port("_filter_bench"), torch.zeros(3), lambda s: s + 1)):
        clock, op = clocked(to_next)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: clock["t"])
        results.append((mod.time_op(op, state, 12, chunk=5), clock["calls"]))
        monkeypatch.undo()
    (want, want_calls), (got, got_calls) = results
    np.testing.assert_array_equal(got, want)
    assert got_calls == want_calls == 13
    assert len(set(got[:5])) == len(set(got[5:10])) == 1


# ----------------------------------------------------------------------
# the host plant's experiments against the reference's
# ----------------------------------------------------------------------
SCHEDULE = [(25.0, np.array([0.0, 0.0])), (np.inf, np.array([0.06, 0.2]))]
X0 = [3000 / 180, 1 / 24.6, 0.0, 0.0, 0.0]


def test_openloop_staged_run_bit_equal_without_noise():
    args = dict(end_time=30, schedule=SCHEDULE, X0=X0, noisy=False)
    for got, want in zip(port("_common").openloop_staged_run(**args),
                         ref("_common").openloop_staged_run(**args)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["ss2ss", "batch_production_growth"])
def test_staged_experiments_bit_equal_without_noise(name, monkeypatch):
    mods = []
    for get, common in ((port, port("_common")), (ref, ref("_common"))):
        mod = get(f"bioreactor_openloop.{name}")
        run = common.openloop_staged_run
        monkeypatch.setattr(mod, "openloop_staged_run",
                            lambda _run=run, **kw: _run(**{**kw,
                                                          "noisy": False}))
        mods.append(mod)
    for got, want in zip(mods[0].simulate(end_time=40),
                         mods[1].simulate(end_time=40)):
        np.testing.assert_array_equal(got, want)


def test_step_tests_bit_equal():
    ours, theirs = port("bioreactor_openloop.step_tests"), ref(
        "bioreactor_openloop.step_tests")
    for got, want in zip(ours.step_test((0.9, 1.1), 0.5),
                         theirs.step_test((0.9, 1.1), 0.5)):
        np.testing.assert_array_equal(got, want)
    percents = np.array([1.1])
    assert ours.max_slope(0.5, percents) == theirs.max_slope(0.5, percents)


def test_no_noise_vs_reference():
    ts, ys, lin, K, us = port("bioreactor_closedloop.no_noise").simulate(
        end_time=5, dt_control=1, device=CPU)[:5]
    ts_r, ys_r, _, _, us_r = ref("bioreactor_closedloop.no_noise").simulate(
        end_time=5, dt_control=1)[:5]
    np.testing.assert_array_equal(ts, ts_r)
    assert np.abs(us - us_r).max() < 2e-4
    assert np.abs(ys - ys_r).max() < 0.5


def _printed(fn, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(**kw)
    return buf.getvalue()


@pytest.mark.parametrize("name", ["controller_params", "state_meas_noise"])
def test_print_latex_equals_reference(name):
    got = _printed(port(f"print_latex.{name}").main)
    want = _printed(ref(f"print_latex.{name}").main)
    assert got == want
    assert "matrix" in got


# ----------------------------------------------------------------------
# the summaries' keys and shapes against the reference's
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mod, n", [("pf_closedloop.bioreactor_performance_pf",
                                     64),
                                    ("gsf_closedloop.bioreactor_performance_gsf",
                                     16)])
@pytest.mark.parametrize("fn", ["get_sim_summary", "get_sim_summary_device"])
def test_sim_summary_keys_equal_reference(mod, n, fn):
    got = getattr(port(mod), fn)(n, 1.0, 1.0, 0, end_time=5, device=CPU)
    want = getattr(ref(mod), fn)(n, 1.0, 1.0, 0, end_time=5)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.shape(got[k]) == np.shape(want[k]), k
    assert np.isfinite(got["performance"]) and 0 <= got["mpc_frac"] <= 1
    assert got["runtime_raw" if "runtime_raw" in got else "runtime"] > 0


def test_breakdown_keys_equal_reference():
    got = port("_filter_bench").breakdown_pf(2**8, 2, gpu=False)
    want = ref("_filter_bench").breakdown_pf(2**8, 2, gpu=False)
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape and (got[k] > 0).all(), k


def test_energy_per_run_shape_equals_reference(monkeypatch):
    from gpu_se_tpu_torch.utils import power

    monkeypatch.setattr(power, "_card_id", lambda: None)
    got = port("pf_openloop.pf_power").energy_per_run(
        t_run=0.2, gpu=False, log2s=np.array([6.0]))
    want = ref("pf_openloop.pf_power").energy_per_run(
        t_run=0.2, gpu=False, log2s=np.array([6.0]))
    assert len(got) == len(want) == 1 and len(got[0]) == len(want[0]) == 3
    (n, e_cpu, e_card), = got
    assert n == want[0][0] == 64
    assert np.isnan(e_card) and np.isnan(want[0][2])
    assert np.isnan(e_cpu) or e_cpu >= 0


def test_mpc_run_seq_shape_equals_reference():
    got = port("bioreactor_closedloop.mpc_run_seq").mpc_run_seq(
        n_runs=3, dt_control=10.0, device=CPU)
    want = ref("bioreactor_closedloop.mpc_run_seq").mpc_run_seq(
        n_runs=3, dt_control=10.0)
    assert got.shape == want.shape == (3,) and (got > 0).all()


def test_device_solve_ms_on_cpu():
    ms, iters = port("bioreactor_closedloop.mpc_run_seq").device_solve_ms(
        dt_control=10.0, k1=1, k2=2, reps=1, device=CPU)
    assert np.isfinite(ms) and iters >= 1


def test_pacf_series_small():
    out = port("pacf_series").pacf_series(n=256, k=2, reps=12, gpu=False)
    assert len(out["series_ms"]) == 12 and out["median_rep_ms"] > 0
    assert 0 <= out["max_abs_pacf"] and out["gate_passed"] == (
        out["max_abs_pacf"] < 0.2)
    assert out["chain"].startswith("eager") and "device_series_ms" not in out


def test_pacf_series_reps_start_near_the_same_particles(monkeypatch):
    """Every rep's input lies within 1e-4 of the warm-up's, as the
    reference's ``tiled0 + 1e-9 * seed`` with ``seed = |N(0, 1)| 1e4``;
    the host split and the clock fields are recorded."""
    ps = port("pacf_series")
    inputs, chain = [], ps.chain_steps

    def spy(x, *args):
        inputs.append(x.clone())
        return chain(x, *args)

    monkeypatch.setattr(ps, "chain_steps", spy)
    out = ps.pacf_series(n=256, k=1, reps=12, gpu=False)
    x_init, reps = inputs[0], inputs[1:]
    assert len(reps) == 12
    for x in reps:
        assert float((x - x_init).abs().max()) <= 1e-4
    assert any(not torch.equal(x, x_init) for x in reps)
    assert len(out["launch_series_ms"]) == len(out["sync_series_ms"]) == 12
    assert out["sm_clock_mhz"] == {"before": None, "after": None}
    rng = np.random.default_rng(0)
    offsets = [ps.rep_offset(rng) for _ in range(1000)]
    assert 0 <= min(offsets) and max(offsets) <= 1e-4


def test_pacf_chain_body_equals_k_eager_steps():
    """The body a graph captures on the card is K tiled steps, equal to
    K calls of ``particle_tiled.step`` from the same generator state."""
    ps, fb = port("pacf_series"), port("_filter_bench")
    from gpu_se_tpu_torch.filters import particle_tiled as tpt
    from gpu_se_tpu_torch.models import bioreactor as tbio

    _, x0, state_pdf, meas_pdf = fb.rig_dists(torch.device(CPU))
    u, z, dt = fb.rig_inputs(torch.device(CPU))
    x = x0.draw_t(torch.Generator().manual_seed(3), 512)
    got = ps.chain_steps(x, torch.Generator().manual_seed(4), ps.K, u, z,
                         dt, state_pdf, meas_pdf)
    st = tpt.TiledPFState(x, torch.Generator().manual_seed(4))
    for _ in range(ps.K):
        st = tpt.step(st, u, z, dt, tbio.homeostatic_des,
                      tbio.static_outputs, state_pdf, meas_pdf)
    assert torch.equal(got, st.x) and torch.isfinite(got).all()


def test_graphed_pacf_series_needs_the_card():
    with pytest.raises(ValueError, match="needs the card"):
        port("pacf_series").pacf_series(256, 2, 3, gpu=False, graphed=True)
    assert port("pacf_series").drift([1.0] * 30 + [2.0] * 30) == 1.0


# ----------------------------------------------------------------------
# no CPU data under the card's label
# ----------------------------------------------------------------------
def _card_entries():
    fb = port("_filter_bench")
    return {
        "get_device": lambda: fb.get_device(True),
        "build": lambda: fb.build("pf", 64, True),
        "run_seq": lambda: fb.run_seq("pf", "step", 64, 3, True),
        "breakdown_pf": lambda: fb.breakdown_pf(64, 2, True),
        "step_run_seq": lambda: port("pf_openloop.pf_run_seq").step_run_seq(
            np.array([64]), 3, True),
        "gsf_run_seq": lambda: port("gsf_openloop.gsf_run_seq")
        .sigma_points_run_seq(np.array([16]), 3, True),
        "pf_power": lambda: port("pf_openloop.pf_power").energy_per_run(
            0.1, True, np.array([4.0])),
        "gsf_power": lambda: port("gsf_openloop.gsf_power").energy_per_run(
            0.1, True, np.array([4.0])),
        "pacf_series": lambda: port("pacf_series").pacf_series(256, 2, 3),
        "campaign": lambda: port("campaign").card_info(),
    }


@pytest.mark.parametrize("entry", sorted(_card_entries()))
def test_gpu_true_raises_without_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA card"):
        _card_entries()[entry]()


@pytest.mark.parametrize("plot", ["pf_openloop.pf_run_seq",
                                  "gsf_openloop.gsf_run_seq",
                                  "pf_openloop.pf_power"])
def test_plot_without_card_memos_raises(plot, monkeypatch):
    """With the jar empty and no card, a figure raises before it computes
    anything on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    mod = port(plot)
    monkeypatch.setattr(port("_common"), "card_label", lambda: "a card")
    monkeypatch.setattr(mod, "card_label", lambda: "a card")
    fb = port("_filter_bench")
    built = []
    real_build = fb.build
    monkeypatch.setattr(fb, "build", lambda *a: built.append(a) or
                        real_build(*a))
    with pytest.raises(RuntimeError, match="CUDA card"):
        mod.plot(2) if "power" not in plot else mod.plot(0.1)
    assert all(gpu for *_, gpu in built)


def _fake_card_memos(name):
    """Write the card's memos a closed-loop figure reads, small and made
    up, into the test's jar."""
    from gpu_se_tpu_torch.utils.cache import argument_hash

    mod = port(f"bioreactor_closedloop.{name}")
    ts = np.linspace(0, 5, 50)
    rng = np.random.default_rng(0)
    tr = {"device": "a card", "ts": ts, "ys": rng.random((50, 5)),
          "ys_meas": rng.random((50, 5)), "us": rng.random((50, 2)),
          "biass": rng.random((4, 2)), "ysp": np.array([0.5, 0.6]),
          "inputs": [0, 1], "outputs": [0, 2], "itse": 1.0,
          "dt_control": 1, "end_time": 5}
    if name == "performance_vs_control_period":
        fn = mod.get_simulation_performance
        calls = [((float(dtc), mc), 1.0 + mc) for dtc in np.logspace(
            np.log10(0.1), np.log10(30), 12) for mc in range(3)]
    else:
        fn = mod.trajectory if name == "no_noise" else mod.noisy_trajectory
        calls = [((), tr)]
    for args, value in calls:
        fn._check_code()
        fn.store_backend.write_atomic(
            fn.store_backend.memo_path(argument_hash(fn.func, args, {})),
            pickle.dumps(value))
    return mod


CLOSED_LOOP_PLOTS = ["no_noise", "with_noise",
                     "performance_vs_control_period"]


@pytest.mark.parametrize("name", CLOSED_LOOP_PLOTS)
def test_closed_loop_plot_reads_card_memos(name, monkeypatch, tmp_path):
    """The figure draws from the card's memos, on a host without a card
    too, and computes nothing."""
    pytest.importorskip("matplotlib")
    mod = _fake_card_memos(name)
    monkeypatch.setattr(port("_common"), "FIG_DIR", str(tmp_path / "figs"))
    monkeypatch.setattr(port("_common"), "card_label", lambda: "a card")
    monkeypatch.setattr(mod, "simulate", None, raising=False)
    if name == "performance_vs_control_period":
        monkeypatch.setattr(mod, "card_label", lambda: "a card")
        monkeypatch.setattr(mod.sim, "get_parts", None)
    path = mod.plot()
    assert os.path.exists(path) and str(tmp_path) in path


@pytest.mark.parametrize("name", CLOSED_LOOP_PLOTS)
def test_closed_loop_plot_without_card_memo_raises(name, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    mod = port(f"bioreactor_closedloop.{name}")
    monkeypatch.setattr(mod.sim, "get_parts", None)
    with pytest.raises(RuntimeError, match="CUDA card"):
        mod.plot()


def test_closed_loop_trajectory_memo_on_the_cpu():
    """The memoized trajectories, on the CPU, label their device and
    carry the loop's ITSE; the second call reads the memo."""
    mod = port("bioreactor_closedloop.no_noise")
    tr = mod.trajectory(end_time=5, dt_control=1, device=CPU)
    assert tr["device"] == "CPU" and np.isfinite(tr["itse"])
    assert tr["ys"].shape == (len(tr["ts"]), 5)
    again = mod.trajectory(end_time=5, dt_control=1, device=CPU)
    np.testing.assert_array_equal(again["us"], tr["us"])
    noisy = port("bioreactor_closedloop.with_noise").noisy_trajectory(
        end_time=5, dt_control=1, seed=1, device=CPU)
    assert noisy["device"] == "CPU" and np.isfinite(noisy["ys_meas"]).all()


def test_card_label(monkeypatch, tmp_path):
    common = port("_common")
    if torch.cuda.is_available():
        assert common.card_label() == torch.cuda.get_device_name()
        return
    monkeypatch.setattr(common, "ARTIFACT", str(tmp_path / "missing.json"))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        common.card_label()
    art = tmp_path / "a.json"
    art.write_text('{"card": {"name": "NVIDIA H100 80GB HBM3"}}')
    monkeypatch.setattr(common, "ARTIFACT", str(art))
    assert common.card_label() == "NVIDIA H100 80GB HBM3"


def test_campaign_artifact_records_each_size(monkeypatch, tmp_path):
    """The artifact is rewritten after every size, with the leg still
    "running", and a failing leg raises out of ``main``."""
    camp = port("campaign")
    card = {"name": "a card", "nvidia_smi": "a card, 700.00 W"}
    monkeypatch.setattr(camp, "card_info", lambda: card)
    monkeypatch.setattr(camp._common, "ARTIFACT", str(tmp_path / "none.json"))
    seen = []

    def fake(ns, runs, gpu):
        seen.append((int(ns[0]), gpu))
        if len(seen) == 3:
            raise RuntimeError("a size failed")
        return ns, np.array([np.linspace(1e-3, 2e-3, runs)])

    # the unmemoized function a card row's eager timing calls
    fake.raw = lambda n, runs, gpu: np.linspace(2e-3, 3e-3, runs)
    monkeypatch.setattr(camp, "RUNS", 10)
    monkeypatch.setattr(camp, "LEG_FNS", {"pf_run_seq": lambda art:
                                          camp.run_seq_legs(
                                              art, art.start("pf_run_seq"),
                                              [("step", fake)],
                                              {"card": (True, [1.0, 2.0, 3.0])})})
    out = tmp_path / "out.json"
    with pytest.raises(RuntimeError, match="a size failed"):
        camp.main(["--out", str(out), "pf_run_seq"])
    import json

    data = json.loads(out.read_text())
    leg = data["legs"]["pf_run_seq"]
    assert data["card"] == card and leg["status"] == "running"
    assert [r["n"] for r in leg["sizes"]["card"]["step"]] == [2, 4]


# ----------------------------------------------------------------------
# tests/test_experiments.py's cheap-argument cases, one for one
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mod", MODULES)
def test_imports(mod):
    importlib.import_module(mod)


def test_no_noise_short():
    ts, ys, lin_model, K, us, dt_control, biass, end_time = port(
        "bioreactor_closedloop.no_noise").simulate(end_time=5, dt_control=1,
                                                   device=CPU)
    assert np.isfinite(ys).all() and np.isfinite(us).all()


def test_staged_openloop_short():
    ts, us, xs, ys, ys_meas = port("_common").openloop_staged_run(
        end_time=30, schedule=SCHEDULE, X0=X0, noisy=True)
    assert ys.shape == (len(ts), 5)
    assert np.isfinite(ys_meas).all()


def test_run_seq_tiny():
    times = port("_filter_bench").run_seq("pf", "step", 64, 3, gpu=False)
    assert times.shape == (3,)
    assert (times > 0).all()


def test_print_latex_runs(capsys):
    port("print_latex.state_meas_noise").main()
    port("print_latex.controller_params").main()
    out = capsys.readouterr().out
    assert "matrix" in out or "\\" in out


def test_batch_production_growth_short():
    ts, us, xs, ys, ys_meas = port(
        "bioreactor_openloop.batch_production_growth").simulate(end_time=30)
    assert np.isfinite(ys).all() and ys.shape[1] == 5


def test_ss2ss_short():
    ts, us, xs, ys, ys_meas = port("bioreactor_openloop.ss2ss").simulate(
        end_time=30)
    assert np.isfinite(ys).all() and np.isfinite(ys_meas).all()


def test_step_tests_small_grid():
    slope, arg = port("bioreactor_openloop.step_tests").max_slope(
        dt=0.5, percents=np.array([0.9, 1.1]))
    assert np.isfinite(slope) and slope > 0 and arg is not None


def test_with_noise_short():
    out = port("bioreactor_closedloop.with_noise").simulate(
        end_time=5, dt_control=1, seed=1, device=CPU)
    assert np.isfinite(np.asarray(out[1])).all()


def test_performance_vs_control_period_one_point():
    perf = port("bioreactor_closedloop.performance_vs_control_period"
                ).get_simulation_performance(30.0, 0, device=CPU)
    assert np.isfinite(float(perf))


def test_mpc_run_seq_cheap():
    times = port("bioreactor_closedloop.mpc_run_seq").mpc_run_seq(
        n_runs=3, dt_control=10.0, device=CPU)
    assert times.shape == (3,) and (times > 0).all()


def test_pf_run_seq_entries_cheap():
    mod = port("pf_openloop.pf_run_seq")
    ns = np.array([64])
    for entry in (mod.predict_run_seq, mod.update_run_seq,
                  mod.resample_run_seq, mod.step_run_seq):
        _, res = entry(ns, 2, False)
        assert np.asarray(res[0]).shape == (2,)


def test_pf_breakdown_small():
    rows = port("_filter_bench").breakdown_pf(2**8, 2, gpu=False)
    for stage in ("dynamics", "noise", "indices", "gather"):
        assert stage in rows and np.isfinite(rows[stage]).all()


def test_pf_power_cheap():
    rows = port("pf_openloop.pf_power").energy_per_run(
        t_run=0.2, gpu=False, log2s=np.array([6.0]))
    (n, e_cpu, e_accel), = rows
    assert n == 64 and (np.isnan(e_cpu) or e_cpu >= 0)
    from gpu_se_tpu_torch.utils import accelerator_probe_available

    if not accelerator_probe_available():
        assert np.isnan(e_accel)


def test_pf_closedloop_summary_short():
    mod = port("pf_closedloop.bioreactor_performance_pf")
    s = mod.get_sim_summary(64, 1.0, 1.0, 0, end_time=5, device=CPU)
    assert np.isfinite(s["performance"]) and 0 <= s["mpc_frac"] <= 1
    assert mod.utilization(s, 1.0) > 0


def test_gsf_run_seq_entries_cheap():
    mod = port("gsf_openloop.gsf_run_seq")
    ns = np.array([16])
    for entry in (mod.predict_run_seq, mod.update_run_seq,
                  mod.resample_run_seq, mod.sigma_points_run_seq):
        _, res = entry(ns, 2, False)
        assert np.asarray(res[0]).shape == (2,)
    ns, noop = mod.noop_run_seq(np.array([16]), 3, False)
    assert (noop >= 0).all()


def test_gsf_power_cheap():
    rows = port("gsf_openloop.gsf_power").energy_per_run(
        t_run=0.2, gpu=False, log2s=np.array([4.0]))
    (n, e_cpu, e_accel), = rows
    assert n == 16 and (np.isnan(e_cpu) or e_cpu >= 0)


def test_gsf_closedloop_summary_short():
    s = port("gsf_closedloop.bioreactor_performance_gsf").get_sim_summary(
        16, 1.0, 1.0, 0, end_time=5, device=CPU)
    assert np.isfinite(s["performance"]) and 0 <= s["mpc_frac"] <= 1


def test_pf_closedloop_device_summary_short():
    s = port("pf_closedloop.bioreactor_performance_pf").get_sim_summary_device(
        64, 1.0, 1.0, 0, end_time=5, device=CPU)
    assert np.isfinite(s["performance"]) and 0 <= s["mpc_frac"] <= 1
    assert s["runtime"] >= 0 and s["runtime_raw"] > 0


def test_gsf_closedloop_device_summary_short():
    s = port("gsf_closedloop.bioreactor_performance_gsf"
             ).get_sim_summary_device(16, 1.0, 1.0, 0, end_time=5, device=CPU)
    assert np.isfinite(s["performance"]) and 0 <= s["mpc_frac"] <= 1
    assert s["runtime"] >= 0


# ----------------------------------------------------------------------
# a host like the card's: no jax, joblib, matplotlib or sympy
# ----------------------------------------------------------------------
def test_results_run_without_jax_joblib_matplotlib_sympy(tmp_path):
    code = f"""
import sys, time
for m in ("jax", "joblib", "matplotlib", "sympy", "gpu_se_tpu", "results"):
    sys.modules[m] = None
import importlib
import numpy as np
for m in {MODULES!r}:
    importlib.import_module(m)
from gpu_se_tpu_torch.results.pf_openloop import pf_run_seq
from gpu_se_tpu_torch.results._filter_bench import run_seq
calls = []
real = pf_run_seq.run_seq
pf_run_seq.run_seq = lambda *a: calls.append(a) or real(*a)
_, (a,) = pf_run_seq.step_run_seq(np.array([64]), 3, False)
_, (b,) = pf_run_seq.step_run_seq(np.array([64]), 3, False)
assert calls == [("pf", "step", 64, 3, False)], calls
assert a.shape == (3,) and (a == b).all()
importlib.import_module("gpu_se_tpu_torch.results.print_latex.controller_params")
loaded = [k for k, v in sys.modules.items() if v is not None]
assert not [k for k in loaded if k.split(".")[0] in
            ("jax", "joblib", "matplotlib", "sympy", "gpu_se_tpu", "results")]
print("ok")
"""
    env = {**os.environ, cache.ROOT_ENV: str(tmp_path / "jar")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
    assert list((tmp_path / "jar" / "pf" / "raw" / "step_run_seq").glob(
        "*.pkl"))
