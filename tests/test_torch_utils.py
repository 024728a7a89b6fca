"""The port's instrumentation against the reference's, on the CPU.

``stats`` and ``run_sequences`` are the reference's numpy code: the same
series give the same numbers. ``PickleJar`` passes the reference's cases
with its jar under ``tmp_path``, and its default root is not the
reference's. ``PowerMeasurement`` integrates its probes' readings (a
constant gives the exact joules) and reports a missing reading as NaN,
never 0. ``StateCheckpointer`` round-trips a filter state, resumes a run
with its generator so that the draws equal an unbroken run's, and keeps
the newest ``max_to_keep`` steps.
"""
import collections
import os
import time

import numpy as np
import pytest
import torch

from gpu_se_tpu.utils import cache as ref_cache
from gpu_se_tpu.utils import stats as ref_stats
from gpu_se_tpu_torch import rig, utils
from gpu_se_tpu_torch.distributions import GaussianSum
from gpu_se_tpu_torch.filters import particle as pf
from gpu_se_tpu_torch.models import bioreactor as bio
from gpu_se_tpu_torch.utils import cache, power
from gpu_se_tpu_torch.utils.checkpoint import StateCheckpointer


# ----------------------------------------------------------------------
# stats and run sequences
# ----------------------------------------------------------------------
def _series(kind, n=2000, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "white":
        return rng.normal(size=n)
    if kind == "walk":
        return rng.normal(size=n).cumsum()
    x = np.zeros(n)
    for i in range(1, n):
        x[i] = 0.8 * x[i - 1] + rng.normal()
    return x


@pytest.mark.parametrize("kind", ["white", "walk", "ar1", "constant"])
@pytest.mark.parametrize("nlags", [0, 1, 10])
def test_stats_equal_the_reference(kind, nlags):
    x = np.ones(64) if kind == "constant" else _series(kind)
    np.testing.assert_array_equal(utils.acf(x, nlags), ref_stats.acf(x, nlags))
    np.testing.assert_array_equal(utils.pacf(x, nlags),
                                  ref_stats.pacf(x, nlags))
    if nlags:
        assert utils.max_abs_pacf(x, nlags) == ref_stats.max_abs_pacf(x, nlags)


def test_pacf_gate():
    """White noise passes the 0.2 gate, an AR(1) of 0.8 fails it."""
    assert utils.max_abs_pacf(_series("white", 4000), 10) < 0.1
    p = utils.pacf(_series("ar1", 4000, seed=1), 5)
    assert p[1] == pytest.approx(0.8, abs=0.05)
    assert np.abs(p[2:]).max() < 0.08
    assert utils.max_abs_pacf(_series("ar1", 4000, seed=1), 10) > 0.2


def test_run_sequences():
    @utils.RunSequences.vectorize
    def bench(n, scale):
        return np.arange(3) * n * scale

    ns, seqs = bench([1, 2, 4], 10)
    np.testing.assert_array_equal(ns, [1, 2, 4])
    assert seqs.shape == (3, 3)
    np.testing.assert_array_equal(seqs[2], np.arange(3) * 40)

    @utils.RunSequences.vectorize
    def ragged(n):
        return n, np.array([1.0, 2.0])

    ns, seqs = ragged(np.array([2, 8]))
    assert isinstance(seqs, list) and seqs[1][0] == 8


# ----------------------------------------------------------------------
# the jar
# ----------------------------------------------------------------------
@pytest.fixture
def jar(tmp_path):
    calls = {"n": 0}

    @cache.PickleJar.pickle("test_cache", root=str(tmp_path))
    def slow_square(x):
        calls["n"] += 1
        return x * x

    return slow_square, calls, tmp_path


def test_picklejar_memoizes(jar):
    slow_square, calls, tmp_path = jar
    assert slow_square(7) == 49
    assert calls["n"] == 1
    assert slow_square(7) == 49
    assert calls["n"] == 1  # served from disk
    slow_square.clear_single(7)
    assert slow_square(7) == 49
    assert calls["n"] == 2  # recomputed after clear
    assert os.path.isdir(tmp_path / "test_cache" / "slow_square")
    for _dir, _sub, files in os.walk(tmp_path):
        assert ".gitignore" not in files


def test_picklejar_force_rerun(jar):
    slow_square, calls, _ = jar
    slow_square(3)
    utils.global_cache_settings["force_rerun"] = True
    try:
        slow_square(3)
        assert calls["n"] == 2
    finally:
        utils.global_cache_settings["force_rerun"] = False


def test_picklejar_root_is_not_the_references(monkeypatch, tmp_path):
    """Memos are keyed by function name: the port's jar must not be the
    reference's ``picklejar/``, whatever the reference's variable says."""
    monkeypatch.delenv(cache.ROOT_ENV, raising=False)
    monkeypatch.setenv("GPU_SE_PICKLEJAR_ROOT", str(tmp_path / "ref"))
    root = cache.default_root()
    assert os.path.dirname(root) == ref_cache._REPO_ROOT
    ref_root = os.path.join(ref_cache._REPO_ROOT, "picklejar")
    assert os.path.commonpath([root, ref_root]) != ref_root
    assert root != str(tmp_path / "ref")
    monkeypatch.setenv(cache.ROOT_ENV, str(tmp_path / "port"))
    assert cache.default_root() == str(tmp_path / "port")
    jar_fn = cache.PickleJar(lambda x: x, "pf/raw")
    assert str(jar_fn.store_backend.location).startswith(
        str(tmp_path / "port"))


def test_utils_import_without_joblib():
    """``cache`` is imported on first use: the rest of ``utils`` imports
    where joblib is missing."""
    import subprocess
    import sys
    code = ("import sys\nsys.modules['joblib'] = None\n"
            "from gpu_se_tpu_torch.utils import (RunSequences, "
            "PowerMeasurement, StateCheckpointer, acf, pacf, max_abs_pacf,"
            " accelerator_probe_available)\nprint('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          cwd=os.path.dirname(os.path.dirname(__file__)))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_picklejar_without_joblib(tmp_path):
    """The jar's cases above, in a process where joblib is missing (the
    card's machine has none)."""
    import subprocess
    import sys
    code = f"""
import os, sys
sys.modules['joblib'] = None
from gpu_se_tpu_torch import utils
from gpu_se_tpu_torch.utils import cache
calls = []
@cache.PickleJar.pickle("test_cache", root={str(tmp_path)!r})
def slow_square(x):
    calls.append(x)
    return x * x
assert slow_square(7) == 49 and slow_square(7) == 49 and calls == [7]
slow_square.clear_single(7)
assert slow_square(7) == 49 and calls == [7, 7]
assert os.path.isdir(os.path.join({str(tmp_path)!r}, "test_cache", "slow_square"))
utils.global_cache_settings["force_rerun"] = True
slow_square(7)
assert calls == [7, 7, 7]
os.environ[cache.ROOT_ENV] = {str(tmp_path / "port")!r}
assert cache.PickleJar(lambda x: x, "pf/raw").store_backend.location \\
    .startswith({str(tmp_path / "port")!r})
assert "joblib" not in [k for k, v in sys.modules.items() if v is not None]
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          cwd=os.path.dirname(os.path.dirname(__file__)))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_picklejar_keys_by_bound_arguments(tmp_path):
    """A call by position and one by keyword, defaults filled in, share a
    memo; arrays key by dtype, shape and bytes."""
    calls = []

    @cache.PickleJar.pickle("keys", root=str(tmp_path))
    def f(x, scale=2):
        calls.append(x)
        return np.asarray(x) * scale

    f(3)
    f(x=3)
    f(3, scale=2)
    assert len(calls) == 1
    f(np.arange(3, dtype=np.int64))
    f(np.arange(3, dtype=np.int32))
    f(np.arange(3, dtype=np.int64).reshape(3, 1))
    f(np.arange(3, dtype=np.int64))
    assert len(calls) == 4
    assert cache.argument_hash(f.func, (3,), {}) == cache.argument_hash(
        f.func, (), {"x": 3, "scale": 2})


@pytest.mark.parametrize("same_code", [True, False])
def test_picklejar_source_change(tmp_path, same_code):
    """``force_same_code`` keeps a memo whose function's source changed;
    without it the memo is dropped."""
    calls = []
    settings = {"force_rerun": False, "force_same_code": same_code}

    def f(x):
        calls.append(x)
        return x + 1

    jar_fn = cache.PickleJar(f, "code", cache_settings=settings,
                             root=str(tmp_path))
    jar_fn(1)
    code_file = os.path.join(jar_fn.store_backend.func_dir, cache.CODE_FILE)
    with open(code_file) as fh:
        assert fh.read() == cache.function_source(f)
    with open(code_file, "w") as fh:
        fh.write("def f(x):\n    return x + 2\n")
    assert jar_fn(1) == 2
    assert calls == ([1] if same_code else [1, 1])
    with open(code_file) as fh:
        assert fh.read() == cache.function_source(f)


def test_picklejar_writes_atomically(tmp_path):
    import pickle

    jar_fn = cache.PickleJar(lambda x: {"x": np.full(4, x)}, "atomic",
                             root=str(tmp_path))
    jar_fn(5)
    files = os.listdir(jar_fn.store_backend.func_dir)
    assert not [f for f in files if f.startswith(".tmp")]
    (memo,) = [f for f in files if f.endswith(".pkl")]
    with open(os.path.join(jar_fn.store_backend.func_dir, memo), "rb") as fh:
        np.testing.assert_array_equal(pickle.load(fh)["x"], np.full(4, 5))


# ----------------------------------------------------------------------
# energy per run
# ----------------------------------------------------------------------
def _busy(n, t_run):
    t0 = time.time()
    while time.time() - t0 < t_run:
        sum(range(1000))
    return n * 2


def _probes(monkeypatch, watts, cpu):
    monkeypatch.setattr(power, "_card_id", lambda: "GPU-test")
    monkeypatch.setattr(power, "_read_nvidia_smi", lambda card: watts)

    class Share:
        def __call__(self):
            return cpu

    monkeypatch.setattr(power, "_CpuShare", Share)


def test_power_constant_probes_give_exact_joules(monkeypatch):
    _probes(monkeypatch, 250.0, 0.5)
    measured = power.PowerMeasurement(_busy, CPU_max_power=30.0)
    res, energy = measured(21, 0.5)
    assert res == 42
    ts = measured.last_samples[0]
    assert len(ts) >= 3
    span = ts[-1] - ts[0]
    assert span >= 0.5
    assert energy[1] == pytest.approx(250.0 * span, rel=1e-12)
    assert energy[0] == pytest.approx(0.5 * 30.0 * span, rel=1e-12)


def test_power_without_readings_is_nan_never_zero(monkeypatch):
    _probes(monkeypatch, None, float("nan"))
    _, energy = power.PowerMeasurement(lambda n, t: n)(1, 0.0)
    assert np.isnan(energy).all()
    # no card at all: the card's energy is NaN; the CPU's is a reading
    # or NaN, never 0
    monkeypatch.undo()
    monkeypatch.setattr(power, "_card_id", lambda: None)
    _, energy = power.PowerMeasurement(_busy)(1, 0.3)
    assert np.isnan(energy[1])
    assert energy[0] > 0 or np.isnan(energy[0])


def test_power_probe_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert power.get_accelerator_power() is None
    assert not utils.accelerator_probe_available()


def test_cpu_share_from_psutil_counters(monkeypatch):
    T = collections.namedtuple("T", "user nice system idle iowait guest "
                               "guest_nice")
    readings = iter([T(10, 0, 5, 100, 1, 2, 0), T(13, 0, 6, 104, 1, 3, 0),
                     T(13, 0, 6, 104, 1, 3, 0)])
    monkeypatch.setattr(power.psutil, "cpu_times", lambda: next(readings))
    share = power._CpuShare()
    assert share() == pytest.approx(4 / 8)   # busy 4 of 8: guest is in user
    assert np.isnan(share())                 # the counters did not advance


# ----------------------------------------------------------------------
# checkpoints
# ----------------------------------------------------------------------
def _pf_rig(n=64, seed=0):
    x0 = GaussianSum.create(np.stack([rig.X_SS, rig.X_SS]),
                            np.stack([np.eye(5) * 1e-4, np.eye(5) * 1e-3]),
                            np.array([0.75, 0.25]), device="cpu")
    state_pdf = GaussianSum.create(np.zeros((1, 5)), np.eye(5)[None] * 1e-4,
                                   np.array([1.0]), device="cpu")
    meas_pdf = GaussianSum.create(np.zeros((1, 2)), np.eye(2)[None] * 1e-1,
                                  np.array([1.0]), device="cpu")
    gen = torch.Generator().manual_seed(seed)
    return pf.init(gen, n, x0), state_pdf, meas_pdf


def _steps(state, state_pdf, meas_pdf, k=2):
    u = torch.tensor([0.06, 0.2])
    z = bio.static_outputs(torch.from_numpy(rig.X_SS)).to(torch.float32)
    for _ in range(k):
        state = pf.step(state, u, z, 0.1, bio.homeostatic_des,
                        bio.static_outputs, state_pdf, meas_pdf)
    return state


def test_checkpoint_roundtrip(tmp_path):
    state, _, _ = _pf_rig(32)
    ckpt = StateCheckpointer(str(tmp_path / "ckpt"))
    with pytest.raises(FileNotFoundError):
        ckpt.restore(state)
    ckpt.save(5, state)
    assert ckpt.latest_step() == 5
    restored = ckpt.restore(state)
    assert torch.equal(restored.particles, state.particles)
    assert torch.equal(restored.weights, state.weights)
    assert restored.generator is state.generator
    ckpt.close()


def test_checkpoint_resume_equals_an_unbroken_run(tmp_path):
    state, state_pdf, meas_pdf = _pf_rig()
    ckpt = StateCheckpointer(str(tmp_path))
    ckpt.save(0, state)
    unbroken = _steps(state, state_pdf, meas_pdf)
    # a restart: a fresh state whose generator is elsewhere in its stream
    target, _, _ = _pf_rig(seed=99)
    resumed = _steps(ckpt.restore(target), state_pdf, meas_pdf)
    assert torch.equal(resumed.particles, unbroken.particles)
    assert torch.equal(resumed.weights, unbroken.weights)
    assert torch.equal(resumed.generator.get_state(),
                       unbroken.generator.get_state())


def test_checkpoint_rolls_and_follows_the_target(tmp_path):
    ckpt = StateCheckpointer(str(tmp_path), max_to_keep=2)
    gen = torch.Generator().manual_seed(3)
    for step in (1, 4, 9):
        ckpt.save(step, {"x": torch.full((3,), float(step)), "k": step,
                         "pair": (torch.arange(2), gen)})
    assert ckpt.steps() == [4, 9] and ckpt.latest_step() == 9
    assert sorted(os.listdir(tmp_path)) == ["step_4.pt", "step_9.pt"]
    target = {"x": torch.zeros(3, dtype=torch.float64), "k": 0,
              "pair": (torch.zeros(2, dtype=torch.int64),
                       torch.Generator())}
    got = ckpt.restore(target, step=4)
    assert got["x"].dtype == torch.float64 and got["k"] == 4
    assert torch.equal(got["x"], torch.full((3,), 4.0, dtype=torch.float64))
    assert torch.equal(got["pair"][1].get_state(), gen.get_state())
    with pytest.raises(FileNotFoundError):
        ckpt.restore(target, step=1)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore({**target, "x": torch.zeros(4)})
