"""The import guard compares whole top-level names, a run's modules hold
no JAX, and the profiler summary reads busy and idle time off device
timestamps."""
from __future__ import annotations

import subprocess
import sys

import pytest

from port_bench import run, tracing


@pytest.mark.parametrize("name, refused", [
    ("gpu_se_tpu_torch", False),
    ("gpu_se_tpu_torch.filters.particle", False),
    ("gpu_se_tpu_torchvision", False),
    ("gpu_se_tpu", True),
    ("gpu_se_tpu.filters", True),
    ("jax", True),
    ("jax._src.core", True),
    ("jaxlib", True),
    ("flax.linen", True),
    ("jaxtyping", False),
    ("numpy", False),
])
def test_guard_compares_whole_top_level_names(name, refused):
    assert bool(run.forbidden_modules({name: None})) == refused


def test_the_benchmark_and_the_port_load_no_jax():
    code = (
        "import sys; sys.path.insert(0, '.');"
        "import port_bench.run, port_bench.drivers.stream,"
        " port_bench.drivers.closed_loop, port_bench.estimators.pf,"
        " port_bench.estimators.gsukf, port_bench.faults;"
        "from port_bench import manifest;"
        "[manifest.metric_reader(p['name'])"
        " for p in manifest.load_manifest()['per_layer']];"
        "import gpu_se_tpu_torch.sim.loop, gpu_se_tpu_torch.sim.harness;"
        "print(port_bench.run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(run.ROOT), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_run_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload",
         "pf_2p20_stream", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=str(run.ROOT), timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(run.ROOT)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


class _Event:
    def __init__(self, kind, start, dur, name, corr=0, link=0,
                 activity=""):
        self._v = dict(device_type=kind, start_ns=start, duration_ns=dur,
                       name=name, correlation_id=corr,
                       linked_correlation_id=link, activity_type=activity)

    def __getattr__(self, attr):
        if attr in self._v:
            return lambda: self._v[attr]
        raise AttributeError(attr)


def test_summary_of_a_device_timeline():
    cuda, cpu = "DeviceType.CUDA", "DeviceType.CPU"
    events = [
        _Event(cpu, 0, 100, "bench.update"),
        _Event(cpu, 10, 5, "cudaGraphLaunch", corr=7,
               activity="cuda_runtime"),
        _Event(cpu, 50, 5, "cudaLaunchKernel", corr=8,
               activity="cuda_runtime"),
        _Event(cuda, 1000, 300, "gemv", link=7),
        _Event(cuda, 1200, 200, "exp", link=7),       # overlaps
        _Event(cuda, 1900, 100, "gemv", link=8),      # after a 500 ns gap
        _Event(cuda, 900, 1200, "bench.update",
               activity="gpu_user_annotation"),      # not device work
    ]
    s = tracing.summarize(events)
    assert s["window_s"] == pytest.approx(1000e-9)
    assert s["busy_s"] == pytest.approx(500e-9)
    ops = dict(s["breakdown"]["device_ops"])
    assert ops["gemv"] == pytest.approx(400e-9)
    assert s["breakdown"]["idle_gaps"] == [
        ["bench.update/cudaLaunchKernel", pytest.approx(500e-9)]]


def test_summary_of_no_device_work_is_empty():
    assert tracing.summarize([_Event("DeviceType.CPU", 0, 1, "x")]) == {}
