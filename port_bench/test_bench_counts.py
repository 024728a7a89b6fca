"""The least-time counts of the roofline metrics against hand-worked
values at small sizes, and the readers' answers from a made-up run."""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from port_bench import card, manifest

BW, OPS = 3.35e12, 67e12


def reader(name):
    return manifest.metric_reader(name)


def least(name, *args):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, manifest.PKG / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.least_seconds(*args)


PF = {"estimator": "pf", "n": 4, "nx": 5}
GS = {"estimator": "gsukf", "n": 4, "nx": 5}


@pytest.mark.parametrize("name, work, want", [
    # 4 rows of 5 floats read and written: 160 bytes; 4 * 85 operations
    ("predict_roofline", PF, max(160 / BW, 340 / OPS)),
    # means and the 15 distinct covariance entries, read and written
    ("predict_roofline", GS, max(640 / BW, 4 * 1640 / OPS)),
    # two measured columns and the weight read, the weight written
    ("update_roofline", PF, max(64 / BW, 120 / OPS)),
    ("update_roofline", GS, max(672 / BW, 4 * 730 / OPS)),
])
def test_stage_least_times(name, work, want):
    assert least(name, work) == pytest.approx(want, rel=1e-12)


def test_resample_least_time_counts_sure_survivors():
    # n w = [2, 1, 0.5, 0.5]: two rows are sure to survive
    w = torch.tensor([0.5, 0.25, 0.125, 0.125])
    got = least("resample_roofline", PF, w)
    assert got == pytest.approx((16 + 2 * 20 + 4 * 20 + 16) / BW, rel=1e-12)
    got = least("resample_roofline", GS, w)
    assert got == pytest.approx((16 + 2 * 80 + 4 * 80 + 16) / BW, rel=1e-12)


def test_an_unknown_estimator_has_no_count():
    work = {"estimator": "tiled", "n": 4, "nx": 5}
    assert least("predict_roofline", work) is None
    assert least("update_roofline", work) is None


def test_least_time_is_the_larger_bound():
    assert card.least_time(BW, 0) == pytest.approx(1.0)
    assert card.least_time(0, OPS) == pytest.approx(1.0)
    assert card.least_time(BW, 2 * OPS) == pytest.approx(2.0)


def _run(**kw):
    base = dict(stage_ms={}, work={}, resample_inputs=[], episodes=[],
                trace_data=None)
    base.update(kw)
    return SimpleNamespace(**base)


def test_readers_return_nothing_without_data():
    empty = _run()
    for name in ("predict_roofline", "update_roofline", "resample_roofline",
                 "device_idle_share.stream", "filter_step_ms_p99",
                 "admm_chunks_per_event", "admm_chunk_ms",
                 "qp_stalls_per_episode", "event_enqueue_ms"):
        assert reader(name)(empty) is None


def test_stage_share_from_times():
    n = 2 ** 20
    work = {"estimator": "pf", "n": n, "nx": 5}
    t = least("predict_roofline", work)
    run = _run(work=work, stage_ms={"predict": [t * 1e3 * 50] * 7})
    assert reader("predict_roofline")(run) == pytest.approx(2.0)


def test_loop_readers():
    eps = [{"events": 10, "enqueue_s": 0.02, "while_iterations": 30,
            "device_ms": 100.0, "unsolved": 1},
           {"events": 10, "enqueue_s": 0.04, "while_iterations": 50,
            "device_ms": 124.0, "unsolved": 2}]
    run = _run(episodes=eps)
    assert reader("admm_chunks_per_event")(run) == pytest.approx(4.0)
    assert reader("event_enqueue_ms")(run) == pytest.approx(3.0)
    assert reader("admm_chunk_ms")(run) == pytest.approx(1.2)
    assert reader("qp_stalls_per_episode")(run) == pytest.approx(1.5)


def test_chunk_time_needs_episodes_of_different_iterations():
    eps = [{"events": 10, "enqueue_s": 0.02, "while_iterations": 30,
            "device_ms": 100.0 + k, "unsolved": 0} for k in range(3)]
    assert reader("admm_chunk_ms")(_run(episodes=eps)) is None
    eps.append({"events": 10, "enqueue_s": 0.02, "while_iterations": 130,
                "device_ms": 220.0, "unsolved": 0})
    assert reader("admm_chunk_ms")(_run(episodes=eps)) == pytest.approx(
        1.19, abs=0.01)


def test_idle_share():
    run = _run(trace_data={"busy_s": 0.9, "window_s": 1.2})
    assert reader("device_idle_share.stream")(run) == pytest.approx(25.0)


def test_step_tail_from_stage_times():
    run = _run(stage_ms={"predict": [1.0] * 100, "update": [2.0] * 100,
                         "resample": [0.5] * 99 + [10.5]})
    assert reader("filter_step_ms_p99")(run) == pytest.approx(3.6, abs=0.01)


def _loop_recording(solve_site=True):
    """A closed-loop recording of one episode, shaped as the program
    records it: ``loop.start``, then ``loop.steps`` with a control step
    and a predict-only step, each a ``graphed.step`` on the card; the
    control step's graph holds the QP's solve, a site stamped inside it.
    Times in ns."""
    from gpu_se_tpu_torch import trace

    names = ["loop.start", "loop.steps", "loop.step", "graphed.step",
             "graphed._device_solve"]

    def i64(values):
        return np.asarray(values, dtype=np.int64)
    # host spans: start, steps, step (control), graphed, step, graphed
    dev = [(0, -1, 0, 0, 10), (3, -1, 1, 100, 400), (5, -1, 1, 500, 600)]
    dev_name = [0, 3, 3]
    if solve_site:
        # the solve inside the control step's graph: 200 of its 300 ns
        dev.insert(2, (-1, 1, 1, 150, 350))
        dev_name.insert(2, 4)
    return trace.Recording(
        names=names, name=np.asarray([0, 1, 2, 3, 2, 3], dtype=np.int32),
        attr=[None, None, (True, True), None, (True, False), None],
        parent=i64([-1, -1, 1, 2, 1, 4]), call=i64([0, 1, 1, 1, 1, 1]),
        start=i64([0, 50, 90, 95, 480, 490]),
        end=i64([20, 700, 450, 440, 650, 640]),
        mark=np.full((6, 2), -1, dtype=np.int64), dropped_spans=0,
        dev_name=np.asarray(dev_name, dtype=np.int32),
        dev_host=i64([d[0] for d in dev]),
        dev_parent=i64([d[1] for d in dev]),
        dev_call=i64([d[2] for d in dev]),
        dev_start=i64([d[3] for d in dev]), dev_end=i64([d[4] for d in dev]),
        while_time=i64([]), while_span=i64([]), if_time=i64([]),
        if_span=i64([]), stamps=2 * len(dev), clock_error_ns=(0, 0))


@pytest.mark.parametrize("solve_site", [True, False])
def test_control_event_time_outside_the_solve(solve_site, monkeypatch):
    from port_bench import program_spans

    rec = _loop_recording(solve_site)
    monkeypatch.setattr(program_spans, "_collect", lambda device: rec)
    said = []
    run = SimpleNamespace(device=torch.device("cuda", 0), attempted=2,
                          traffic={"kind": "closed_loop"},
                          episodes=[{"events": 1}], say=said.append)
    # the control step only: 300 ns on the card, 200 of them the solve's
    assert reader("control_event_device_ms_p95")(run) == pytest.approx(3e-4)
    got = reader("control_event_non_qp_device_ms")(run)
    if not solve_site:
        assert got is None
        return
    assert got == pytest.approx(1e-4)
    assert any("over 1 of 1 events" in line for line in said)
