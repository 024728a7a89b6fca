"""The recorder's site spans inside the particle filter's stages
(``predict.draw`` in ``filters/particle.predict``, ``resample.ends`` and
``resample.gather`` in ``ops/resample_pallas4.systematic_resample_tiled``)
and the benchmark's readers of them (``port_bench/site_spans.py`` and the
metrics ``predict_draw_device_ms``, ``resample_ends_device_ms``,
``resample_gather_roofline``).

On the CPU, through the stand-in graph: each site is a span once a step,
nested in its graphed stage, in the shell's stream and in the scan loop's
step; inside a capture a site stamps its two captured stamps, and with
the recorder off nothing; the readers that were there before read the
same with and without nested site spans, and the new readers read the
site spans. The ``gpu`` test holds the site spans on the card::

    python -m pytest tests/test_torch_site_spans.py -m gpu -q --noconftest
"""
import dataclasses
import itertools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gpu_se_tpu_torch import trace
from gpu_se_tpu_torch.filters import resampling
from port_bench import card, manifest, program_spans
from _torch_graph_stand_in import stand_in  # noqa: F401
from test_torch_trace import _synthetic

U = np.array([0.06, 0.2])
Z = np.array([280.0, 1000.0])
N = int(2 ** 12.5)          # 5792: not a multiple of 256, on the v4 route
SITES = {"predict.draw": "graphed.predict",
         "resample.ends": "graphed.resample",
         "resample.gather": "graphed.resample"}
OLD_STREAM = ("device_idle_share.window", "graph_call_host_ms")
OLD_LOOP = ("device_idle_share.loop", "control_event_device_ms_p95",
            "admm_chunk_device_ms", "control_event_non_qp_device_ms")
NEW = ("predict_draw_device_ms", "resample_ends_device_ms",
       "resample_gather_roofline")


@pytest.fixture
def armed():
    trace._arm(True)
    yield
    trace._arm()


@pytest.fixture
def clock(monkeypatch, armed):
    """The recorder's host clock made a counter: 10 ns a reading."""
    ticks = itertools.count(0, 10)
    monkeypatch.setattr(trace, "_now", lambda: next(ticks))


def _names(rec):
    return [rec.names[k] for k in rec.name]


def _children(rec, i):
    return [k for k in range(len(rec.name)) if rec.parent[k] == i]


# ----------------------------------------------------------------------
# the program's spans
# ----------------------------------------------------------------------
def test_the_stage_sites_are_spans_once_a_step(armed, stand_in):
    from gpu_se_tpu_torch.sim import harness

    shell = harness.get_parts(dt_control=2, N_particles=N, device="cpu")[3]
    with resampling.impl("v4"):
        for _ in range(4):
            shell.predict(U, 0.1)
            shell.update(U, Z)
            shell.resample()
            shell.point_estimate()
    rec = trace.collect("cpu")
    names = _names(rec)
    replays = {stage: [i for i, n in enumerate(names) if n == stage
                       and rec.mark[i, 0] >= 0]
               for stage in set(SITES.values())}
    # the first two steps captured each stage (the resampled particles
    # come out transposed, another layout: another key); the next two
    # replayed them
    assert all(len(calls) == 2 for calls in replays.values())
    for stage, calls in replays.items():
        want = [s for s, p in SITES.items() if p == stage]
        for i in calls:
            kids = _children(rec, i)
            assert [names[k] for k in kids] == want
            for k in kids:
                assert rec.call[k] == rec.call[i]
                assert rec.start[i] < rec.start[k] < rec.end[k] < rec.end[i]
                # inside the replay: after the inputs' copies, before the
                # hand-out
                assert rec.mark[i, 0] < rec.start[k] < rec.mark[i, 1]
    # each capture: the stand-in's warm-up and capture each ran the stage
    for k, name in enumerate(names):
        if name in SITES and rec.mark[rec.parent[k], 0] < 0:
            p = rec.parent[k]
            assert names[p] == "capture" and names[rec.parent[p]] == \
                SITES[name]
    for name in SITES:
        assert names.count(name) == 2 * 2 + 2


def test_the_scan_loop_step_holds_the_sites(armed, stand_in):
    from gpu_se_tpu_torch.sim import harness, loop

    bio, lin, K, est = harness.get_parts(dt_control=2, N_particles=N,
                                         device="cpu")
    state_pdf, meas_pdf = harness.get_noise(device="cpu")
    with resampling.impl("v4"):
        run, ts = loop.make_scan_loop(K, lin, state_pdf.dist, meas_pdf.dist,
                                      end_time=2.0, dt_control=1.0,
                                      dt_predict=0.5)
        run(est.state, bio.X.copy(), torch.Generator().manual_seed(0))
        trace._arm(True)
        run(est.state, bio.X.copy(), torch.Generator().manual_seed(0))
    rec = trace.collect("cpu")
    names = _names(rec)
    steps = [i for i, n in enumerate(names) if n == "loop.step"]
    assert len(steps) == len(ts) - 1
    seen = {name: 0 for name in SITES}
    for i in steps:
        predict, control = rec.attr[i]
        graphed = [k for k in _children(rec, i) if names[k] == "graphed.step"]
        assert len(graphed) == 1
        kids = [names[k] for k in _children(rec, graphed[0])
                if names[k] in SITES]
        want = (["predict.draw"] if predict else []) + (
            ["resample.ends", "resample.gather"] if control else [])
        assert kids == want
        for name in kids:
            seen[name] += 1
    assert min(seen.values()) > 0


class _Lib:
    def __init__(self):
        self.stamps = []

    def gst_stamp(self, ring, tag, stream):
        self.stamps.append(tag)
        return 0


@pytest.mark.parametrize("on", [True, False], ids=["armed", "off"])
def test_a_site_in_a_capture_stamps_its_site(monkeypatch, on):
    """Inside a capture on a card a site span is two captured stamps of
    its site and no host span; with the recorder off (``GST_TRACE=0``)
    nothing, so the graphs captured then hold no stamp."""
    if on:
        monkeypatch.delenv(trace.SWITCH, raising=False)
    else:
        monkeypatch.setenv(trace.SWITCH, "0")
    trace._arm()
    lib = _Lib()
    saved = trace._CARDS.get(0)        # a real card's ring, on the card
    try:
        trace._CARDS[0] = SimpleNamespace(full=SimpleNamespace(value=0),
                                          lib=lib, ptr=1, stream=lambda: 0)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: True)
        with trace.site_span("resample.ends", torch.device("cuda", 0)):
            pass
        rec = trace.collect()
    finally:
        if saved is None:
            del trace._CARDS[0]
        else:
            trace._CARDS[0] = saved
        monkeypatch.delenv(trace.SWITCH, raising=False)
        trace._arm()
    site = trace.site("resample.ends")
    tags = [trace.SITE | (site << 2) | k for k in (trace.BEGIN, trace.END)]
    assert lib.stamps == (tags if on else [])
    assert not len(rec.name)


def test_the_switch_off_records_no_site(monkeypatch, stand_in):
    from gpu_se_tpu_torch.sim import harness

    monkeypatch.setenv(trace.SWITCH, "0")
    trace._arm()
    try:
        shell = harness.get_parts(dt_control=2, N_particles=N,
                                  device="cpu")[3]
        with resampling.impl("v4"):
            for _ in range(2):
                shell.predict(U, 0.1)
                shell.update(U, Z)
                shell.resample()
        rec = trace.collect("cpu")
    finally:
        monkeypatch.delenv(trace.SWITCH)
        trace._arm()
    assert not len(rec.name) and rec.dropped_spans == 0


# ----------------------------------------------------------------------
# the benchmark's reading, on recordings shaped as the program's
# ----------------------------------------------------------------------
SOLVE = program_spans.SOLVE_SITE


def _recording(kind):
    """``test_torch_trace``'s synthetic stream or loop; in the loop each
    control step's graphed call holds the QP's solve, a site span, with
    the step's two WHILE stamps."""
    rec = _synthetic("stream" if kind == "stream" else "loop")
    if kind == "stream":
        return rec
    rec = _with_sites(rec, {"graphed.step": [(SOLVE, 4, 20)]})
    solves = np.flatnonzero(rec.dev_name == rec.names.index(SOLVE))
    return dataclasses.replace(
        rec, while_time=np.repeat(rec.dev_start[solves], 2)
        + np.tile([6, 8], len(solves)), while_span=np.repeat(solves, 2))


def _with_sites(rec, inside):
    """``rec`` with device spans ``(name, from, to)`` (ns into their
    parent) nested in each device span named as a key of ``inside``,
    appended after the others (the readers find a span's parent by its
    index, not by the order of the spans)."""
    names = list(rec.names)
    cols = {k: getattr(rec, k).tolist() for k in (
        "dev_name", "dev_host", "dev_parent", "dev_call", "dev_start",
        "dev_end")}
    for p, name in enumerate(list(cols["dev_name"])):
        for site, a, b in inside.get(names[name], []):
            if site not in names:
                names.append(site)
            cols["dev_name"].append(names.index(site))
            cols["dev_host"].append(-1)
            cols["dev_parent"].append(p)
            cols["dev_call"].append(cols["dev_call"][p])
            cols["dev_start"].append(cols["dev_start"][p] + a)
            cols["dev_end"].append(cols["dev_start"][p] + b)
    return dataclasses.replace(
        rec, names=names, dev_name=np.asarray(cols["dev_name"], np.int32),
        **{k: np.asarray(v, np.int64) for k, v in cols.items()
           if k != "dev_name"})


# a graphed call is 30 ns on the card: the draw 20 of its predict's, the
# ends 7 and the gather 15 of its resample's
STAGE_SITES = {"graphed.predict": [("predict.draw", 5, 25)],
               "graphed.resample": [("resample.ends", 3, 10),
                                    ("resample.gather", 12, 27)],
               "graphed.step": [("predict.draw", 1, 3),
                                ("resample.ends", 21, 23),
                                ("resample.gather", 24, 28)]}
WEIGHTS = torch.tensor([0.4, 0.3, 0.2, 0.1], dtype=torch.float32)


def _run(kind, rec, monkeypatch):
    monkeypatch.setattr(program_spans, "_collect", lambda device: rec)
    program_spans._memo[:] = [None, None]
    said = []
    return SimpleNamespace(
        device=torch.device("cuda", 0), attempted=2,
        traffic={"kind": kind, "warmup_steps": 1},
        episodes=[{"events": 2, "while_iterations": 4}] * 2,
        resample_inputs=[(0.1, WEIGHTS)], say=said.append, said=said,
        work={"estimator": "pf", "n": 4, "nx": 5})


@pytest.mark.parametrize("kind, readers", [("stream", OLD_STREAM),
                                           ("closed_loop", OLD_LOOP)])
def test_the_readers_before_read_the_same_with_sites(kind, readers, clock,
                                                     monkeypatch):
    rec = _recording(kind)
    nested = _with_sites(rec, STAGE_SITES)
    assert len(nested.dev_name) > len(rec.dev_name)
    got = []
    for r in (rec, nested):
        run = _run(kind, r, monkeypatch)
        got.append({n: manifest.metric_reader(n)(run) for n in readers})
        w = program_spans.window(run)
        got[-1]["window"] = (w.busy_ns, w.span_ns, w.idle_by)
    assert None not in got[0].values()
    assert got[0] == got[1]


def test_the_new_readers_read_the_sites(clock, monkeypatch):
    rec = _with_sites(_recording("stream"), STAGE_SITES)
    run = _run("stream", rec, monkeypatch)
    read = {n: manifest.metric_reader(n)(run) for n in NEW}
    assert read["predict_draw_device_ms"] == pytest.approx(2e-5)
    assert read["resample_ends_device_ms"] == pytest.approx(7e-6)
    # two survivors of weight >= 1/n: read 2 rows, write 4 rows and 4
    # ancestors, over the window's two gathers of 15 ns
    least = (2 * 20 + 4 * 20 + 4 * 4) / card.PEAK_BYTES
    assert read["resample_gather_roofline"] == pytest.approx(
        100 * least * 2 / 30e-9)
    lines = "\n".join(run.said)
    assert "predict.draw in graphed.predict: 2 spans in 2 of 2 calls, " \
        "2 inside" in lines
    assert "over their graphed resample: median 0.7333" in lines


@pytest.mark.parametrize("kind", ["stream", "closed_loop"])
def test_the_new_readers_find_nothing_without_sites(kind, clock,
                                                    monkeypatch):
    rec = _recording(kind)
    if kind == "closed_loop":          # nested in the step, not a stage
        rec = _with_sites(rec, STAGE_SITES)
    run = _run(kind, rec, monkeypatch)
    for n in NEW:
        assert manifest.metric_reader(n)(run) is None, n


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the stamp kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    trace._arm(True)
    yield torch.device("cuda", 0)
    trace._arm()


@pytest.mark.gpu
def test_the_sites_nest_in_their_stages_on_the_card(cuda):
    from gpu_se_tpu_torch.sim import harness

    shell = harness.get_parts(dt_control=2, N_particles=N, device=cuda)[3]
    for _ in range(2):             # capture, then replay
        shell.predict(U, 0.1)
        shell.update(U, Z)
        shell.resample()
    trace._arm(True)
    for _ in range(3):
        shell.predict(U, 0.1)
        shell.update(U, Z)
        shell.resample()
    rec = trace.collect(cuda)
    assert rec.complete
    dev_names = [rec.names[k] for k in rec.dev_name]
    for site, stage in SITES.items():
        kids = [k for k, n in enumerate(dev_names) if n == site]
        assert len(kids) == 3, site
        for k in kids:
            p = rec.dev_parent[k]
            assert rec.dev_host[k] == -1 and dev_names[p] == stage
            assert rec.dev_start[p] <= rec.dev_start[k] <= rec.dev_end[k] \
                <= rec.dev_end[p]
            assert rec.dev_end[k] - rec.dev_start[k] < \
                rec.dev_end[p] - rec.dev_start[p]
