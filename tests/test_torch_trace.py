"""The span recorder (``gpu_se_tpu_torch/trace.py``) and the benchmark's
reading of it (``port_bench/program_spans.py`` and the metrics that use
it).

On the CPU: host spans nest with their parents and calls, a graphed
call's marks bracket its replay, a full ring stops the recorder and is
reported, the card's stamps parse into nested device spans, the clock
map recovers an offset and a drift, idle gaps are put down to the right
host spans and phases, the window is picked by the run's counts, and the
readers return nothing where there is nothing to read.
The ``gpu`` tests run the stamp kernel and the QP's WHILE stamps on the
card. This file imports no JAX, so on the card::

    python -m pytest tests/test_torch_trace.py -m gpu -q --noconftest
"""
import dataclasses
import itertools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gpu_se_tpu_torch import graphs, trace
from gpu_se_tpu_torch.ops import _build
from port_bench import manifest, program_spans
from _torch_graph_stand_in import stand_in  # noqa: F401

U = np.array([0.06, 0.2])
Z = np.array([280.0, 1000.0])
LOOP_READERS = ("device_idle_share.loop", "control_event_device_ms_p95",
                "admm_chunk_device_ms")
STREAM_READERS = ("device_idle_share.window", "graph_call_host_ms")
NEW_READERS = LOOP_READERS + STREAM_READERS


@pytest.fixture
def armed():
    """A fresh recorder, armed; the switch as the environment says after."""
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


def _shell(device="cpu", n=64):
    from gpu_se_tpu_torch.sim import harness

    return harness.get_parts(dt_control=2, N_particles=n, device=device)[3]


def _step(shell):
    shell.predict(U, 0.1)
    shell.update(U, Z)
    shell.resample()
    return shell.point_estimate()


# ----------------------------------------------------------------------
# host spans
# ----------------------------------------------------------------------
def test_host_spans_nest_with_parents_and_calls(clock):
    a = trace.begin("a")
    b = trace.begin("b", attr=3)
    c = trace.begin("c")
    trace.end(c)
    trace.end(b)
    d = trace.begin("d")
    trace.end(d)
    trace.end(a)
    e = trace.begin("e")
    trace.end(e)
    rec = trace.collect()
    assert _names(rec) == ["a", "b", "c", "d", "e"]
    assert rec.parent.tolist() == [-1, a, b, a, -1]
    assert rec.call.tolist() == [a, a, a, a, e]
    assert rec.attr == [None, 3, None, None, None]
    assert (rec.end > rec.start).all()
    assert rec.start[c] > rec.start[b] and rec.end[c] < rec.end[b]
    assert rec.complete and rec.dropped_spans == 0
    assert (rec.mark == -1).all() and not len(rec.dev_start)


def test_the_host_ring_is_allocated_at_the_first_span():
    trace._arm(True, capacity=16)
    try:
        assert trace._HOST.capacity == 0 and not len(trace._HOST.start)
        trace.end(trace.begin("a"))
        assert trace._HOST.capacity == 16
    finally:
        trace._arm()
    assert trace._HOST.capacity == 0


def test_an_exception_closes_the_spans_left_open(armed):
    a = trace.begin("a")
    trace.begin("b")           # never ended: an exception passed it
    trace.end(a)
    c = trace.begin("c")
    trace.end(c)
    rec = trace.collect()
    assert rec.parent.tolist() == [-1, 0, -1]
    assert rec.end.tolist()[1] == -1


def test_shell_and_graphed_spans_on_the_cpu(armed):
    shell = _shell()
    _step(shell)
    rec = trace.collect("cpu")
    names = _names(rec)
    # the predict's draw is a span of its own inside the graphed call
    assert names == ["shell.predict", "graphed.predict", "predict.draw",
                     "shell.update", "graphed._update", "shell.resample",
                     "graphed.resample", "shell.point_estimate"]
    tops = [i for i, p in enumerate(rec.parent.tolist()) if p < 0]
    assert [names[i] for i in tops] == [
        "shell.predict", "shell.update", "shell.resample",
        "shell.point_estimate"]
    assert rec.parent[2] == 1
    for i, p in enumerate(rec.parent.tolist()):
        if p >= 0:
            assert rec.call[i] == rec.call[p]
            assert rec.call[i] == p or rec.parent[p] == rec.call[i]
    assert not trace._CARDS


def test_shell_update_span_carries_the_mixture_launches(armed):
    """The ``shell.update`` span's attribute is the mixture density's
    launches in the call: none on the CPU, where the plain version runs
    (one on the card: ``tests/test_torch_kernels.py``)."""
    shell = _shell()
    _step(shell)
    shell.update(U, Z)
    rec = trace.collect("cpu")
    attrs = [rec.attr[i] for i, name in enumerate(_names(rec))
             if name == "shell.update"]
    assert attrs == [(("mixture_pdf", 0),)] * 2


def test_a_graphed_call_spans_its_capture_and_replays(armed, stand_in):
    g = graphs.Graphed(lambda x: 2 * x + 1, key=lambda: "auto")
    x = torch.arange(4.0)
    g(x)
    g(x)
    rec = trace.collect()
    names = _names(rec)
    assert names == ["graphed.<lambda>", "capture", "graphed.<lambda>"]
    assert rec.parent.tolist() == [-1, 0, -1]
    assert rec.attr[0] == rec.attr[2] == ("auto", ())
    # the replay is marked inside its span; the capture is not
    assert (rec.mark[:2] == -1).all()
    m0, m1 = rec.mark[2]
    assert rec.start[2] < m0 < m1 < rec.end[2]


def test_graphed_cpu_calls_are_unchanged(monkeypatch):
    x = torch.linspace(-1.0, 1.0, 7)
    got = {}
    for on in (True, False):
        trace._arm(on)
        try:
            g = graphs.Graphed(lambda t: (t.sin() * 3, t.cumsum(0)))
            got[on] = g(x)
        finally:
            trace._arm()
    for a, b in zip(got[True], got[False]):
        assert torch.equal(a, b)
    assert not trace._CARDS and _build._lib is None


def test_the_switch_off_records_nothing(monkeypatch):
    monkeypatch.setenv(trace.SWITCH, "0")
    trace._arm()
    try:
        assert not trace._ON
        assert trace.begin("a") == -1
        trace.end(-1)
        _step(_shell())
        rec = trace.collect("cpu")
        assert not len(rec.name) and rec.dropped_spans == 0
        assert trace.ring_pointer("cpu") == 0
    finally:
        monkeypatch.delenv(trace.SWITCH)
        trace._arm()
    assert trace._ON


def test_a_full_host_ring_stops_the_recorder():
    trace._arm(True, capacity=8)
    try:
        for _ in range(10):
            trace.end(trace.begin("a"))
        stopped = not trace._ON
        rec = trace.collect()
    finally:
        trace._arm()
    assert stopped and not rec.complete and rec.dropped_spans == 2
    assert len(rec.name) == 8 and (rec.end > rec.start).all()


class _Lib:
    def __init__(self):
        self.stamps = []

    def gst_stamp(self, ring, tag, stream):
        self.stamps.append(tag)
        return 0


def test_a_full_card_ring_stops_the_recorder(armed, monkeypatch):
    lib = _Lib()
    card = SimpleNamespace(full=SimpleNamespace(value=0), lib=lib, ptr=1,
                           stream=lambda: 0)
    monkeypatch.setitem(trace._CARDS, 0, card)
    dev = torch.device("cuda", 0)
    with trace.span("a", dev):
        pass
    assert lib.stamps == [trace.BEGIN, trace.END]
    card.full.value = 1                # the stamp kernel raised the flag
    with trace.span("b", dev):
        pass
    assert lib.stamps == [trace.BEGIN, trace.END] and not trace._ON
    assert trace.begin("c") == -1
    rec = trace.collect()
    assert _names(rec) == ["a", "b"] and rec.dropped_spans == 1


def test_the_closed_loop_spans_each_step(armed):
    from gpu_se_tpu_torch.sim import harness, loop

    bio, lin, K, est = harness.get_parts(dt_control=2, N_particles=8,
                                         device="cpu")
    state_pdf, meas_pdf = harness.get_noise(device="cpu")
    run, ts = loop.make_scan_loop(K, lin, state_pdf.dist, meas_pdf.dist,
                                  end_time=1.0, dt_control=2)
    trace._arm(True)
    run(est.state, bio.X.copy(), torch.Generator().manual_seed(0))
    rec = trace.collect("cpu")
    names = _names(rec)
    start, steps = names.index("loop.start"), names.index("loop.steps")
    assert rec.parent[start] == rec.parent[steps] == -1
    step_spans = [i for i, n in enumerate(names) if n == "loop.step"]
    masks = loop.event_masks(ts, 2, 0.1)
    assert len(step_spans) == len(ts) - 1
    assert [rec.attr[i] for i in step_spans] == list(
        zip(masks[0].tolist(), masks[1].tolist()))
    for i in step_spans:
        assert rec.parent[i] == steps and names[i + 1] == "graphed.step"
        assert rec.parent[i + 1] == i


# ----------------------------------------------------------------------
# the card's stamps, read without a card
# ----------------------------------------------------------------------
def _tag(kind, ident, captured=False):
    return (trace.SITE if captured else 0) | (ident << 2) | kind


def test_stamps_parse_into_nested_device_spans():
    B, E, W, I = trace.BEGIN, trace.END, trace.WHILE, trace.IF
    tags = np.array([_tag(B, 5), _tag(B, 2, True), W, W, I, W,
                     _tag(E, 2, True), _tag(E, 5), _tag(E, 7), _tag(B, 9),
                     W], dtype=np.int64)
    times = np.arange(len(tags), dtype=np.int64) * 100
    d = trace.device_spans(tags, times)
    assert d["host"].tolist() == [5, -1, 9]
    assert d["site"].tolist() == [-1, 2, -1]
    assert d["parent"].tolist() == [-1, 0, -1]
    assert d["start"].tolist() == [0, 100, 900]
    assert d["end"].tolist() == [700, 600, -1]
    assert d["while_span"].tolist() == [1, 1, 1, 2]
    assert d["while_time"].tolist() == [200, 300, 500, 1000]
    assert d["if_span"].tolist() == [1] and d["unmatched"] == 1


def test_the_clock_map_recovers_offset_and_drift():
    g1, drift, offset = 1_760_000_000_000_000_000, 3e-6, -123_456_789

    def host(g):
        return offset + g + (g - g1) * drift

    # each calibration: the card's time of a stamp, the middle of a
    # bracket of 6 us around it, placed off-centre by 2 us
    first = (g1, int(host(g1)) + 2_000, 6_000)
    g2 = g1 + 40_000_000_000
    last = (g2, int(host(g2)) - 2_000, 6_000)
    to_host = trace.clock_map(first, last)
    gs = np.array([g1, g1 + 10**9, g1 + 2 * 10**10, g2], dtype=np.int64)
    err = np.abs(to_host(gs) - np.array([host(g) for g in gs]))
    assert err.max() <= 3_000          # within half a bracket


class _FakeCard:
    def __init__(self, cursor, records):
        self.device = torch.device("cuda", 0)
        self.first = (1000, 50_000, 4_000)
        self.result = (cursor, records)

    def calibrate(self):
        return (1_001_000, 1_050_000, 2_000)

    def read(self):
        return self.result


@pytest.mark.parametrize("full", [False, True])
def test_collect_maps_the_card_and_reports_a_full_ring(armed, monkeypatch,
                                                       full):
    i = trace.begin("graphed.f")
    trace.end(i)
    B, E = trace.BEGIN, trace.END
    site = trace.site("graphed.inner")
    records = np.array([[_tag(B, i), 2000], [_tag(B, site, True), 2100],
                        [trace.WHILE, 2500], [_tag(E, site, True), 2600],
                        [_tag(E, i), 3000]], dtype=np.int64)
    # a full ring kept its first five stamps and counted three more
    card = _FakeCard(8 if full else 5, records)
    monkeypatch.setitem(trace._CARDS, 0, card)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    rec = trace.collect(torch.device("cuda", 0))
    assert rec.dropped_stamps == (3 if full else 0)
    assert rec.complete != full and rec.stamps == len(records) + 3 * full
    assert rec.clock_error_ns == (4_000, 2_000)
    assert [rec.names[k] for k in rec.dev_name] == ["graphed.f",
                                                    "graphed.inner"]
    assert rec.dev_host.tolist() == [i, -1]
    assert rec.dev_call.tolist() == [i, i]
    # the card's clock runs 1000 ns behind and at the host's rate
    assert rec.dev_start.tolist() == [51_000, 51_100]
    assert rec.dev_end.tolist() == [52_000, 51_600]
    assert rec.while_time.tolist() == [51_500]
    assert rec.resolution_ns == 100


# ----------------------------------------------------------------------
# the benchmark's reading
# ----------------------------------------------------------------------
def test_idle_gaps_and_the_host_span_open_at_each():
    starts = np.array([0, 50, 100, 300], dtype=np.int64)
    ends = np.array([40, 120, 200, 400], dtype=np.int64)
    gaps, busy, span = program_spans.idle_gaps(starts, ends)
    assert gaps.tolist() == [[40, 50], [200, 300]]
    assert (busy, span) == (290, 400)
    # host spans: a [0, 500) holding b [10, 60) and c [210, 260); d open
    hs = np.array([0, 10, 210, 600], dtype=np.int64)
    he = np.array([500, 60, 260, -1], dtype=np.int64)
    got = program_spans.innermost(hs, he, np.array([45, 250, 280, 550,
                                                    700, 5]))
    assert got.tolist() == [1, 2, 0, -1, 3, 0]


LAG = 27      # ns: the card runs each device span this far behind


def _graphed(name):
    g = trace.begin(name)
    trace.mark(g, 0)
    trace.mark(g, 1)
    trace.end(g)


def _synthetic(kind):
    """A recording of a stream (a warm-up step, two window steps, one
    traced step) or of the loop (a warm-up, three episodes of two control
    steps), on the counter clock, shaped as the program records them.
    On the card, :data:`LAG` ns behind their host spans: each graphed
    call, each point estimate and each ``loop.start`` (not the shells'
    graphed methods, not ``loop.steps``); each control step's graphed
    call holds two WHILE stamps, 2 ns apart."""
    if kind == "stream":
        calls = [("shell.predict", ["graphed.predict"]),
                 ("shell.update", ["graphed._update"]),
                 ("shell.resample", ["graphed.resample"]),
                 ("shell.point_estimate", [])] * 4
    else:
        episode = [("loop.start", []), ("loop.steps", ["loop.step"] * 2)]
        calls = [("loop.start", []), ("graphed.step", [])] + episode * 3
    for name, inner in calls:
        if name.startswith("graphed."):
            _graphed(name)
            continue
        top = trace.begin(name)
        for child in inner:
            if child == "loop.step":
                c = trace.begin(child, (True, True))
                _graphed("graphed.step")
                trace.end(c)
            else:
                _graphed(child)
        trace.end(top)
    rec = trace.collect()
    names = _names(rec)
    on_card = [i for i, n in enumerate(names)
               if n.startswith("graphed.") or n in ("loop.start",
                                                    "shell.point_estimate")]
    whiles = [(int(rec.start[h]) + LAG + d, k)
              for k, h in enumerate(on_card) if rec.parent[h] >= 0
              and names[h] == "graphed.step" for d in (6, 8)]
    i64 = np.asarray
    return dataclasses.replace(
        rec, dev_name=rec.name[on_card],
        dev_host=i64(on_card, dtype=np.int64),
        dev_parent=np.full(len(on_card), -1, dtype=np.int64),
        dev_call=rec.call[on_card], dev_start=rec.start[on_card] + LAG,
        dev_end=rec.end[on_card] + LAG,
        while_time=i64([t for t, _ in whiles], dtype=np.int64),
        while_span=i64([k for _, k in whiles], dtype=np.int64),
        stamps=2 * len(on_card) + len(whiles), clock_error_ns=(0, 0))


def _run(kind, attempted=2, episodes=2):
    said = []
    return SimpleNamespace(
        device=torch.device("cuda", 0), attempted=attempted,
        traffic={"kind": kind, "warmup_steps": 1},
        episodes=[{"events": 2, "while_iterations": 4}] * episodes,
        say=said.append, said=said)


def test_the_window_is_picked_by_the_runs_counts(clock):
    rec = _synthetic("stream")
    names = _names(rec)
    lo, hi = program_spans.select(rec, "stream", 1, 2, 0)
    predicts = [i for i, n in enumerate(names) if n == "shell.predict"]
    assert (lo, hi) == (predicts[1], predicts[3])
    assert program_spans.select(rec, "stream", 1, 4, 0) is None

    trace._arm(True)
    rec = _synthetic("loop")
    names = _names(rec)
    lo, hi = program_spans.select(rec, "closed_loop", 0, 0, 2)
    starts = [i for i, n in enumerate(names) if n == "loop.start"]
    assert (lo, hi) == (starts[1], starts[3])
    assert names[hi - 1] == "graphed.step" and names[hi - 2] == "loop.step"
    assert program_spans.select(rec, "closed_loop", 0, 0, 4) is None


def test_the_readers_on_a_synthetic_loop(clock, monkeypatch):
    rec = _synthetic("loop")
    monkeypatch.setattr(program_spans, "_collect", lambda device: rec)
    run = _run("closed_loop")
    read = {n: manifest.metric_reader(n)(run) for n in LOOP_READERS}
    # two episodes of four stamped WHILE iterations, 2 ns apart each pair
    assert read["admm_chunk_device_ms"] == pytest.approx(2e-6)
    assert any("8 stamped, 8 counted" in line for line in run.said)
    # each graphed step is 30 ns on the host clock, so on the card
    assert read["control_event_device_ms_p95"] == pytest.approx(3e-5)
    w = program_spans.window(run)
    # on the card: a start [87, 97], steps [127, 157], [187, 217], a start
    # [247, 257], steps [287, 317], [347, 377]; the card waits 30 ns
    # before each, while the host is in the next step's replay (its marks
    # at 10 and 20 ns into its span), or between the episodes
    assert (w.busy_ns, w.span_ns) == (140, 290)
    assert read["device_idle_share.loop"] == pytest.approx(100 * 150 / 290)
    assert w.idle_by == {"graphed.step/replay": 120, "outside": 30}


def test_the_readers_on_a_synthetic_stream(clock, monkeypatch):
    rec = _synthetic("stream")
    monkeypatch.setattr(program_spans, "_collect", lambda device: rec)
    run = _run("stream")
    share = manifest.metric_reader("device_idle_share.window")(run)
    w = program_spans.window(run)
    # a step of 200 ns on the host: its three graphed calls and the point
    # estimate on the card, 30 + 30 + 30 + 10 ns; the card waits while the
    # host replays the next call, or between two steps
    assert len(w.dev) == 8 and (w.busy_ns, w.span_ns) == (200, 380)
    assert share == pytest.approx(100 * 180 / 380)
    assert w.idle_by == {"graphed._update/replay": 60,
                         "graphed.resample/replay": 60,
                         "graphed.predict/replay": 20, "outside": 40}
    # a graphed call: 30 ns, 10 of them in its replay
    assert manifest.metric_reader("graph_call_host_ms")(run) == \
        pytest.approx(2e-5)
    assert any("idle on the card" in line for line in run.said)


@pytest.mark.parametrize("case", ["absent", "cpu", "off", "host_full",
                                  "card_full", "short"])
def test_the_readers_return_none_when_there_is_nothing(case, clock,
                                                       monkeypatch):
    rec = _synthetic("loop")
    run = _run("closed_loop")

    def absent(device):
        raise ImportError("no recorder")
    if case == "absent":
        monkeypatch.setattr(program_spans, "_collect", absent)
    elif case == "cpu":
        run.device = torch.device("cpu")
    elif case == "off":
        trace._arm(False)
        empty = trace.collect()
        monkeypatch.setattr(program_spans, "_collect", lambda d: empty)
    elif case.endswith("_full"):
        field = "dropped_spans" if case == "host_full" else "dropped_stamps"
        rec = dataclasses.replace(rec, **{field: 1})
        monkeypatch.setattr(program_spans, "_collect", lambda d: rec)
    else:
        run.episodes = run.episodes * 3
        monkeypatch.setattr(program_spans, "_collect", lambda d: rec)
    for name in NEW_READERS:
        assert manifest.metric_reader(name)(run) is None, name


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
def test_the_stamp_kernel_builds_and_runs(cuda):
    for _ in range(100):
        with trace.span("s", cuda):
            pass
    rec = trace.collect(cuda)
    assert rec.stamps == 200 and rec.complete
    assert rec.dev_host.tolist() == list(range(100))
    assert (rec.dev_end >= rec.dev_start).all()
    assert 0 < rec.resolution_ns < 10_000
    assert max(rec.clock_error_ns) < 1_000_000


@pytest.mark.gpu
def test_while_stamps_equal_the_counted_iterations(cuda):
    from gpu_se_tpu_torch.control.qp import DenseQP
    from gpu_se_tpu_torch.ops import graph_cond

    rng = np.random.default_rng(3)
    n, m = 30, 10
    M = rng.standard_normal((n, n))
    P, A = M @ M.T + np.eye(n), rng.standard_normal((m, n))
    q = rng.standard_normal(n)
    qp = DenseQP(P, A, -np.ones(m), np.ones(m), q, device=cuda)
    qp.solve(q, -np.ones(m), np.ones(m))         # builds the loop's parts
    torch.cuda.synchronize()
    graph_cond.reset_iterations(cuda)
    trace._arm(True)
    for k in range(3):
        qp.solve(q * (1 + k), -np.ones(m), np.ones(m))
    counted = graph_cond.iterations(cuda)
    rec = trace.collect(cuda)
    assert counted > 0 and len(rec.while_time) == counted
    solves = [k for k, h in enumerate(rec.dev_host.tolist())
              if h >= 0 and rec.names[rec.dev_name[k]] ==
              "graphed._device_solve"]
    assert len(solves) == 3
    assert np.isin(rec.while_span, solves).all()


@pytest.mark.gpu
def test_device_spans_start_after_their_host_spans(cuda):
    shell = _shell(cuda, 2 ** 12)
    trace._arm(True)
    for _ in range(4):
        _step(shell)
    rec = trace.collect(cuda)
    err = max(rec.clock_error_ns)
    assert err <= 50_000
    sites = ("predict.draw", "resample.ends", "resample.gather")
    dev_names = np.array([rec.names[k] for k in rec.dev_name])
    site = np.isin(dev_names, sites)
    eager = np.flatnonzero((rec.dev_host >= 0) & ~site)
    # a step: the three graphed calls and the point estimate; a stage's
    # site spans run eagerly only in a capture's warm-up
    assert len(eager) == 4 * 4
    warm = rec.dev_host[(rec.dev_host >= 0) & site]
    assert len(warm) and all(
        rec.names[rec.name[rec.parent[h]]] == "capture" for h in warm)
    host = rec.dev_host[eager]
    assert (rec.dev_start[eager] >= rec.start[host] - err).all()
    assert (rec.dev_end[eager] >= rec.dev_start[eager]).all()
    # each replayed graphed call's replay is marked inside its host span;
    # a capture is not marked
    graphed = [i for i in host.tolist()
               if rec.names[rec.name[i]].startswith("graphed.")]
    assert len(graphed) == 4 * 3
    names = _names(rec)
    captured = [i for i in graphed if names[i + 1] == "capture"]
    replayed = [i for i in graphed if i not in captured]
    assert len(replayed) >= 2 * 3 and (rec.mark[captured] == -1).all()
    m0, m1 = rec.mark[replayed].T
    assert (rec.start[replayed] < m0).all() and (m0 < m1).all()
    assert (m1 < rec.end[replayed]).all()


@pytest.mark.gpu
def test_a_full_card_ring_raises_the_flag_and_stops_stamping(cuda):
    trace._arm(True, device_capacity=8)
    for _ in range(6):                 # up to 12 stamps into 8 records
        with trace.span("s", cuda):
            pass
    torch.cuda.synchronize()
    with trace.span("t", cuda):        # reads the flag, if no stamp has
        pass
    stopped = not trace._ON
    rec = trace.collect(cuda)
    # the ninth stamp raised the flag; the host stops at the first eager
    # stamp after the card has run it
    assert stopped and 9 <= rec.stamps <= 12
    assert rec.dropped_stamps == rec.stamps - 8 and not rec.complete
    assert _names(rec)[:5] == ["s"] * 5
    assert rec.dev_host.tolist() == [0, 1, 2, 3]


def _states_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f.name


@pytest.mark.gpu
@pytest.mark.parametrize("estimator", ["pf", "gsukf"])
def test_filter_steps_are_bit_equal_armed_and_off(cuda, estimator):
    from gpu_se_tpu_torch.sim import harness

    got = {}
    for on in (True, False):
        trace._arm(on)
        shell = harness.get_parts(dt_control=2, N_particles=2 ** 12,
                                  pf=estimator == "pf", seed=5,
                                  device=cuda)[3]
        ests = [_step(shell) for _ in range(3)]
        got[on] = (shell.state, ests)
    _states_equal(got[True][0], got[False][0])
    for a, b in zip(got[True][1], got[False][1]):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_a_loop_step_is_bit_equal_armed_and_off(cuda):
    from gpu_se_tpu_torch.sim import harness, loop

    bio, lin, K, est = harness.get_parts(dt_control=2, N_particles=2 ** 12,
                                         seed=5, device=cuda)
    state_pdf, meas_pdf = harness.get_noise(device=cuda)
    got = {}
    for on in (True, False):
        trace._arm(on)
        run, _ = loop.make_scan_loop(K, lin, state_pdf.dist, meas_pdf.dist,
                                     end_time=3.0, dt_control=2)
        outs = []
        for _ in range(2):          # the first run captures, the next replays
            gen = torch.Generator(device=cuda).manual_seed(11)
            outs.append(run(est.state, bio.X.copy(), gen))
        got[on] = outs[-1]
    for a, b in zip(got[True], got[False]):
        assert torch.equal(a, b)
