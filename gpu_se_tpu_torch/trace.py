"""The port's span recorder: host spans on the host's clock, stamps on the
card's, both kept in memory and read once a run is over.

A span has a name, a start, an end, a parent (the span open around it)
and a call (the index of the top-level span it belongs to, so the spans
of one top-level call share it), and may carry an attribute (a graphed
call's key part and the kernels its graph launches: the resample route;
a closed-loop step's event flags) and two marks, times inside it (a
graphed call's replay: when it began and when it returned).

**Host spans** (:func:`begin`, :func:`end`, :func:`mark`, :class:`span`)
go into a ring of :data:`HOST_CAPACITY` spans allocated at the first
span, timed by ``time.perf_counter_ns`` (CLOCK_MONOTONIC). The names in
use: ``shell.<method>`` (a filter shell's call; its time before its
graphed call is the staging of its inputs), ``graphed.<function>`` (a
``graphs.Graphed`` call; marked around its replay, so its copies in come
before the first mark and its hand-out after the second; a child
``capture`` on a key's first call: warm-up and capture), and
``loop.start``, ``loop.steps`` (one episode) and ``loop.step``
(``sim/loop.py``).

**Device spans** are bracketed by stamps: a one-thread kernel
(``csrc/trace.cu``) appends ``(tag, %globaltimer)`` to a ring of
:data:`DEVICE_CAPACITY` records on the card through an atomic cursor. A
stamp's tag is its kind (:data:`BEGIN`, :data:`END`) and the host span it
belongs to, for a stamp launched eagerly; a stamp captured into a caller's
graph (a graphed call inside a capture runs inline) carries its site, a
name registered once (:data:`SITE`), and runs at each of the caller's
replays, nested inside the caller's eager stamps. The conditional nodes'
set kernel (``ops/graph_cond``) stamps each WHILE iteration
(:data:`WHILE`) and each taken nested IF node (:data:`IF`: the QP's
refactorization) of a graph captured while the recorder was armed. A card's
ring is allocated at its first stamp outside a capture, and kept: captured
graphs hold its address.

**Full rings.** Neither ring wraps. When the host ring is full, or a
stamp finds the card's ring full (the stamp kernel raises a flag in
pinned host memory, which each eager stamp reads), the recorder stops:
no span is recorded and no stamp launched from then on, and what was
recorded is kept. :func:`collect` counts the host spans refused after
the stop and the stamps that found the card's ring full (the stamps
captured into graphs go on counting).

**One clock.** When a card's ring is allocated and at every
:func:`collect`, a stamp on an idle stream is bracketed by host times
(host time, stamp, synchronise the stream, host time); the tightest of
:data:`CALIBRATION_TRIES` brackets gives a point of the map, and the card's
times map linearly through the first and the last point, which removes the
drift between the clocks. The brackets' widths are the map's error.

**Off switch.** ``GST_TRACE=0`` in the environment when the recorder arms
(this module's import) switches it off: no span is recorded, no stamp is
launched or captured into any graph, and a span costs a flag test or two.

:func:`collect` reads it all into a :class:`Recording` of plain arrays; it
resets nothing.
"""
from __future__ import annotations

import ctypes
import dataclasses
import os
import time
from array import array

import numpy as np
import torch

from gpu_se_tpu_torch.ops import _build

SWITCH = "GST_TRACE"
# 48 bytes a span: 24 MiB. A stream step records 7 spans (three shell
# calls, their graphed calls and the point estimate), so at ~360 steps/s
# the ring fills in ~200 s, and holds 30 s at 1000 steps/s twice over
HOST_CAPACITY = 1 << 19
# records of 16 bytes: 8 MiB a card. A stream step stamps 8 times (its
# three graphed calls and the point estimate), so this holds 30 s at
# 1000 steps/s twice over, and ~7 cycles of the loop's pool (~12 stamps
# a control event with its WHILE iterations)
DEVICE_CAPACITY = 1 << 19
BEGIN, END, WHILE, IF = 0, 1, 2, 3     # a tag's low two bits
SITE = 1 << 62                         # a stamp captured into a graph
_ID = (1 << 60) - 1
CALIBRATION_TRIES = 16
_HEADER = 4                            # trace_ring.cuh's header words

_now = time.perf_counter_ns


def _switched_on() -> bool:
    return os.environ.get(SWITCH, "1") != "0"


class _Host:
    """The host's ring, a column of integers a field (the name's id, the
    parent, the start, the end, the two marks) and a list of the
    attributes, with the stack of open spans. The columns hold no Python
    objects, so the garbage collector never walks them. Capacity 0 until
    the first span."""

    def __init__(self, capacity: int = 0):
        self.capacity = capacity
        self.name = array("i", bytes(4 * capacity))
        self.parent = array("i", bytes(4 * capacity))
        self.start = array("q", bytes(8 * capacity))
        unset = array("q", [-1]) * capacity
        self.end, self.marks = unset, (array("q", unset), array("q", unset))
        self.attr = [None] * capacity
        self.ids: dict = {}
        self.n = 0
        self.dropped = 0
        self.stack: list = []


_ON = _switched_on()
_STOPPED = False       # a ring filled: recording stopped
_CAPACITY = HOST_CAPACITY
_DEVICE_CAPACITY = DEVICE_CAPACITY
_HOST = _Host()
_CARDS: dict = {}      # card index -> _Card, for the life of the process
_SITES: dict = {}      # site name -> id, baked into captured graphs


def _arm(on=None, capacity: int = HOST_CAPACITY,
         device_capacity: int = DEVICE_CAPACITY) -> None:
    """Arm the recorder anew (the switch read again unless ``on`` is
    given): an empty host ring of ``capacity`` at the next span, and every
    card's ring emptied (to hold ``device_capacity`` records, at most its
    size) and its clock calibrated again. Not called inside a run."""
    global _ON, _STOPPED, _CAPACITY, _DEVICE_CAPACITY, _HOST
    _ON = _switched_on() if on is None else bool(on)
    _STOPPED = False
    _CAPACITY, _DEVICE_CAPACITY = capacity, device_capacity
    _HOST = _Host()
    for card in _CARDS.values():
        card.reset(device_capacity)


def _stop() -> None:
    global _ON, _STOPPED
    _ON, _STOPPED = False, True


# ----------------------------------------------------------------------
# host spans
# ----------------------------------------------------------------------
def begin(name: str, attr=None) -> int:
    """Open a span; its index, or -1 when the recorder is off."""
    if not _ON:
        if _STOPPED:
            _HOST.dropped += 1
        return -1
    h = _HOST
    i = h.n
    if i >= h.capacity:
        if h.capacity:
            _stop()
            h.dropped += 1
            return -1
        h = _alloc()
    h.n = i + 1
    stack = h.stack
    h.parent[i] = stack[-1] if stack else -1
    ident = h.ids.get(name)
    if ident is None:
        ident = h.ids[name] = len(h.ids)
    h.name[i] = ident
    if attr is not None:
        h.attr[i] = attr
    stack.append(i)
    h.start[i] = _now()
    return i


def _alloc() -> _Host:
    global _HOST
    _HOST = _Host(_CAPACITY)
    return _HOST


def end(i: int) -> None:
    """Close span ``i`` (and any child an exception left open)."""
    if i < 0:
        return
    h = _HOST
    t = _now()
    if i < h.n:
        h.end[i] = t
    stack = h.stack
    while stack and stack.pop() != i:
        pass


def mark(i: int, k: int) -> None:
    """Span ``i``'s mark ``k`` (0 or 1): now."""
    if i >= 0:
        _HOST.marks[k][i] = _now()


def annotate(i: int, attr) -> None:
    """Set span ``i``'s attribute."""
    if i >= 0:
        _HOST.attr[i] = attr


# ----------------------------------------------------------------------
# stamps on the card
# ----------------------------------------------------------------------
def stamp(i: int, device, kind: int) -> None:
    """An eager ``kind`` (:data:`BEGIN` or :data:`END`) stamp of span
    ``i`` on ``device``'s current stream; nothing off the card or when
    the recorder is off."""
    if i >= 0 and device is not None and device.type == "cuda":
        _stamp(device, (i << 2) | kind)


def site(name: str) -> int:
    """The id of the captured stamps named ``name``."""
    return _SITES.setdefault(name, len(_SITES))


def stamp_site(site_id: int, device, kind: int) -> None:
    """A ``kind`` stamp of the site ``site_id`` on ``device``'s current
    stream, which is capturing: it runs at each replay of the graph."""
    if _ON and device.type == "cuda":
        _stamp(device, SITE | (site_id << 2) | kind)


def ring_pointer(device) -> int:
    """The address of ``device``'s ring for a kernel to stamp into, or 0
    (a null pointer) when the recorder is off or has no ring there."""
    if not _ON:
        return 0
    card = _card(torch.device(device))
    return 0 if card is None else card.ptr


class span:
    """``with span(name, device):`` a host span around the block, and on
    a card a device span around the work it enqueues (eager stamps; never
    used inside a capture)."""

    __slots__ = ("name", "device", "i")

    def __init__(self, name: str, device=None):
        self.name, self.device = name, device

    def __enter__(self) -> int:
        self.i = i = begin(self.name)
        stamp(i, self.device, BEGIN)
        return i

    def __exit__(self, *exc) -> None:
        stamp(self.i, self.device, END)
        end(self.i)


def _index(device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def _stamp(device, tag: int) -> None:
    card = _card(device)
    if card is None:
        return
    if card.full.value:
        _stop()
        return
    rc = card.lib.gst_stamp(card.ptr, tag, card.stream())
    if rc != 0:
        raise RuntimeError(f"trace: stamp failed with CUDA error {rc}")


def _card(device):
    """The card's ring, allocated at its first stamp outside a capture;
    None inside one (nothing of the recorder goes into that graph)."""
    index = _index(device)
    card = _CARDS.get(index)
    if card is None:
        with torch.cuda.device(index):
            if torch.cuda.is_current_stream_capturing():
                return None
        card = _CARDS[index] = _Card(index)
    return card


class _Card:
    """A card's ring and calibration ring (``csrc/trace_ring.cuh``'s
    layout: cursor, capacity, the full flag's address, then the records),
    the full flag (pinned host memory the stamp kernel writes), its idle
    stream and its clock points."""

    def __init__(self, index: int):
        self.device = torch.device("cuda", index)
        self.lib = _build.load_library()
        self.flag = torch.zeros(1, dtype=torch.int32).pin_memory()
        self.full = ctypes.c_int32.from_address(self.flag.data_ptr())
        self.ring = self._ring(DEVICE_CAPACITY, self.flag.data_ptr())
        self.ptr = self.ring.data_ptr()
        self.cal = self._ring(CALIBRATION_TRIES, 0)
        self.idle = torch.cuda.Stream(self.device, priority=-1)
        raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
        self.stream = (lambda: raw(index)) if raw is not None else (
            lambda: torch.cuda.current_stream(self.device).cuda_stream)
        self.reset(_DEVICE_CAPACITY)

    def _ring(self, capacity: int, flag: int) -> torch.Tensor:
        ring = torch.zeros(_HEADER + 2 * capacity, dtype=torch.int64,
                           device=self.device)
        ring[1], ring[2] = capacity, flag
        return ring

    def reset(self, capacity: int) -> None:
        """Empty the ring, to hold ``capacity`` records (at most its
        size), lower the flag and calibrate the clock again."""
        torch.cuda.synchronize(self.device)
        self.ring[0] = 0
        self.ring[1] = min(capacity, (len(self.ring) - _HEADER) // 2)
        torch.cuda.synchronize(self.device)
        self.full.value = 0
        self.first = self.calibrate()

    def calibrate(self) -> tuple:
        """``(card ns, host ns, bracket width ns)``: the tightest of
        :data:`CALIBRATION_TRIES` stamps on the idle stream, each
        bracketed by host times; the host time is the bracket's middle."""
        ptr, stream = self.cal.data_ptr(), self.idle.cuda_stream
        with torch.cuda.stream(self.idle):
            self.cal[0] = 0
        self.idle.synchronize()
        brackets = []
        for _ in range(CALIBRATION_TRIES):
            t0 = _now()
            rc = self.lib.gst_stamp(ptr, 0, stream)
            self.idle.synchronize()
            brackets.append((t0, _now()))
            if rc != 0:
                raise RuntimeError(f"trace: stamp failed with CUDA error {rc}")
        with torch.cuda.stream(self.idle):
            times = self.cal[_HEADER:].view(-1, 2)[:, 1].cpu().numpy()
        k = min(range(CALIBRATION_TRIES),
                key=lambda j: brackets[j][1] - brackets[j][0])
        t0, t1 = brackets[k]
        return int(times[k]), (t0 + t1) // 2, t1 - t0

    def read(self):
        """``(stamps taken, records kept)``, after the card has finished:
        the ring keeps the first ``capacity`` stamps."""
        cursor, capacity = self.ring[:2].tolist()
        kept = min(cursor, capacity)
        return cursor, self.ring[_HEADER:_HEADER + 2 * kept].view(
            -1, 2).cpu().numpy()


# ----------------------------------------------------------------------
# reading
# ----------------------------------------------------------------------
@dataclasses.dataclass
class Recording:
    """What :func:`collect` read: host spans and device spans, times in
    host ns (``perf_counter_ns``); an end or a mark of -1 was never set.

    Host spans are indexed as they were begun: ``names[name[i]]``,
    ``attr[i]``, ``parent[i]`` (-1: top level), ``call[i]`` (the index of
    its top-level span), ``start[i]``, ``end[i]``, ``mark[i]`` (its two
    marks). Device spans: ``dev_name`` (into ``names``), ``dev_host`` (the
    host span of an eager bracket; -1 for one captured into a graph),
    ``dev_parent``, ``dev_call`` (the host call it ran for),
    ``dev_start``, ``dev_end``. ``while_time``/``while_span``: each
    stamped WHILE iteration's end and the device span it ran in;
    ``if_time``/``if_span`` the same for taken nested IF nodes.

    ``dropped_spans`` counts the host spans refused once a ring was full
    and ``dropped_stamps`` the stamps that found the card's ring full:
    either nonzero means the recording stops short of the run's end.
    ``clock_error_ns`` is the widths of the brackets that map the card's
    clock (at arming, at this collect); ``resolution_ns`` the least
    nonzero gap between two of the card's stamps."""

    names: list
    name: np.ndarray
    attr: list
    parent: np.ndarray
    call: np.ndarray
    start: np.ndarray
    end: np.ndarray
    mark: np.ndarray
    dropped_spans: int
    dev_name: np.ndarray
    dev_host: np.ndarray
    dev_parent: np.ndarray
    dev_call: np.ndarray
    dev_start: np.ndarray
    dev_end: np.ndarray
    while_time: np.ndarray
    while_span: np.ndarray
    if_time: np.ndarray
    if_span: np.ndarray
    stamps: int = 0
    dropped_stamps: int = 0
    unmatched: int = 0
    clock_error_ns: tuple = ()
    resolution_ns: int = 0

    @property
    def complete(self) -> bool:
        """Whether every span and stamp of the run was kept."""
        return not (self.dropped_spans or self.dropped_stamps)


def _i64(values=()) -> np.ndarray:
    return np.asarray(values, dtype=np.int64)


def _top_calls(parent: np.ndarray) -> np.ndarray:
    """Each span's top-level ancestor (itself at the top level), from
    the parents of spans indexed in the order they were begun."""
    up = np.where(parent < 0, np.arange(len(parent)), parent)
    while True:
        nxt = up[up]
        if np.array_equal(nxt, up):
            return up
        up = nxt


def _host_arrays(h: _Host) -> dict:
    n = h.n

    def col(a):
        return np.frombuffer(a, dtype=a.typecode)[:n].astype(np.int64)
    parent = col(h.parent)
    return {"names": list(h.ids), "name": col(h.name).astype(np.int32),
            "attr": h.attr[:n], "parent": parent, "call": _top_calls(parent),
            "start": col(h.start), "end": col(h.end),
            "mark": np.stack([col(m) for m in h.marks], axis=1),
            "dropped_spans": h.dropped}


def device_spans(tags: np.ndarray, times: np.ndarray) -> dict:
    """Device spans from stamps in the ring's order (one stream's order):
    a BEGIN opens a span inside the innermost one open, an END closes the
    innermost open span of its tag (any left open inside it stay open),
    WHILE and IF stamps fall in the innermost open span. ``host`` is the
    eager bracket's host span (-1 if captured), ``site`` a captured
    bracket's site (-1 if eager); times are the card's."""
    host, site_, parent, start, end_ = [], [], [], [], []
    marks = {WHILE: ([], []), IF: ([], [])}
    stack: list = []         # (span, tag without its kind)
    unmatched = 0
    for tag, t in zip(tags.tolist(), times.tolist()):
        kind, who = tag & 3, tag & ~3
        if kind == BEGIN:
            eager = not tag & SITE
            ident = (who >> 2) & _ID
            host.append(ident if eager else -1)
            site_.append(-1 if eager else ident)
            parent.append(stack[-1][0] if stack else -1)
            start.append(t)
            end_.append(-1)
            stack.append((len(start) - 1, who))
        elif kind == END:
            k = len(stack) - 1
            while k >= 0 and stack[k][1] != who:
                k -= 1
            if k < 0:
                unmatched += 1
                continue
            end_[stack[k][0]] = t
            del stack[k:]
        else:
            marks[kind][0].append(t)
            marks[kind][1].append(stack[-1][0] if stack else -1)
    return {"host": _i64(host), "site": _i64(site_), "parent": _i64(parent),
            "start": _i64(start), "end": _i64(end_),
            "while_time": _i64(marks[WHILE][0]),
            "while_span": _i64(marks[WHILE][1]),
            "if_time": _i64(marks[IF][0]), "if_span": _i64(marks[IF][1]),
            "unmatched": unmatched}


def clock_map(first: tuple, last: tuple):
    """``card ns -> host ns`` (arrays), linear through the two
    calibration points ``(card ns, host ns, width)``: their offset and the
    clocks' relative drift."""
    g1, h1, _ = first
    g2, h2, _ = last
    slope = (h2 - h1) / (g2 - g1) if g2 != g1 else 1.0

    def to_host(g):
        g = np.asarray(g, dtype=np.int64)
        return h1 + np.rint((g - g1).astype(np.float64) * slope).astype(
            np.int64)
    return to_host


def _resolution(times: np.ndarray) -> int:
    gaps = np.diff(np.sort(times))
    gaps = gaps[gaps > 0]
    return int(gaps.min()) if gaps.size else 0


def collect(device=None) -> Recording:
    """Every span since the recorder armed: waits for ``device`` (a card)
    once, calibrates its clock again and reads both rings. It resets
    nothing, so it may be called again."""
    out = _host_arrays(_HOST)
    names = {name: k for k, name in enumerate(out["names"])}
    empty = {k: _i64() for k in ("dev_host", "dev_parent", "dev_call",
                                  "dev_start", "dev_end", "while_time",
                                  "while_span", "if_time", "if_span")}
    empty["dev_name"] = np.zeros(0, dtype=np.int32)
    device = None if device is None else torch.device(device)
    card = None
    if device is not None and device.type == "cuda":
        card = _CARDS.get(_index(device))
    if card is None:
        return Recording(**out, **empty)
    torch.cuda.synchronize(card.device)
    last = card.calibrate()
    cursor, records = card.read()
    d = device_spans(records[:, 0], records[:, 1])
    to_host = clock_map(card.first, last)
    by_site = {v: k for k, v in _SITES.items()}
    n_host = len(out["name"])
    dev_name, dev_call = [], []
    for k, (h, s, p) in enumerate(zip(d["host"].tolist(), d["site"].tolist(),
                                      d["parent"].tolist())):
        if 0 <= h < n_host:
            dev_name.append(int(out["name"][h]))
            dev_call.append(int(out["call"][h]))
        else:
            label = by_site.get(s, "?") if s >= 0 else "?"
            dev_name.append(names.setdefault(label, len(names)))
            dev_call.append(dev_call[p] if p >= 0 else -1)
    end_ = d["end"]
    mapped_end = np.where(end_ >= 0, to_host(np.maximum(end_, 0)), -1)
    out["names"] = list(names)
    return Recording(
        **out, dev_name=np.asarray(dev_name, dtype=np.int32), dev_host=d["host"],
        dev_parent=d["parent"], dev_call=_i64(dev_call),
        dev_start=to_host(d["start"]), dev_end=mapped_end,
        while_time=to_host(d["while_time"]), while_span=d["while_span"],
        if_time=to_host(d["if_time"]), if_span=d["if_span"],
        stamps=cursor, dropped_stamps=max(cursor - len(records), 0),
        unmatched=d["unmatched"], clock_error_ns=(card.first[2], last[2]),
        resolution_ns=_resolution(records[:, 1]))
