"""The program's own span recorder (``gpu_se_tpu_torch.trace``) read over
a run's window, for the per-layer metrics measured inside the program.

The window's spans are picked by the counts the run already holds.
In a stream: the ``run.attempted`` steps after ``warmup_steps``, a step
starting at a top-level ``shell.predict``. In the closed loop: the first
``len(run.episodes)`` top-level ``loop.steps`` spans (the loop's
warm-up calls the step's graph directly, so the window's episodes come
first), each with the ``loop.start`` before it. A device span belongs to
the window when the top-level host call it ran for does.

The recorder is collected once a run. A program without the recorder,
a recorder switched off, a recording that stopped short (a ring filled)
or a run off the card gives no window, and every reader returns None.

The card's idle time inside the window is what the union of the
window's top-level device spans leaves out. The program brackets on the
card only spans that enqueue work of their own (a graphed call, an eager
point estimate, an episode's start; in the loop each step's graphed
call, not the episode around them), so a gap between two of them is time
in which the card ran none of the program's work. Each idle gap is put
down to the innermost host span open at its midpoint, or to ``outside``
the program; inside a replayed ``graphed.*`` call, to its phase by the
span's marks (``/copy_in`` before the replay, ``/replay``,
``/hand_out`` after it). The five labels that took the most idle time
are printed on standard error with their totals.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

TOP = 5
_memo: list = [None, None]      # the last run and its window


@dataclass
class Window:
    rec: object                  # gpu_se_tpu_torch.trace.Recording
    lo: int                      # the window's host spans: [lo, hi)
    hi: int
    dev: np.ndarray              # the window's device spans (indices)
    busy_ns: int
    span_ns: int
    idle_by: dict                # label (host span, phase, "outside") -> ns


def _collect(device):
    from gpu_se_tpu_torch import trace
    return trace.collect(device)


def window(run):
    """The run's :class:`Window`, or None."""
    if _memo[0] is not run:
        _memo[:] = [run, _window(run)]
    return _memo[1]


def _window(run):
    if getattr(run.device, "type", "cpu") != "cuda":
        return None
    try:
        rec = _collect(run.device)
    except ImportError:
        return None
    if not rec.complete or not len(rec.dev_start):
        return None
    bounds = select(rec, run.traffic.get("kind"),
                    int(run.traffic.get("warmup_steps", 0)),
                    int(run.attempted), len(run.episodes))
    if bounds is None:
        return None
    lo, hi = bounds
    tops = np.flatnonzero(rec.parent[lo:hi] == -1) + lo
    dev = np.flatnonzero(np.isin(rec.dev_call, tops) & (rec.dev_end >= 0))
    if not len(dev):
        return None
    top = dev[rec.dev_parent[dev] < 0]
    if not len(top):
        return None
    gaps, busy, span = idle_gaps(rec.dev_start[top], rec.dev_end[top])
    mids = (gaps[:, 0] + gaps[:, 1]) // 2
    who = innermost(rec.start[lo:hi], rec.end[lo:hi], mids)
    idle_by: dict = {}
    for (a, b), k, t in zip(gaps.tolist(), who.tolist(), mids.tolist()):
        label = label_at(rec, lo + k, t) if k >= 0 else "outside"
        idle_by[label] = idle_by.get(label, 0) + b - a
    w = Window(rec, lo, hi, dev, busy, span, idle_by)
    ranked = sorted(idle_by.items(), key=lambda kv: -kv[1])[:TOP]
    run.say(f"program spans: {hi - lo} host, {len(dev)} on the card over "
            f"{span * 1e-9:.6f} s of the window; clock map error "
            f"{rec.clock_error_ns} ns, timer resolution {rec.resolution_ns} ns")
    run.say("idle on the card, by the host span open at the gap: " + "; ".join(
        f"{name} {ns * 1e-6:.4f} ms" for name, ns in ranked))
    return w


def label_at(rec, i: int, t: int) -> str:
    """Host span ``i``'s name at time ``t``, with the phase of a replayed
    graphed call (its marks: the replay's start and return)."""
    name = rec.names[rec.name[i]]
    m0, m1 = rec.mark[i].tolist()
    if not name.startswith("graphed.") or m0 < 0 or m1 < 0:
        return name
    return name + ("/copy_in" if t < m0 else "/replay" if t < m1
                   else "/hand_out")


def select(rec, kind, warmup: int, attempted: int, episodes: int):
    """``(lo, hi)``: the window's host spans, or None if the recording
    does not hold the window the counts name."""
    names = rec.names
    tops = np.flatnonzero(rec.parent == -1)
    if kind == "stream":
        if "shell.predict" not in names or attempted <= 0:
            return None
        steps = tops[rec.name[tops] == names.index("shell.predict")]
        if len(steps) < warmup + attempted:
            return None
        hi = steps[warmup + attempted] if len(steps) > warmup + attempted \
            else len(rec.name)
        return int(steps[warmup]), int(hi)
    if kind == "closed_loop":
        if "loop.steps" not in names or "loop.start" not in names \
                or episodes <= 0:
            return None
        eps = tops[rec.name[tops] == names.index("loop.steps")]
        starts = tops[rec.name[tops] == names.index("loop.start")]
        starts = starts[starts < eps[0]] if len(eps) else starts
        if len(eps) < episodes or not len(starts):
            return None
        later = tops[tops > eps[episodes - 1]]
        return int(starts[-1]), int(later[0]) if len(later) \
            else len(rec.name)
    return None


def idle_gaps(starts: np.ndarray, ends: np.ndarray):
    """``(gaps, busy, span)``: the gaps ``(from, to)`` between the union
    of the intervals, the union's length and the length from the first
    start to the last end."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], np.maximum.accumulate(ends[order])
    new = np.flatnonzero(s[1:] > e[:-1]) + 1
    gaps = np.stack([e[new - 1], s[new]], axis=1) if len(new) \
        else np.zeros((0, 2), dtype=np.int64)
    span = int(e[-1] - s[0])
    return gaps, span - int((gaps[:, 1] - gaps[:, 0]).sum()), span


def innermost(starts: np.ndarray, ends: np.ndarray, times: np.ndarray):
    """For each time, the innermost of the (nested, start-ordered) spans
    open at it, or -1; an end of -1 is a span never closed."""
    ends = np.where(ends < 0, np.iinfo(np.int64).max, ends)
    out = np.full(len(times), -1, dtype=np.int64)
    stack: list = []
    j, n = 0, len(starts)
    s, e = starts.tolist(), ends.tolist()
    for k in np.argsort(times, kind="stable").tolist():
        t = int(times[k])
        while j < n and s[j] <= t:
            while stack and e[stack[-1]] <= s[j]:
                stack.pop()
            stack.append(j)
            j += 1
        while stack and e[stack[-1]] < t:
            stack.pop()
        out[k] = stack[-1] if stack else -1
    return out


def idle_share(run):
    """% of the window in which no device span of the program ran."""
    w = window(run)
    if w is None or w.span_ns <= 0:
        return None
    return 100.0 * (1.0 - w.busy_ns / w.span_ns)


def _named(rec, lo: int, hi: int, name: str) -> np.ndarray:
    """The window's host spans named ``name``."""
    if name not in rec.names:
        return np.zeros(0, dtype=np.int64)
    return np.flatnonzero(rec.name[lo:hi] == rec.names.index(name)) + lo


# the QP's solve, a graphed call captured into the step's graph: a site
SOLVE_SITE = "graphed._device_solve"


def control_event_device_ms(run):
    """The device time of each control step's graphed step over the
    window's episodes, ms, or None."""
    got = control_step_spans(run)
    if got is None:
        return None
    rec, dev = got
    return (rec.dev_end[dev] - rec.dev_start[dev]) * 1e-6


def control_event_non_qp_device_ms(run):
    """``(ms, events)``: the device time of each control step's graphed
    step over the window's episodes less that of the QP's solve nested
    in it (the :data:`SOLVE_SITE` span, stamped at each replay), ms, for
    the events whose solve was stamped, and the number of control events
    in the window; or None where no solve span was stamped."""
    got = control_step_spans(run)
    if got is None or SOLVE_SITE not in got[0].names:
        return None
    rec, dev = got
    kids = np.flatnonzero((rec.dev_name == rec.names.index(SOLVE_SITE))
                          & np.isin(rec.dev_parent, dev)
                          & (rec.dev_end >= 0))
    if not len(kids):
        return None
    solve = np.zeros(len(rec.dev_start), dtype=np.int64)
    np.add.at(solve, rec.dev_parent[kids],
              rec.dev_end[kids] - rec.dev_start[kids])
    had = dev[np.isin(dev, rec.dev_parent[kids])]
    return ((rec.dev_end[had] - rec.dev_start[had] - solve[had]) * 1e-6,
            len(dev))


def control_step_spans(run):
    """``(recording, spans)``: the device spans of each control step's
    graphed step over the window's episodes, or None."""
    w = window(run)
    if w is None:
        return None
    rec = w.rec
    steps = [i for i in _named(rec, w.lo, w.hi, "loop.step").tolist()
             if rec.attr[i] is not None and rec.attr[i][1]]
    graphed = _named(rec, w.lo, w.hi, "graphed.step")
    graphed = graphed[np.isin(rec.parent[graphed], steps)]
    on_card = np.full(len(rec.name), -1, dtype=np.int64)
    eager = np.flatnonzero((rec.dev_host >= 0) & (rec.dev_end >= 0))
    on_card[rec.dev_host[eager]] = eager
    dev = on_card[graphed]
    dev = dev[dev >= 0]
    if not len(dev):
        return None
    return rec, dev


def while_gaps_ms(run):
    """``(gaps, iterations, refactorizations)``: the gaps between
    consecutive WHILE stamps of one solve over the window, ms, and the
    window's stamped iterations and taken refactorizations; or None."""
    w = window(run)
    if w is None:
        return None
    rec = w.rec
    inside = np.zeros(len(rec.dev_start), dtype=bool)
    inside[w.dev] = True
    sel = (rec.while_span >= 0) & inside[np.maximum(rec.while_span, 0)]
    t, span = rec.while_time[sel], rec.while_span[sel]
    same = span[1:] == span[:-1]
    refac = (rec.if_span >= 0) & inside[np.maximum(rec.if_span, 0)]
    return (np.diff(t)[same] * 1e-6, int(sel.sum()), int(refac.sum()))


def graph_call_host_ms(run):
    """The host time of each replayed graphed call of the window outside
    its replay (its marks), ms: flattening and key, copies in, hand-out,
    stamps; or None."""
    w = window(run)
    if w is None:
        return None
    rec = w.rec
    ids = [k for k, n in enumerate(rec.names) if n.startswith("graphed.")]
    idx = np.arange(w.lo, w.hi)
    mark = rec.mark[idx]
    calls = idx[np.isin(rec.name[idx], ids)
                & ~np.isin(rec.name[np.maximum(rec.parent[idx], 0)], ids)
                & (rec.end[idx] >= 0) & (mark >= 0).all(axis=1)]
    if not len(calls):
        return None
    blocked = rec.mark[calls, 1] - rec.mark[calls, 0]
    return (rec.end[calls] - rec.start[calls] - blocked) * 1e-6
