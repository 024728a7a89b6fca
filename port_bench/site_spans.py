"""The program's site spans inside a stage's graphed call, over a run's
window (``program_spans.window``): device spans that the recorder
(``gpu_se_tpu_torch.trace``) stamps inside a captured stage at each of
its replays, such as ``predict.draw`` inside ``graphed.predict`` and
``resample.ends``, ``resample.gather`` inside ``graphed.resample``.

A site span is read where its innermost enclosing device span is the
stage's own (a stream's graphed call; in the closed loop the same sites
nest in the step's ``graphed.step`` and are not read here). A program
that stamps no such site, or a run without a window, gives nothing.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from port_bench import program_spans


@dataclass
class Nested:
    """The window's site spans named ``name`` inside device spans named
    ``parent``: each site span's and its parent's start and end (host ns
    on the recorder's one clock), and the window's count of the parent's
    spans."""

    name: str
    parent: str
    start: np.ndarray
    end: np.ndarray
    parent_id: np.ndarray
    parent_start: np.ndarray
    parent_end: np.ndarray
    parents: int

    @property
    def ms(self) -> np.ndarray:
        return (self.end - self.start) * 1e-6

    @property
    def parent_ms(self) -> np.ndarray:
        return (self.parent_end - self.parent_start) * 1e-6

    @property
    def inside(self) -> int:
        """How many lie inside their parent's span."""
        return int(((self.start >= self.parent_start)
                    & (self.end <= self.parent_end)).sum())


def nested(run, name: str, parent: str):
    """The :class:`Nested` spans of ``name`` in ``parent``, or None."""
    w = program_spans.window(run)
    if w is None:
        return None
    rec = w.rec
    if name not in rec.names or parent not in rec.names:
        return None
    dev = w.dev
    kids = dev[(rec.dev_name[dev] == rec.names.index(name))
               & (rec.dev_end[dev] >= 0)]
    up = rec.dev_parent[kids]
    kids, up = kids[up >= 0], up[up >= 0]
    pid = rec.names.index(parent)
    keep = rec.dev_name[up] == pid
    kids, up = kids[keep], up[keep]
    if not len(kids):
        return None
    parents = int(((rec.dev_name[dev] == pid) & (rec.dev_end[dev] >= 0)
                   & (rec.dev_parent[dev] < 0)).sum())
    return Nested(name, parent, rec.dev_start[kids], rec.dev_end[kids], up,
                  rec.dev_start[up], rec.dev_end[up], parents)


def say(run, got: Nested) -> None:
    """One line on standard error: how many were read, how many lie
    inside their parent, and the medians of both."""
    run.say(f"{got.name} in {got.parent}: {len(got.start)} spans in "
            f"{len(np.unique(got.parent_id))} of {got.parents} calls, "
            f"{got.inside} inside their call's span; median "
            f"{np.median(got.ms):.4f} ms of the call's "
            f"{np.median(got.parent_ms):.4f} ms")


def median_ms(run, name: str, parent: str):
    """The median device time of the window's ``name`` spans in
    ``parent``, ms, said on standard error; or None."""
    got = nested(run, name, parent)
    if got is None:
        return None
    say(run, got)
    return float(np.median(got.ms))
