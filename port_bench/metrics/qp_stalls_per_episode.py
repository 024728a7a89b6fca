"""``qp_stalls_per_episode``: the control events of an episode whose QP
solve did not end ``SOLVED`` (it ran to its iteration limit, and the
loop applied the fallback input), read from the episode's records, over
the window's episodes. A change to the QP's rounding moves
``control_event_ms`` through these as much as through a chunk's cost."""
from __future__ import annotations


def read(run):
    eps = [e for e in run.episodes if e.get("unsolved") is not None]
    if not eps:
        return None
    return sum(e["unsolved"] for e in eps) / len(eps)
