"""``event_enqueue_ms``: the host's time in each episode's ``run.steps``
call (it enqueues the steps' graph replays and returns before the card
finishes), over the episode's control events."""
from __future__ import annotations


def read(run):
    events = sum(e["events"] for e in run.episodes)
    if not events:
        return None
    return 1e3 * sum(e["enqueue_s"] for e in run.episodes) / events
