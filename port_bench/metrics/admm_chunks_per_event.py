"""``admm_chunks_per_event``: the QP's WHILE iterations (chunks of
``check_every`` ADMM iterations), counted on the card
(``ops.graph_cond.iterations``) and read after each episode of the
window, over the control events of those episodes."""
from __future__ import annotations


def read(run):
    eps = [e for e in run.episodes if e.get("while_iterations") is not None]
    events = sum(e["events"] for e in eps)
    if not eps or not events:
        return None
    return sum(e["while_iterations"] for e in eps) / events
