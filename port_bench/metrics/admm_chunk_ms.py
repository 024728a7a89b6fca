"""``admm_chunk_ms``: the device time of one of the QP's WHILE iterations
(a chunk of ``check_every`` ADMM iterations), the least-squares slope of
each episode's device time (CUDA events around ``run.start`` and
``run.steps``) on the WHILE iterations the card counted in it. Every
episode has the same control events, so what the slope leaves is the
chunks' cost; it needs episodes of different iteration counts."""
from __future__ import annotations

import numpy as np


def read(run):
    eps = [e for e in run.episodes if e.get("while_iterations") is not None
           and e.get("device_ms") is not None]
    x = np.array([e["while_iterations"] for e in eps], dtype=float)
    y = np.array([e["device_ms"] for e in eps], dtype=float)
    if len(set(x.tolist())) < 2:
        return None
    return float(np.polyfit(x, y, 1)[0])
