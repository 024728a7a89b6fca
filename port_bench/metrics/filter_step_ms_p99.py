"""``filter_step_ms_p99``: the 99th percentile, over every step of the
window, of the step's device time from just before its ``predict`` to
just after its ``resample`` (CUDA events in the timed path): the stages'
times and the card's idle gaps between them while the host feeds the
next call. It shows throughput bought with uneven steps."""
from __future__ import annotations

import numpy as np


def read(run):
    stages = [run.stage_ms.get(k) for k in ("predict", "update", "resample")]
    if not all(stages):
        return None
    return float(np.percentile(np.sum(stages, axis=0), 99))
