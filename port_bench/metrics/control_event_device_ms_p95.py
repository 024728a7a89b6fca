"""``control_event_device_ms_p95`` (ms): the 95th percentile, over the
control events of the window's episodes, of each event's device time:
the device span of the step's graphed call (``graphed.step`` under a
``loop.step`` whose control flag is set; stamped on the card around its
input copies, its graph's replay with the QP's WHILE loop inside, and its
clones), from the program's recorder (``gpu_se_tpu_torch.trace``).
Standard error says the median, the 95th and 99th percentiles, the
largest and how many events lie beyond each percentile."""
from __future__ import annotations

import numpy as np

from port_bench import program_spans


def read(run):
    ms = program_spans.control_event_device_ms(run)
    if ms is None:
        return None
    p50, p95, p99 = np.percentile(ms, [50, 95, 99])
    run.say(f"control event device ms over {len(ms)} events: median "
            f"{p50:.4f}, p95 {p95:.4f} ({int((ms > p95).sum())} beyond), "
            f"p99 {p99:.4f} ({int((ms > p99).sum())} beyond), max "
            f"{ms.max():.4f}")
    return float(p95)
