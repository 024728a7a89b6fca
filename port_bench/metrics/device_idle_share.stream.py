"""``device_idle_share.stream`` (%): 1 - the device's busy share over the
traced stretch of stream steps after the window, from the profiler's
device timeline alone (``tracing.summarize``)."""
from __future__ import annotations


def read(run):
    t = run.trace_data
    if not t or not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
