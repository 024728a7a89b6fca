"""The device's timeline from ``torch.profiler``: busy and idle time, the
operations that took most time, and the longest idle gaps named by what
the host was doing.

Only device timestamps measure the device: its busy time is the union of
the intervals in which a kernel, copy or fill ran, and the traced window
runs from the first such interval's start to the last one's end. A gap
is named by the launch of the operation that ended it: the innermost
``record_function`` range of the benchmark (``bench.*``) open on the
host at that launch, and the runtime call itself.
"""
from __future__ import annotations

import contextlib

TOP = 10


def _get(e, name, default=None):
    try:
        return getattr(e, name)()
    except (AttributeError, RuntimeError):
        return default


@contextlib.contextmanager
def traced(out: dict):
    """Profile the body (host and device) and summarize into ``out``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield
        torch.cuda.synchronize()
    out.update(summarize(prof.profiler.kineto_results.events()))


def summarize(events) -> dict:
    device, runtime, spans = [], {}, []
    for e in events:
        kind = str(_get(e, "device_type", ""))
        start, dur = _get(e, "start_ns", 0), _get(e, "duration_ns", 0)
        name = _get(e, "name", "?")
        activity = str(_get(e, "activity_type", ""))
        if kind.endswith("CUDA"):
            if "annotation" in activity or name.startswith("bench."):
                continue            # a host range drawn on the device
            link = (_get(e, "linked_correlation_id", 0),
                    _get(e, "correlation_id", 0))
            device.append((start, start + dur, name, link))
        elif activity == "cuda_runtime" or name.startswith("cuda"):
            runtime[_get(e, "correlation_id", 0)] = (start, name)
        elif name.startswith("bench."):
            spans.append((start, start + dur, name))
    if not device:
        return {}
    device.sort()
    busy, gaps, per_op = 0, [], {}
    cur_s, cur_e = device[0][0], device[0][1]
    for s, e, name, link in device:
        per_op[name] = per_op.get(name, 0) + (e - s)
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((s - cur_e, link))
            cur_s = s
        cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = cur_e - device[0][0]

    def host_doing(links):
        launch = next((runtime[k] for k in links if k in runtime), None)
        if launch is None:
            return "no launch recorded"
        t, call = launch
        inside = [sp for sp in spans if sp[0] <= t <= sp[1]]
        if not inside:
            return call
        return f"{min(inside, key=lambda sp: sp[1] - sp[0])[2]}/{call}"

    named = {}
    for length, link in gaps:
        key = host_doing(link)
        named.setdefault(key, []).append(length)
    idle = sorted(((k, max(v)) for k, v in named.items()),
                  key=lambda kv: -kv[1])[:TOP]
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": busy * 1e-9,
        "window_s": window * 1e-9,
        "breakdown": {
            "device_ops": [[n, v * 1e-9] for n, v in ops],
            "idle_gaps": [[n, v * 1e-9] for n, v in idle],
        },
        "device_events": len(device),
    }
