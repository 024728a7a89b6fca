"""``control_event_non_qp_device_ms`` (ms): the median, over the control
events of the window's episodes, of each event's device time outside the
QP's solve: the device span of the step's graphed call (as
``control_event_device_ms_p95`` reads it) less the device span of the
solve's graphed call captured inside it (the site
``graphed._device_solve``, stamped at each replay), from the program's
recorder (``gpu_se_tpu_torch.trace``). What remains is the filter's
predict, update, resample and point estimate, the MPC's per-event
products, the plant's step and the step's input copies and clones.
Standard error says the median, the 95th percentile and how many events
were read of the window's control events. Nothing is read where the
solve's span was not stamped."""
from __future__ import annotations

import numpy as np

from port_bench import program_spans


def read(run):
    got = program_spans.control_event_non_qp_device_ms(run)
    if got is None:
        return None
    ms, events = got
    p50, p95 = np.percentile(ms, [50, 95])
    run.say(f"control event device ms outside the QP's solve over "
            f"{len(ms)} of {events} events: median {p50:.4f}, p95 "
            f"{p95:.4f}")
    return float(p50)
