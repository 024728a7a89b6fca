"""``resample_ends_device_ms`` (ms): the median, over a stream's window,
of the device time of the resample's integer ``ends`` (the blocked
cumulative sum of the weights, ``floor(n cs - r)`` and its running
maximum, ``ops/resample_coarse.ends_from_weights``): the site span
``resample.ends``, stamped inside each replay of the graphed resample and
nested in its device span, from the program's recorder
(``gpu_se_tpu_torch.trace``). Standard error says how many were read, how
many lie inside their call's span and the call's median. Nothing is read
where the program stamps no such span."""
from __future__ import annotations

from port_bench import site_spans


def read(run):
    return site_spans.median_ms(run, "resample.ends", "graphed.resample")
