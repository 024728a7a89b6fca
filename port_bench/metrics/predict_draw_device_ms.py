"""``predict_draw_device_ms`` (ms): the median, over a stream's window,
of the device time of the particle filter's state-noise draw: the site
span ``predict.draw`` (the mixture's component choice, the normal draw
and its transform, in ``filters/particle.predict``), stamped inside each
replay of the graphed predict and nested in its device span, from the
program's recorder (``gpu_se_tpu_torch.trace``). Standard error says how
many were read, how many lie inside their call's span and the call's
median. Nothing is read where the program stamps no such span."""
from __future__ import annotations

from port_bench import site_spans


def read(run):
    return site_spans.median_ms(run, "predict.draw", "graphed.predict")
