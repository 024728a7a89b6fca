"""``graph_call_host_ms`` (ms): the host time of a stream step's graphed
call (``graphed.predict``, ``graphed._update``, ``graphed.resample``)
outside its replay, the span's time less the time between its two marks
(flattening the arguments and the key, copying the inputs in, handing the
outputs out, the stamps), from the program's recorder
(``gpu_se_tpu_torch.trace``): the median over the window's calls. The
host runs ahead of the card, and once the launch queue is full it blocks
in whichever launch finds it full, a copy in or a clone handed out as
often as the replay: the median leaves those calls out, where the mean
would read the card's pace.

Streams only: in the closed loop the card sets the pace and every step
waits for it once, mostly in the clones handed out, so the same reading
there is the card's time, not the host's."""
from __future__ import annotations

import numpy as np

from port_bench import program_spans


def read(run):
    ms = program_spans.graph_call_host_ms(run)
    return None if ms is None else float(np.median(ms))
