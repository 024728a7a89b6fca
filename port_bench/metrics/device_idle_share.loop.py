"""``device_idle_share.loop`` (%): 1 - the card's busy share over the
closed loop's window, from the program's own device spans
(``gpu_se_tpu_torch.trace``): the union of the window episodes'
``loop.start`` device spans and of each step's ``graphed.step`` device
span, over the time from the first episode's begin stamp to the last
step's end stamp. The stamps run on the card, so the QP's WHILE chunks
inside a step's graph count as busy; a gap between two steps of an
episode, and between episodes (the benchmark's reads of each episode),
counts as idle, put down to the host span open at it
(``program_spans``)."""
from __future__ import annotations

from port_bench import program_spans


def read(run):
    return program_spans.idle_share(run)
