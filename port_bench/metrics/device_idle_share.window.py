"""``device_idle_share.window`` (%): 1 - the card's busy share over a
stream's whole window, from the program's own device spans
(``gpu_se_tpu_torch.trace``): the union of the window steps' top-level
device spans (each graphed call's, stamped on the card around its input
copies, its graph's replay and its clones, and the eager point
estimate's) over the time from the window's first begin stamp to its last
end stamp. The shells' staging copies of a few bytes lie outside them.
The idle gaps are put down to the host span open at each
(``program_spans``)."""
from __future__ import annotations

from port_bench import program_spans


def read(run):
    return program_spans.idle_share(run)
