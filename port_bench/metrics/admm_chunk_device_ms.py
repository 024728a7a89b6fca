"""``admm_chunk_device_ms`` (ms): the median, over the window, of the gap
between consecutive WHILE stamps of one QP solve: one WHILE iteration (a
chunk of ``check_every`` ADMM iterations, its check and, when taken, the
refactorization) timed on the card by the conditional node's set kernel
(``csrc/graph_cond.cu``, through the program's recorder). Standard error
says the mean, the stamped iterations against those the card counted
(``graph_cond.iterations``, the episodes' ``while_iterations``) and how
many iterations ran a refactorization."""
from __future__ import annotations

import numpy as np

from port_bench import program_spans


def read(run):
    got = program_spans.while_gaps_ms(run)
    if got is None or not len(got[0]):
        return None
    gaps, stamped, refactored = got
    counted = sum(e["while_iterations"] for e in run.episodes
                  if e.get("while_iterations") is not None)
    run.say(f"WHILE iterations in the window: {stamped} stamped, {counted} "
            f"counted on the card; {refactored} ran a refactorization; "
            f"gap between iterations of one solve: median "
            f"{np.median(gaps):.5f} ms, mean {gaps.mean():.5f} ms over "
            f"{len(gaps)}")
    return float(np.median(gaps))
