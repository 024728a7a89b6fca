"""``resample_gather_roofline`` (%): the least time of the resample's
gather over the device time of the site span ``resample.gather`` (the
kernels ``compact`` and ``expand`` with the transposes around them, in
``ops/resample_pallas4.systematic_resample_tiled``), stamped inside each
replay of the graphed resample and summed over a stream's window, from the
program's recorder (``gpu_se_tpu_torch.trace``).

The least time is the bytes of the algorithm, whatever implements it:
read the rows of the ``m`` survivors once, write ``n`` rows and ``n``
int32 ancestors, at the card's memory rate (``card.least_time``). A row
is the particle's ``nx`` floats. ``m`` is counted from the weights of
each step the stream's harness sampled (``run.resample_inputs``) as
``resample_roofline`` counts it, the particles of weight at least
``1 / n`` of the total, each sure to survive: a lower bound, so the share
stays a least count. The sampled steps' mean least time stands for every
step of the window. Standard error says how the ``ends`` and the gather
together compare with their graphed call. Nothing is read where the
program stamps no such span."""
from __future__ import annotations

import numpy as np

from port_bench import card, site_spans


def row_bytes(work: dict):
    return 4 * work["nx"] if work.get("estimator") == "pf" else None


def survivors_at_least(weights) -> int:
    w = weights.double()
    return int((w * (w.shape[0] / w.sum()) >= 1.0).sum())


def least_seconds(work: dict, weights):
    rb = row_bytes(work)
    if rb is None:
        return None
    n = weights.shape[0]
    return card.least_time(survivors_at_least(weights) * rb + n * rb + 4 * n,
                           0)


def say_sum(run, gather) -> None:
    """The ``ends`` and the gather of each graphed resample against the
    call's own span, on standard error."""
    ends = site_spans.nested(run, "resample.ends", "graphed.resample")
    if ends is None:
        return
    both = {}
    for got in (ends, gather):
        for p, ms in zip(got.parent_id.tolist(), got.ms.tolist()):
            both[p] = both.get(p, 0.0) + ms
    call = dict(zip(gather.parent_id.tolist(), gather.parent_ms.tolist()))
    call.update(zip(ends.parent_id.tolist(), ends.parent_ms.tolist()))
    share = np.array([both[p] / call[p] for p in both if call[p] > 0])
    if len(share):
        run.say(f"resample.ends + resample.gather over their graphed "
                f"resample: median {np.median(share):.4f}, max "
                f"{share.max():.4f} over {len(share)} calls")


def read(run):
    got = site_spans.nested(run, "resample.gather", "graphed.resample")
    calls = run.resample_inputs
    if got is None or not calls or not run.work \
            or row_bytes(run.work) is None:
        return None
    site_spans.say(run, got)
    say_sum(run, got)
    least = float(np.mean([least_seconds(run.work, w) for _, w in calls]))
    return 100.0 * least * len(got.start) / (float(got.ms.sum()) * 1e-3)
