"""``resample_roofline`` (%): the least time of systematic resampling
from each sampled call's own weights, over the device time of those
graphed ``resample`` calls (CUDA events).

The work is that of the algorithm, whatever implements it: read the
``n`` weights, read the rows of the ``m`` survivors once, write ``n``
rows and ``n`` weights. ``m`` is counted from the call's weights as the
particles of weight at least ``1 / n`` of the total, each of which is
sure to survive: a lower bound, so the share stays a least count. A row
is the particle (``nx`` floats) or the Gaussian (its mean and the 15
distinct entries of its covariance). Bytes alone: the cumulative sum and
the searches are not counted.
"""
from __future__ import annotations

from port_bench import card


def row_bytes(work: dict):
    nx = work["nx"]
    if work["estimator"] == "pf":
        return 4 * nx
    if work["estimator"] == "gsukf":
        return 4 * (nx + nx * (nx + 1) // 2)
    return None


def survivors_at_least(weights) -> int:
    w = weights.double()
    return int((w * (w.shape[0] / w.sum()) >= 1.0).sum())


def least_seconds(work: dict, weights):
    rb = row_bytes(work)
    if rb is None:
        return None
    n = weights.shape[0]
    m = survivors_at_least(weights)
    return card.least_time(4 * n + m * rb + n * rb + 4 * n, 0)


def read(run):
    calls = run.resample_inputs
    if not calls or not run.work or row_bytes(run.work) is None:
        return None
    least = sum(least_seconds(run.work, w) for _, w in calls)
    return 100.0 * least / (sum(ms for ms, _ in calls) * 1e-3)
