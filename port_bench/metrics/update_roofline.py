"""``update_roofline`` (%): the least time of the filter's update over
the device time of its graphed ``update`` calls (CUDA events around
each call in the window).

Bytes: the particle filter reads the two measured columns of each row
and its weight and writes the weight; the GSUKF reads and writes each
Gaussian's mean, the 15 distinct entries of its covariance and its
weight. Operations, a least count: the mixture density of a residual
(30 a point) and, for the GSUKF, the local UKF update over 11 sigma
points (700 a Gaussian). The least time is ``card.least_time``.
"""
from __future__ import annotations

from port_bench import card

PDF_OPS, UKF_OPS = 30, 700
MEASURED = 2


def least_seconds(work: dict):
    n, nx = work["n"], work["nx"]
    tri = nx * (nx + 1) // 2
    if work["estimator"] == "pf":
        return card.least_time(n * 4 * (MEASURED + 2), n * PDF_OPS)
    if work["estimator"] == "gsukf":
        return card.least_time(2 * 4 * n * (nx + tri + 1),
                               n * (UKF_OPS + PDF_OPS))
    return None


def read(run):
    times = run.stage_ms.get("update")
    least = least_seconds(run.work) if run.work else None
    if not times or least is None:
        return None
    return 100.0 * least * len(times) / (sum(times) * 1e-3)
