"""``predict_roofline`` (%): the least time of the filter's predict over
the device time of its graphed ``predict`` calls (CUDA events around
each call in the window).

The least time is the larger of the bytes at the card's memory rate and
the float32 operations at its rate (``card.least_time``). Bytes: the
state read once and written once; a covariance counts its 15 distinct
entries. Operations, a least count of the arithmetic: the model's
``f`` (45 a point), the noise's affine map (30 a point: a mean and a
lower-triangular factor) and the sum of the three (10); the GSUKF adds
the factor (50), the sigma points (50) and the recombination of the
mean (110) and covariance (495) over its 11 points. Random bits and
transcendental functions are not counted.
"""
from __future__ import annotations

from port_bench import card

F_OPS, NOISE_OPS, SUM_OPS = 45, 30, 10


def least_seconds(work: dict):
    n, nx = work["n"], work["nx"]
    tri = nx * (nx + 1) // 2
    if work["estimator"] == "pf":
        return card.least_time(2 * 4 * n * nx, n * (F_OPS + NOISE_OPS
                                                    + SUM_OPS))
    if work["estimator"] == "gsukf":
        points = 2 * nx + 1
        ops = 50 + 50 + points * (F_OPS + NOISE_OPS + SUM_OPS) + 110 + 495
        return card.least_time(2 * 4 * n * (nx + tri), n * ops)
    return None


def read(run):
    times = run.stage_ms.get("predict")
    least = least_seconds(run.work) if run.work else None
    if not times or least is None:
        return None
    return 100.0 * least * len(times) / (sum(times) * 1e-3)
