"""Benchmark-quality statistics: the partial-autocorrelation gate.

Counterpart of ``gpu_se_tpu/utils/stats.py`` (numpy only, the same
code). A timing run sequence counts as independent samples when its
largest partial autocorrelation over lags 1..10 stays under 0.2, the
gate of the reference's run-sequence campaigns; the pacf is a
self-contained Durbin-Levinson recursion in the statsmodels convention.
"""
from __future__ import annotations

import numpy as np


def acf(x: np.ndarray, nlags: int) -> np.ndarray:
    """Sample autocorrelation function up to ``nlags``."""
    x = np.asarray(x, dtype=float)
    x = x - x.mean()
    n = len(x)
    denom = np.dot(x, x)
    if denom == 0:
        return np.zeros(nlags + 1)
    return np.array(
        [1.0] + [np.dot(x[: n - k], x[k:]) / denom for k in range(1, nlags + 1)]
    )


def pacf(x: np.ndarray, nlags: int = 10) -> np.ndarray:
    """Partial autocorrelation via the Durbin-Levinson recursion.

    Returns ``nlags + 1`` values with pacf[0] = 1, matching the
    statsmodels convention used by the reference.
    """
    rho = acf(x, nlags)
    out = np.zeros(nlags + 1)
    out[0] = 1.0
    if nlags == 0:
        return out
    phi_prev = np.array([rho[1]])
    out[1] = rho[1]
    for k in range(2, nlags + 1):
        num = rho[k] - np.dot(phi_prev, rho[k - 1 : 0 : -1])
        den = 1.0 - np.dot(phi_prev, rho[1:k])
        phi_kk = num / den if den != 0 else 0.0
        out[k] = phi_kk
        phi_prev = np.concatenate([phi_prev - phi_kk * phi_prev[::-1], [phi_kk]])
    return out


def max_abs_pacf(x: np.ndarray, nlags: int = 10) -> float:
    """The reference's benchmark-validity statistic: max |pacf| over lags
    1..nlags (threshold 0.2, cf. pf_run_seq.py:393-397)."""
    return float(np.abs(pacf(x, nlags)[1:]).max())
