"""The bench rig and the seeded inputs of the reference fixtures, in numpy.

``scripts/make_torch_parity_fixture.py`` writes the fixtures from these
inputs, and the tests and ``chip_smoke.py`` recompute the noise and
inputs the fixtures do not store. The module imports numpy only, so the
card, which has no JAX, can import it.
"""
from __future__ import annotations

import numpy as np

NX = 5
NOISE_SEED = 11                     # the GSUKF fixture's sigma-point noise
R_GSUKF = 0.37                      # the GSUKF fixture's resample uniform
V2_SEED = 12                        # the v2 fixture's particles and weights
V2_GEOMETRY = (1024, 1024)          # the v2 fixture's (window, block)
X_SS = np.array([280 / 180, 640 / 24.6, 1000 / 116, 0.0, 0.0])


def bench_rig():
    """``(x0, state_pdf, meas_pdf)``: each a ``(means, covariances,
    weights)`` tuple of the Gaussian mixtures of ``bench.py``."""
    x0 = (np.stack([X_SS, X_SS]),
          np.stack([np.eye(5) * 1e-4, np.eye(5) * 1e-3]),
          np.array([0.75, 0.25]))
    state_pdf = (np.zeros((2, 5)),
                 np.stack([np.diag([1e-4, 1e-7, 1e-3, 1e-3, 1e-7]),
                           np.diag([1e-3, 1e-6, 1e-2, 1e-2, 1e-6])]),
                 np.array([0.75, 0.25]))
    meas_pdf = (np.array([[1e-1, 0], [0, -1e-1]]),
                np.array([[[6e-2, 0], [0, 8e-2]], [[500, 100], [100, 700]]]),
                np.array([0.85, 0.15]))
    return x0, state_pdf, meas_pdf


def gsukf_noise(sd: np.ndarray, n: int, seed: int = NOISE_SEED):
    """Sigma-point noise lanes-last ``(2 nx + 1, nx, n)`` float32: normals
    from ``default_rng(seed)`` scaled by ``sd (nx,)``."""
    nx = sd.shape[0]
    eps = np.random.default_rng(seed).standard_normal((2 * nx + 1, nx, n))
    return (eps * sd[None, :, None]).astype(np.float32)


def v2_case(n: int, seed: int = V2_SEED):
    """``(particles (n, 5), integer-valued weights, r)`` float32."""
    rng = np.random.default_rng(seed)
    parts = rng.standard_normal((n, NX)).astype(np.float32)
    w = np.floor(np.exp(2.0 * rng.standard_normal(n))).astype(np.float32)
    return parts, w, np.float32(rng.random())
