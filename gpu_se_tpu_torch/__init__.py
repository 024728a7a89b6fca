"""PyTorch + CUDA port of ``gpu_se_tpu``'s state estimators and
controller, for one NVIDIA H100.

The JAX package ``gpu_se_tpu`` is the reference this package is tested
against; the two share no code. Layout mirrors the reference so each
counterpart is easy to find:

* ``models/``: the bioreactor regime functions on stacked ``(5, ...)``
  tensors, the ``NonlinearModel`` base with its host shells (bioreactor,
  CSTR, tanks) and the linear model with its linearizer;
* ``control/``: the dense ADMM QP and the condensed MPC;
* ``sim/``: the closed-loop harness and the on-device loop;
* ``distributions/gaussian_sum.py``: the Gaussian mixtures (draws, pdf,
  the deterministic replay mixture);
* ``filters/particle_tiled.py``: the fused predict + update + resample
  particle-filter step on an SoA ``(nx, n)`` state (``bench.py``'s step);
* ``filters/particle.py``: the flat ``ParticleFilter`` on ``(n, nx)``
  particles;
* ``filters/resampling.py``: systematic resampling and the router that
  picks a resample route by shape, with ``impl(route)`` to force one;
* ``filters/gs_ukf.py``: the Gaussian-sum unscented Kalman filter and its
  bank resample;
* ``ops/``: the resample routes, each a hand-written CUDA kernel with its
  plain PyTorch version beside it (``csrc/``, built by ``ops/_build.py``):
  ``compact`` and ``expand`` (``resample_pallas4.py``, also the v2 fused
  resample of ``resample_pallas2.py``), ``ends_merge_round``
  (``resample_pallas_block.py``), ``cumsum_merge``
  (``resample_pallas3.py``, ``resample_pallas.py``) and
  ``coarse_gather`` (``resample_coarse.py``); the blocked reductions and
  the small-matrix algebra of the GSUKF;
* ``rig.py``: the seeded inputs, bench rig and kernel edge cases shared
  by the tests and ``chip_smoke.py``;
* ``convert.py``: carries the reference's numpy arrays into the port.

Nothing here imports ``jax`` or ``gpu_se_tpu``. The Gaussian mixtures
are exported on first use, so that importing ``rig`` loads numpy only.
"""
__all__ = [
    "GaussianSum",
    "MultivariateGaussianSum",
    "DeterministicGaussianSum",
]


def __getattr__(name: str):
    if name in __all__:
        from gpu_se_tpu_torch import distributions
        return getattr(distributions, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
