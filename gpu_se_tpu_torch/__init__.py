"""PyTorch + CUDA port of the tiled particle-filter step of ``gpu_se_tpu``.

The JAX package ``gpu_se_tpu`` is the reference this package is tested
against; the two share no code. Layout mirrors the reference so each
counterpart is easy to find:

* ``models/bioreactor.py``: the bioreactor regime functions on stacked
  ``(5, ...)`` tensors;
* ``distributions/gaussian_sum.py``: the Gaussian-mixture noise and
  measurement pdf;
* ``ops/resample_coarse.py``: the monotonized integer ``ends``;
* ``ops/resample_pallas4.py``: the compaction and search + gather CUDA
  kernels (``csrc/resample.cu``, ``csrc/resample_expand.cu``), their
  plain PyTorch versions and the entry points;
* ``filters/resampling.py``: plain systematic resampling, the kernels'
  oracles;
* ``filters/particle_tiled.py``: the fused predict + update + resample
  step on an SoA ``(nx, n)`` state;
* ``convert.py``: carries the reference's numpy arrays into the port.

Nothing here imports ``jax`` or ``gpu_se_tpu``.
"""
