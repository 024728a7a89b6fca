"""The v2 fused systematic resample: compaction, then a windowed expansion.

Counterpart of ``gpu_se_tpu/ops/resample_pallas2.py``. Its two TPU
kernels become:

* ``_compact_kernel`` (packs the survivor columns ``[x; C; flag]`` at the
  running total, ``C = ends + 1``) is served by the port's
  :func:`~gpu_se_tpu_torch.ops.resample_pallas4.compact`, which computes
  the same stable partition of the survivors ``ends_k > ends_{k-1}``
  with their payload and original index, and keeps the count on the
  device. The float ``C``, the ``flag`` row and the 128-aligned tail
  replay are how the TPU writes at an unaligned offset; the keys stay
  the int32 ``ends``, so ``C <= i`` reads ``ends < i``;
* ``_expand_kernel`` (the ancestor of slot ``i`` is ``#{survivors : C <=
  i}``, searched inside the survivor window of its output chunk) is
  :func:`~gpu_se_tpu_torch.ops.resample_pallas4.expand`, a hand-written
  CUDA kernel in ``csrc/resample_expand.cu``: one block per chunk of
  ``block`` slots stages the chunk's ``block + 1`` survivor keys in
  shared memory and searches them there. The port's other compacted
  routes gather through the same kernel.

``ends`` is the port's :func:`~gpu_se_tpu_torch.ops.resample_coarse.
ends_from_weights` (row-blocked cumsum and cummax, the same bits on
every run), where the reference takes a 1-d cumsum: the two may part at
float ties, and given the same ``ends`` the results are bit-equal.

:func:`expand` takes its plain version :func:`expand_plain` when its
tensors lie on the CPU and launches its kernel when they lie on a CUDA
device; there is no fallback from one to the other. ``expand.launches``
counts launches on every route.
"""
from __future__ import annotations

import torch

from gpu_se_tpu_torch.ops.resample_coarse import ends_from_weights
from gpu_se_tpu_torch.ops.resample_pallas4 import (  # noqa: F401
    compact,
    expand,
    expand_plain,
)

MAX_NX = 5           # state columns of the reference's stream layout


# ----------------------------------------------------------------------
# the entry point
# ----------------------------------------------------------------------
def check_geometry(n: int, nx: int, window: int, block: int) -> None:
    """The reference's constraints: ``nx <= 5``, ``n % window == 0`` and
    ``n % block == 0``."""
    if nx > MAX_NX:
        raise ValueError(f"{nx} state columns: the stream packs at most "
                         f"{MAX_NX}")
    for name, v in (("window", window), ("block", block)):
        if v < 1 or n % v:
            raise ValueError(f"n = {n} is not a multiple of {name} {v}")


def resample_v2_core(particles: torch.Tensor, weights: torch.Tensor, r,
                     window: int = 1024, block: int = 1024):
    """:func:`fused_systematic_resample_v2`, also returning the ancestors
    ``(n,)`` int32."""
    n, nx = particles.shape
    check_geometry(n, nx, window, block)
    ends = ends_from_weights(weights, r)
    c_keys, c_payload, c_idx, _ = compact(
        ends, particles.to(torch.float32).T.contiguous())
    out, anc = expand(c_keys, c_payload, c_idx, block)
    return out.T.to(particles.dtype), anc


def fused_systematic_resample_v2(particles: torch.Tensor,
                                 weights: torch.Tensor, r,
                                 window: int = 1024, block: int = 1024):
    """Systematic resample of ``particles (n, nx)`` by ``weights (n,)``
    and the float32 uniform ``r``: :func:`compact`, then :func:`expand` in
    chunks of ``block`` slots. Returns ``(n, nx)`` in ``particles.dtype``.

    ``window`` is the reference's compaction window; the port's
    compaction has none, so it is only checked (``n % window == 0``).
    """
    return resample_v2_core(particles, weights, r, window, block)[0]
