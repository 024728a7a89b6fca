"""Systematic resample through two hand-written CUDA kernels.

Counterpart of ``gpu_se_tpu/ops/resample_pallas4.py``. The kernels live
in ``csrc/resample.cu``:

* :func:`search_gather` (K1, replaces ``_kernel``): the ancestor of each
  output slot ``i`` is the first ``j`` with ``keys[j] >= i``; gathers
  that column of the payload and, optionally, its original index;
* :func:`compact` (K2, replaces ``_compact_kernel``): keeps the entries
  with ``ends_k > ends_{k-1}`` (exactly the possible ancestors) in order,
  then pads with ``INT32_MAX`` keys.

The payload is structure-of-arrays ``(rows, n)`` float32 of any height,
and the ancestors and ``ends`` stay int32 (the reference carries them in
float32 tile rows, exact only up to 2^24).

Each wrapper takes the plain PyTorch version beside it when its tensors
lie on the CPU and launches its kernel when they lie on a CUDA device;
there is no fallback from one to the other. ``<wrapper>.launches``
counts kernel launches.

Route. :func:`resample_core` always compacts and then searches the
compacted keys. The reference chooses between a direct and a compacted
route (``resample_tiled_core``'s two ``lax.cond``) only because its
bounded TPU window can overflow on heavy-tailed weights; the global
search has no window, so both routes are exact everywhere and the port
needs no such switch. :func:`search_gather` on the uncompacted ``ends``
is the direct route.
"""
from __future__ import annotations

import torch

from gpu_se_tpu_torch.ops import _build
from gpu_se_tpu_torch.ops.resample_coarse import (
    ends_from_weights,
    indices_from_ends,
)

INT32_MAX = 2**31 - 1


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-d, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch_check(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


# ----------------------------------------------------------------------
# K1 search_gather
# ----------------------------------------------------------------------
def search_gather_plain(keys, payload, src_idx=None):
    """Plain version of :func:`search_gather`."""
    j = indices_from_ends(keys).clamp_max_(keys.shape[0] - 1)
    out = torch.index_select(payload, 1, j)
    if src_idx is None:
        return out, j
    return out, torch.index_select(src_idx, 0, j)


def search_gather(keys: torch.Tensor, payload: torch.Tensor,
                  src_idx: torch.Tensor | None = None):
    """Ancestor search and payload gather over ``n = len(keys)`` slots.

    ``keys`` int32 ``(n,)`` non-decreasing with ``keys[-1] >= n - 1``;
    ``payload`` float32 ``(rows, n)``; ``src_idx`` optional int32 ``(n,)``.
    Returns ``out (rows, n)`` with ``out[:, i] = payload[:, j_i]`` and
    ``anc (n,)`` int32 with ``anc[i] = src_idx[j_i]`` (or ``j_i``), where
    ``j_i`` is the first ``j`` with ``keys[j] >= i``.
    """
    dev = keys.device
    _check("keys", keys, torch.int32, 1, dev)
    _check("payload", payload, torch.float32, 2, dev)
    n = keys.shape[0]
    if n == 0 or payload.shape[1] != n:
        raise ValueError(f"payload {tuple(payload.shape)} vs keys ({n},)")
    if src_idx is not None:
        _check("src_idx", src_idx, torch.int32, 1, dev)
        if src_idx.shape[0] != n:
            raise ValueError(f"src_idx {tuple(src_idx.shape)} vs keys ({n},)")
    if not _on_cuda(keys):
        return search_gather_plain(keys, payload, src_idx)
    lib = _build.load_library()
    rows = payload.shape[0]
    out = torch.empty((rows, n), dtype=torch.float32, device=dev)
    anc = torch.empty((n,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.gst_search_gather(
            keys.data_ptr(), n, payload.data_ptr(), rows,
            None if src_idx is None else src_idx.data_ptr(), n,
            out.data_ptr(), anc.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _launch_check("search_gather", rc)
    search_gather.launches += 1
    return out, anc


search_gather.launches = 0


# ----------------------------------------------------------------------
# K2 compact
# ----------------------------------------------------------------------
def compact_plain(ends, payload):
    """Plain version of :func:`compact` (syncs with the host)."""
    n = ends.shape[0]
    prev = torch.cat([ends.new_full((1,), -1), ends[:-1]])
    kept = torch.nonzero(ends > prev).squeeze(1)
    m = kept.shape[0]
    c_keys = ends.new_full((n,), INT32_MAX)
    c_keys[:m] = ends[kept]
    c_payload = payload.new_zeros(payload.shape)
    c_payload[:, :m] = payload[:, kept]
    c_idx = ends.new_full((n,), -1)
    c_idx[:m] = kept.to(torch.int32)
    count = torch.full((1,), m, dtype=torch.int32, device=ends.device)
    return c_keys, c_payload, c_idx, count


def compact(ends: torch.Tensor, payload: torch.Tensor):
    """Keep the entries ``k`` with ``ends_k > ends_{k-1}`` (``ends_{-1} =
    -1``), in order.

    ``ends`` int32 ``(n,)`` non-decreasing, ``payload`` float32
    ``(rows, n)``. Returns ``(c_keys, c_payload, c_idx, count)``: the
    survivors' ends, payload columns and original indices first, then a
    tail of ``INT32_MAX`` keys, zero columns and index ``-1``; ``count``
    is a ``(1,)`` int32 tensor on the device (no host sync).
    """
    dev = ends.device
    _check("ends", ends, torch.int32, 1, dev)
    _check("payload", payload, torch.float32, 2, dev)
    n = ends.shape[0]
    if n == 0 or payload.shape[1] != n:
        raise ValueError(f"payload {tuple(payload.shape)} vs ends ({n},)")
    if not _on_cuda(ends):
        return compact_plain(ends, payload)
    lib = _build.load_library()
    rows = payload.shape[0]
    nblocks = lib.gst_compact_blocks(n)
    scratch = torch.empty((2, nblocks), dtype=torch.int32, device=dev)
    c_keys = torch.empty((n,), dtype=torch.int32, device=dev)
    c_payload = torch.empty((rows, n), dtype=torch.float32, device=dev)
    c_idx = torch.empty((n,), dtype=torch.int32, device=dev)
    count = torch.empty((1,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.gst_compact(
            ends.data_ptr(), payload.data_ptr(), rows, n,
            scratch[0].data_ptr(), scratch[1].data_ptr(),
            c_keys.data_ptr(), c_payload.data_ptr(), c_idx.data_ptr(),
            count.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _launch_check("compact", rc)
    compact.launches += 1
    return c_keys, c_payload, c_idx, count


compact.launches = 0


# ----------------------------------------------------------------------
# entry points
# ----------------------------------------------------------------------
def resample_core(x: torch.Tensor, ends: torch.Tensor):
    """Resample the ``(rows, n)`` payload ``x`` by the monotonized ``ends``:
    :func:`compact`, then :func:`search_gather` on the survivors.
    Returns ``(x[:, anc], anc)``."""
    c_keys, c_payload, c_idx, _ = compact(ends, x)
    return search_gather(c_keys, c_payload, c_idx)


def resample_core_plain(x: torch.Tensor, ends: torch.Tensor):
    """:func:`resample_core` through both plain versions."""
    c_keys, c_payload, c_idx, _ = compact_plain(ends, x)
    return search_gather_plain(c_keys, c_payload, c_idx)


def systematic_resample_tiled(particles: torch.Tensor, weights: torch.Tensor,
                              r):
    """Systematic resample of ``particles (n, nx)`` float32 by
    ``weights (n,)`` and the uniform ``r``; returns
    ``(resampled (n, nx), ancestors (n,) int32)``. Any ``n >= 1`` and any
    ``nx`` (the reference's entry takes ``nx <= 5``)."""
    ends = ends_from_weights(weights, r)
    out, anc = resample_core(particles.T.contiguous(), ends)
    return out.T, anc
