"""Systematic resample through two hand-written CUDA kernels.

Counterpart of ``gpu_se_tpu/ops/resample_pallas4.py``:

* :func:`expand` (K1, ``csrc/resample_expand.cu``, replaces ``_kernel``
  and ``resample_pallas2._expand_kernel``): the ancestor of each output
  slot ``i`` is the first ``j`` with ``keys[j] >= i``; gathers that
  column of the payload and, optionally, its original index. One CUDA
  block per chunk of output slots brackets the chunk's survivor window
  with one warp, stages it in shared memory and searches it there, one
  thread per 4 slots;
* :func:`compact` (K2, ``csrc/resample.cu``, replaces ``_compact_kernel``
  and ``resample_pallas2._compact_kernel``): keeps the entries with
  ``ends_k > ends_{k-1}`` (exactly the possible ancestors) in order, then
  pads with ``INT32_MAX`` keys: one launch, a single-pass scan with
  decoupled look-back.

Every route that gathers from compacted keys (the tiled step, the flat
filter's auto route, the Gaussian bank and the v2 entry) takes the same
two kernels.

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
bounded TPU window can overflow on heavy-tailed weights; :func:`expand`
goes on searching in device memory past its window, so both routes are
exact everywhere and the port needs no such switch. :func:`expand` on
the uncompacted ``ends`` is the direct route.

Reference names. The reference module's entry points and the functions
that take their place here (no alias: their arguments differ):

- ``pallas_systematic_resample_tiled`` -> :func:`systematic_resample_tiled`:
  ``(particles, weights, r)`` as in the reference; there is no ``block``
  and no ``interpret`` (the kernels have no window and no interpret
  mode), and any ``n`` and ``nx`` are taken.
- ``resample_tiled_core`` -> :func:`resample_core`: ``(x, ends)`` with
  ``x`` the SoA ``(rows, n)`` float32 payload, where the reference takes
  the ``(T, 1024)`` lane tiles with index and ``ends`` rows, plus ``n``,
  ``block``, ``rows`` and ``compact_tps``; returns ``(x[:, anc], anc)``
  where the reference returns the resampled tiles alone.
- ``pallas_systematic_resample_bank`` -> :func:`systematic_resample_bank`:
  ``(means, covs, weights, r)`` as in the reference, without ``block``
  and ``interpret``.
"""
from __future__ import annotations

import torch

from gpu_se_tpu_torch import trace
from gpu_se_tpu_torch.ops import _build
from gpu_se_tpu_torch.ops.resample_coarse import (
    ends_from_weights,
    indices_from_ends,
)

INT32_MAX = 2**31 - 1


# ----------------------------------------------------------------------
# K1 expand
# ----------------------------------------------------------------------
EXPAND_BLOCK = 1024  # output slots per chunk (one CUDA block each)


def expand_plain(keys, payload, src_idx=None, block: int = EXPAND_BLOCK):
    """Plain version of :func:`expand`: one sorted search of every slot
    in ``keys`` and an index gather (``block`` shapes only the kernel's
    work)."""
    del block
    j = indices_from_ends(keys).clamp_max_(keys.shape[0] - 1)
    out = torch.index_select(payload, 1, j)
    if src_idx is None:
        return out, j
    return out, torch.index_select(src_idx, 0, j)


def expand(keys: torch.Tensor, payload: torch.Tensor,
           src_idx: torch.Tensor | None = None, block: int = EXPAND_BLOCK):
    """Ancestor search and payload gather over ``n = len(keys)`` slots.

    ``keys`` int32 ``(n,)`` non-decreasing (on the filter's paths the
    strictly increasing survivor keys and ``INT32_MAX`` tail that
    :func:`compact` gives); ``payload`` float32 ``(rows, n)``; ``src_idx``
    optional int32 ``(n,)``; ``block >= 1`` output slots per chunk.
    Returns ``out (rows, n)`` with ``out[:, i] = payload[:, j_i]`` and
    ``anc (n,)`` int32, ``src_idx[j_i]`` (or ``j_i``), where ``j_i =
    min(first j with keys[j] >= i, n - 1)``.
    """
    dev = keys.device
    _build.check("keys", keys, torch.int32, 1, dev)
    _build.check("payload", payload, torch.float32, 2, dev)
    n = keys.shape[0]
    if n == 0 or payload.shape[1] != n:
        raise ValueError(f"payload {tuple(payload.shape)} vs keys ({n},)")
    if src_idx is not None:
        _build.check("src_idx", src_idx, torch.int32, 1, dev)
        if src_idx.shape[0] != n:
            raise ValueError(f"src_idx {tuple(src_idx.shape)} vs keys ({n},)")
    if int(block) < 1:
        raise ValueError(f"block {block} must be >= 1")
    if not _build.on_cuda(keys):
        return expand_plain(keys, payload, src_idx, block)
    lib = _build.load_library()
    rows = payload.shape[0]
    out = torch.empty((rows, n), dtype=torch.float32, device=dev)
    anc = torch.empty((n,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.gst_expand(
            keys.data_ptr(), n, payload.data_ptr(), rows,
            None if src_idx is None else src_idx.data_ptr(), n, int(block),
            out.data_ptr(), anc.data_ptr(), _build.stream(dev))
    _build.launch_check("expand", rc)
    expand.launches += 1
    return out, anc


expand.launches = 0


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
    _build.check("ends", ends, torch.int32, 1, dev)
    _build.check("payload", payload, torch.float32, 2, dev)
    n = ends.shape[0]
    if n == 0 or payload.shape[1] != n:
        raise ValueError(f"payload {tuple(payload.shape)} vs ends ({n},)")
    if not _build.on_cuda(ends):
        return compact_plain(ends, payload)
    lib = _build.load_library()
    rows = payload.shape[0]
    # the look-back's ticket and tile words; the kernel's entry zeroes them
    words = torch.empty((lib.gst_compact_words(n),), dtype=torch.int64,
                        device=dev)
    c_keys = torch.empty((n,), dtype=torch.int32, device=dev)
    c_payload = torch.empty((rows, n), dtype=torch.float32, device=dev)
    c_idx = torch.empty((n,), dtype=torch.int32, device=dev)
    count = torch.empty((1,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.gst_compact(
            ends.data_ptr(), payload.data_ptr(), rows, n,
            words.data_ptr(), c_keys.data_ptr(), c_payload.data_ptr(),
            c_idx.data_ptr(), count.data_ptr(), _build.stream(dev))
    _build.launch_check("compact", rc)
    compact.launches += 1
    return c_keys, c_payload, c_idx, count


compact.launches = 0


# ----------------------------------------------------------------------
# entry points
# ----------------------------------------------------------------------
def resample_core(x: torch.Tensor, ends: torch.Tensor):
    """Resample the ``(rows, n)`` payload ``x`` by the monotonized ``ends``:
    :func:`compact`, then :func:`expand` on the survivors.
    Returns ``(x[:, anc], anc)``."""
    c_keys, c_payload, c_idx, _ = compact(ends, x)
    return expand(c_keys, c_payload, c_idx)


def resample_core_plain(x: torch.Tensor, ends: torch.Tensor):
    """:func:`resample_core` through both plain versions."""
    c_keys, c_payload, c_idx, _ = compact_plain(ends, x)
    return expand_plain(c_keys, c_payload, c_idx)


def systematic_resample_tiled(particles: torch.Tensor, weights: torch.Tensor,
                              r):
    """Systematic resample of ``particles (n, nx)`` by ``weights (n,)``
    and the uniform ``r``; returns ``(resampled (n, nx) float32,
    ancestors (n,) int32)``. Any ``n >= 1`` and any ``nx`` (the
    reference's entry takes ``nx <= 5``). The ``ends`` and the gather
    are the recorder's spans ``resample.ends`` and ``resample.gather``."""
    dev = particles.device
    with trace.site_span("resample.ends", dev):
        ends = ends_from_weights(weights, r)
    with trace.site_span("resample.gather", dev):
        out, anc = resample_core(particles.to(torch.float32).T.contiguous(),
                                 ends)
    return out.T, anc


# ----------------------------------------------------------------------
# the router's gates, and the Gaussian-bank entry
# ----------------------------------------------------------------------
IDX_ROW = 5          # the reference's tile rows 0..4 carry the payload
V4_BLOCK = 4096


def _pad_n(n: int, block: int) -> int:
    return -(-n // block) * block


def v4_applicable(first_leaf, n: int, block: int = V4_BLOCK) -> bool:
    """The reference's shape gate for its tiled kernel: an ``(n, <=5)``
    payload and ``2^12 <= n`` with ``n`` padded to a block multiple at
    most ``2^24`` (its tile rows hold indices as exact float32). The
    port's kernels have neither limit; the gate is kept so that the same
    shapes take the same routes."""
    return (
        first_leaf.dim() == 2
        and first_leaf.shape[1] <= IDX_ROW
        and n >= 2**12
        and _pad_n(n, block) <= 2**24
    )


def bank_rows(nx: int) -> int:
    """The reference's tile height for the (means, covariances) bank:
    ``nx`` means + ``nx(nx+1)/2`` upper-triangle covariance entries + 3
    scratch rows, rounded up to 8."""
    cols = nx + nx * (nx + 1) // 2
    return ((cols + 3 + 7) // 8) * 8


def bank_applicable(means, covs, n: int, block: int = V4_BLOCK) -> bool:
    """Gate of :func:`systematic_resample_bank`: ``(n, nx)`` and
    ``(n, nx, nx)`` float32, ``bank_rows(nx) <= 32`` and the size limits
    of :func:`v4_applicable`."""
    if means.dim() != 2 or covs.dim() != 3:
        return False
    nx = means.shape[1]
    return (
        tuple(covs.shape[1:]) == (nx, nx)
        and means.dtype == torch.float32 and covs.dtype == torch.float32
        and bank_rows(nx) <= 32
        and n >= 2**12 and _pad_n(n, block) <= 2**24
    )


def systematic_resample_bank(means: torch.Tensor, covs: torch.Tensor,
                             weights: torch.Tensor, r):
    """Systematic resample of a Gaussian bank through :func:`compact` and
    :func:`expand` on one ``(nx + nx(nx+1)/2, n)`` payload: the
    means and the upper triangle of each covariance, mirrored back after.

    ``covs`` must be exactly symmetric; then the result is bit-equal to
    the plain resample of ``(means, covs)``. Returns ``(new_means,
    new_covs, ancestors)``.
    """
    n, nx = means.shape
    if not bank_applicable(means, covs, n):
        raise ValueError(f"bank of means {tuple(means.shape)} {means.dtype},"
                         f" covs {tuple(covs.shape)} {covs.dtype}")
    ti, tj = torch.triu_indices(nx, nx, device=means.device)
    payload = torch.cat([means.T, covs[:, ti, tj].T]).contiguous()
    out, anc = resample_core(payload, ends_from_weights(weights, r))
    # entry (i, j) of a covariance is triangle column k of (min, max)
    k_of = torch.empty((nx, nx), dtype=torch.int64, device=means.device)
    k_of[ti, tj] = torch.arange(ti.shape[0], device=means.device)
    k_of[tj, ti] = k_of[ti, tj]
    new_covs = out[nx:][k_of.reshape(-1)].T.reshape(n, nx, nx)
    return out[:nx].T, new_covs, anc
