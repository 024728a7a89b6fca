"""Batched small-matrix ops (n <= ~8) as unrolled elementwise ops.

Counterpart of ``gpu_se_tpu/ops/smallmat.py``, function for function and
op for op: the factorizations and inverses are unrolled over the static
small dimension in the reference's order (``inv_d = 1 / d``, then a
multiply), so float32 results agree with the reference's to the ulp.
Plain PyTorch; no kernel (the reference file has none). The GSUKF's
hot path uses the lanes-last forms, matrix dims leading and the big
batch axis last.
"""
from __future__ import annotations

import torch


def bmm_small(a, b):
    """Batched tiny matmul ``(n, i, k) @ (n, k, j) -> (n, i, j)`` as a
    broadcast-multiply-reduce."""
    return torch.sum(a[:, :, :, None] * b[:, None, :, :], dim=2)


def weighted_outer_sum(a, w, b):
    """``einsum('nsx,s,nsy->nxy', a, w, b)`` as a broadcast-multiply-
    reduce."""
    return torch.sum(
        a[:, :, :, None] * (w[None, :, None, None] * b[:, :, None, :]),
        dim=1)


def weighted_sigma_mean(w, sigmas):
    """``einsum('s,nsx->nx', w, sigmas)`` as a broadcast-multiply-reduce."""
    return torch.sum(w[None, :, None] * sigmas, dim=1)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root. torch's CPU ``sqrt`` of float32 is
    not (an ulp off for ~0.7% of inputs); its CUDA one and the
    reference's are. Taken in float64 and rounded to float32 it is, since
    a double carries more than twice a float's digits."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def cholesky_small(covs: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky of a batch of small SPD matrices ``(..., n, n)``.

    Unrolled Cholesky-Crout; NaN entries for non-PD inputs (the contract
    of the reference's ``jnp.linalg.cholesky``; ``torch.linalg.cholesky``
    raises instead).
    """
    n = covs.shape[-1]
    cols = [[None] * n for _ in range(n)]  # cols[i][j] = L[..., i, j]
    for j in range(n):
        s = covs[..., j, j]
        for k in range(j):
            s = s - cols[j][k] * cols[j][k]
        d = _sqrt(s)
        cols[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s2 = covs[..., i, j]
            for k in range(j):
                s2 = s2 - cols[i][k] * cols[j][k]
            cols[i][j] = s2 * inv_d
    zero = torch.zeros_like(covs[..., 0, 0])
    rows = [
        torch.stack([cols[i][j] if j <= i else zero for j in range(n)],
                    dim=-1)
        for i in range(n)
    ]
    return torch.stack(rows, dim=-2)


def inv_small_jittered(mats: torch.Tensor,
                       rel_jitter: float = 1e-6) -> torch.Tensor:
    """Branchless degenerate-safe batched small inverse.

    Where :func:`inv_small` gives a non-finite entry, redo with
    ``rel_jitter * |trace| / n + tiny`` on the diagonal; a matrix that
    still inverts to non-finite values (zero trace) gets a zero inverse
    (pinv-of-0 semantics).
    """
    n = mats.shape[-1]
    inv0 = inv_small(mats)
    bad = ~torch.isfinite(inv0).all(dim=-1, keepdim=True).all(
        dim=-2, keepdim=True)
    trace = sum(mats[..., i, i] for i in range(n))[..., None, None]
    scale = rel_jitter * torch.abs(trace) / n + torch.finfo(mats.dtype).tiny
    eye = torch.eye(n, dtype=mats.dtype, device=mats.device)
    inv1 = inv_small(mats + scale * eye)
    inv1 = torch.where(torch.isfinite(inv1), inv1, torch.zeros_like(inv1))
    return torch.where(bad, inv1, inv0)


def inv_small(mats: torch.Tensor) -> torch.Tensor:
    """Inverse of a batch of small matrices ``(..., n, n)``, unrolled for
    n in {1, 2, 3}; ``torch.linalg.inv`` for larger n."""
    n = mats.shape[-1]
    if n == 1:
        return 1.0 / mats
    if n == 2:
        a, b = mats[..., 0, 0], mats[..., 0, 1]
        c, d = mats[..., 1, 0], mats[..., 1, 1]
        det = a * d - b * c
        inv_det = 1.0 / det
        row0 = torch.stack([d * inv_det, -b * inv_det], dim=-1)
        row1 = torch.stack([-c * inv_det, a * inv_det], dim=-1)
        return torch.stack([row0, row1], dim=-2)
    if n == 3:
        m = mats
        c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
        c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
        c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
        c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
        c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
        c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
        c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
        c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
        c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
        det = m[..., 0, 0] * c00 + m[..., 0, 1] * c01 + m[..., 0, 2] * c02
        inv_det = 1.0 / det
        rows = [
            torch.stack([c00, c10, c20], dim=-1),
            torch.stack([c01, c11, c21], dim=-1),
            torch.stack([c02, c12, c22], dim=-1),
        ]
        return torch.stack(rows, dim=-2) * inv_det[..., None, None]
    return torch.linalg.inv(mats)


# ----------------------------------------------------------------------
# Lanes-last variants: matrix dims LEADING, batch dims TRAILING, so every
# elementwise op runs over the whole contiguous batch.
# ----------------------------------------------------------------------
def cholesky_small_lanes(covs: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky of ``(n, n, ...)`` SPD matrices (matrix dims
    leading): :func:`cholesky_small`'s op order and NaN contract."""
    n = covs.shape[0]
    cols = [[None] * n for _ in range(n)]
    for j in range(n):
        s = covs[j, j]
        for k in range(j):
            s = s - cols[j][k] * cols[j][k]
        d = _sqrt(s)
        cols[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s2 = covs[i, j]
            for k in range(j):
                s2 = s2 - cols[i][k] * cols[j][k]
            cols[i][j] = s2 * inv_d
    zero = torch.zeros_like(covs[0, 0])
    return torch.stack([
        torch.stack([cols[i][j] if j <= i else zero for j in range(n)])
        for i in range(n)
    ])


def inv_small_lanes(mats: torch.Tensor) -> torch.Tensor:
    """Inverse of ``(n, n, ...)`` matrices (matrix dims leading): n in
    {1, 2} unrolled in place, larger n through :func:`inv_small` (matrix
    dims trailing)."""
    n = mats.shape[0]
    if n == 1:
        return 1.0 / mats
    if n == 2:
        a, b = mats[0, 0], mats[0, 1]
        c, d = mats[1, 0], mats[1, 1]
        det = a * d - b * c
        inv_det = 1.0 / det
        return torch.stack([
            torch.stack([d * inv_det, -b * inv_det]),
            torch.stack([-c * inv_det, a * inv_det]),
        ])
    batched = torch.movedim(torch.movedim(mats, 0, -1), 0, -1)
    out = inv_small(batched)
    return torch.movedim(torch.movedim(out, -1, 0), -1, 0)


def inv_small_jittered_lanes(mats: torch.Tensor,
                             rel_jitter: float = 1e-6) -> torch.Tensor:
    """Lanes-layout mirror of :func:`inv_small_jittered`."""
    n = mats.shape[0]
    inv0 = inv_small_lanes(mats)
    bad = ~torch.isfinite(inv0).all(dim=0, keepdim=True).all(
        dim=1, keepdim=True)
    trace = sum(mats[i, i] for i in range(n))[None, None]
    scale = rel_jitter * torch.abs(trace) / n + torch.finfo(mats.dtype).tiny
    eye = torch.eye(n, dtype=mats.dtype, device=mats.device).reshape(
        (n, n) + (1,) * (mats.dim() - 2))
    inv1 = inv_small_lanes(mats + scale * eye)
    inv1 = torch.where(torch.isfinite(inv1), inv1, torch.zeros_like(inv1))
    return torch.where(bad, inv1, inv0)
