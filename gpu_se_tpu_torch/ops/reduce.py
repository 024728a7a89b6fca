"""Accumulation-safe reductions over the particle axis.

Counterpart of ``gpu_se_tpu/ops/reduce.py``: a float32 sum over many
terms sums in two levels, over blocks and then over the block sums, so
its error grows like ``(B + N/B) eps`` instead of ``N eps``. The block is
``block`` entries, halved until it divides ``N``; at 1 the sum is flat.
"""
from __future__ import annotations

import torch


def _block(n: int, block: int) -> int:
    b = min(block, n)
    while n % b:
        b //= 2
    return b


def blocked_sum(x: torch.Tensor, block: int = 4096) -> torch.Tensor:
    """Sum over axis 0 in two levels; the other axes are kept."""
    n = x.shape[0]
    b = _block(n, block)
    if b <= 1:
        return torch.sum(x, dim=0)
    xr = x.reshape((n // b, b) + tuple(x.shape[1:]))
    return torch.sum(torch.sum(xr, dim=1), dim=0)


def weighted_mean(weights: torch.Tensor, x: torch.Tensor,
                  block: int = 4096) -> torch.Tensor:
    """``sum_i w_i x_i / sum_i w_i`` over axis 0, both sums blocked."""
    total = blocked_sum(weights, block)
    w = (weights / total).reshape((-1,) + (1,) * (x.dim() - 1))
    return blocked_sum(w * x, block)


def blocked_outer_sum(a: torch.Tensor, b: torch.Tensor,
                      block: int = 4096) -> torch.Tensor:
    """``sum_i outer(a_i, b_i)`` over axis 0 without materializing
    ``(N, d1, d2)``: per-block ``(blk, d1)^T (blk, d2)`` products, then a
    sum over the blocks. The products are float32 matrix products: on a
    CUDA card keep ``torch.backends.cuda.matmul.allow_tf32`` off."""
    n = a.shape[0]
    blk = _block(n, block)
    if blk <= 1:
        return a.T @ b
    ar = a.reshape(n // blk, blk, a.shape[1])
    br = b.reshape(n // blk, blk, b.shape[1])
    return torch.sum(torch.einsum("kbi,kbj->kij", ar, br), dim=0)
