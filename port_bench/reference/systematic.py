"""Systematic resampling, judged from the outside.

The program draws its uniform ``r`` from its own stream, so the
reference reads the ancestors off the program's output rows (each must
be, bit for bit, a row of the input), finds the ``r`` that fits them
best against its own float64 weights, and compares the copies the
program made of each input row with the copies systematic resampling at
that ``r`` makes: slot ``i`` copies row ``idx_i``, the least ``k`` with
``cs_k >= (i + r) / n``, ``cs`` the normalized cumulative sum.
"""
from __future__ import annotations

import torch

_MULT = (0x9E3779B97F4A7C15 - 2 ** 64, 0x7F4A7C159E3779B9,
         0x94D049BB133111EB - 2 ** 64, 0x2545F4914F6CDD1D,
         0x5851F42D4C957F2D)


def row_keys(rows: torch.Tensor) -> torch.Tensor:
    """A 64-bit key of each float32 row's bits (wrapping products)."""
    bits = rows.contiguous().view(torch.int32).to(torch.int64)
    key = torch.zeros(rows.shape[0], dtype=torch.int64, device=rows.device)
    for j in range(bits.shape[1]):
        key = key * 1000003 + bits[:, j] * _MULT[j % len(_MULT)]
    return key


def ancestors(before: torch.Tensor, after: torch.Tensor):
    """``(anc, missing)``: for each row of ``after`` the index of the row
    of ``before`` equal to it bit for bit, and the number of rows of
    ``after`` equal to none (their ancestor reads -1). Rows of ``before``
    must be distinct for the answer to be unique."""
    kb, ka = row_keys(before), row_keys(after)
    order = torch.argsort(kb)
    sorted_keys = kb[order]
    pos = torch.searchsorted(sorted_keys, ka).clamp_max(kb.shape[0] - 1)
    anc = order[pos]
    same = (sorted_keys[pos] == ka) & (before[anc] == after).all(dim=1)
    anc = torch.where(same, anc, torch.full_like(anc, -1))
    return anc, int((~same).sum())


def offspring_gap(weights: torch.Tensor, anc: torch.Tensor) -> float:
    """The largest gap, over the input rows, between the copies the
    program made of a row (``anc``) and those systematic resampling of
    ``weights`` (float64) makes at the ``r`` that fits ``anc`` best. A
    boundary of the cumulative sum that moves by less than a slot moves
    a count by one at most."""
    n = weights.shape[0]
    w = weights.to(torch.float64)
    cs = torch.cumsum(w, 0)
    cs = cs / cs[-1]
    cs_lo = torch.cat([cs.new_zeros(1), cs[:-1]])
    i = torch.arange(n, dtype=torch.float64, device=w.device)
    valid = anc >= 0
    if not bool(valid.any()):
        return float(n)
    a = anc[valid]
    # r lies in (n cs_{a-1} - i, n cs_a - i] for every slot
    r = float(0.5 * ((n * cs_lo[a] - i[valid]).max()
                     + (n * cs[a] - i[valid]).min()))
    r = min(max(r, 0.0), 1.0 - 1e-12)
    ref = torch.searchsorted(cs, (i + r) / n).clamp_max(n - 1)
    got = torch.bincount(a, minlength=n)
    want = torch.bincount(ref, minlength=n)
    return float((got - want).abs().max()) + float((~valid).sum())
