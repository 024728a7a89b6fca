"""The resample's float32 ``ends`` above 2^23, at the particle count of
the top of the thesis's PF open-loop grid, ``int(2 ** 23.5)`` =
11,863,283 particles.

``ends_from_weights`` computes ``floor(n * cs - r)`` in float32, as the
reference does. Where ``n * cs >= 2^23`` a float32's ulp is 1: the product
is a whole number and ``n * cs - r`` rounds back to it (``r < 0.5``) or to
one less (``r > 0.5``), so the comb's fraction, and with it ``r``, is lost
for the top ~29% of the slots. Below 2^23 only the float32 cumulative sum
parts from float64 (a few ulps of ``cs``, under one slot each). The
departure is the reference's contract; these tests pin how far it goes
against float64 systematic resampling of the same weights at the same
``r``, in ``ends`` and in the copies each particle gets (the benchmark's
``offspring_gap`` reads the latter). ``blocked_cumsum`` gives the same
bits on the CPU and on a card, so the card's ``ends`` are these.
"""
import pytest
import torch

from gpu_se_tpu_torch.ops.resample_coarse import ends_from_weights

N = int(2 ** 23.5)


@pytest.fixture(scope="module")
def weights():
    g = torch.Generator().manual_seed(23)
    return torch.exp(torch.randn(N, generator=g, dtype=torch.float32))


def _float64_ends(weights, r):
    cs = torch.cumsum(weights.double(), 0)
    x = N * (cs / cs[-1]) - r
    ends = torch.cummax(torch.floor(x).clamp(-1, N - 1).long(), 0).values
    return torch.where(ends == ends[-1], N - 1, ends), x >= 2 ** 23


def _copies(ends):
    return torch.diff(ends, prepend=ends.new_full((1,), -1))


# r: (largest ends gap below 2^23, above, largest gap in a particle's
# copies below, above)
PINNED = {0.25: (2, 2, 2, 3), 0.75: (2, 3, 2, 3)}


@pytest.mark.parametrize("r", sorted(PINNED))
def test_float32_ends_against_float64_at_the_grids_top(weights, r):
    assert N == 11_863_283 and N % 256 == 243
    got = ends_from_weights(weights, torch.tensor(r)).long()
    want, high = _float64_ends(weights, r)
    assert 0.29 < float(high.double().mean()) < 0.30
    gap = (got - want).abs()
    copies = (_copies(got) - _copies(want)).abs()
    assert (int(gap[~high].max()), int(gap[high].max()),
            int(copies[~high].max()), int(copies[high].max())) == PINNED[r]
    # above 2^23 the lost fraction moves an end at least twice as often
    moved = [float((got[m] != want[m]).double().mean())
             for m in (~high, high)]
    assert moved[1] > 2 * moved[0]
    # ends stay a valid systematic comb: non-decreasing, ending at N - 1
    assert bool((got[1:] >= got[:-1]).all()) and int(got[-1]) == N - 1
