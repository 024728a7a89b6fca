"""The port's resample against the JAX reference, and its kernels against
their plain versions.

``ends`` is the one input whose float32 rounding differs between the
libraries (their cumsums round differently), so the resample
comparisons feed both sides the reference's ``ends``; given those, the
ancestors and rows must be bit-equal. Weights come in two families:
near-uniform (the reference's direct kernel route) and heavy-tailed like
the bench rig's (its compacted route), at n = 2^12, an odd n and 8192.

The kernels themselves are held to these plain versions on the card by
``tests/test_torch_kernels.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_se_tpu.filters.resampling import sorted_row_gather as j_gather
from gpu_se_tpu.ops import resample_pallas4 as jrp4
from gpu_se_tpu.ops.resample_coarse import ends_from_weights as j_ends
from gpu_se_tpu.ops.resample_coarse import indices_from_ends as j_indices
from gpu_se_tpu_torch.filters import resampling as trs
from gpu_se_tpu_torch.ops import resample_pallas4 as trp4
from gpu_se_tpu_torch.ops.resample_coarse import blocked_cummax, blocked_cumsum
from gpu_se_tpu_torch.ops.resample_coarse import ends_from_weights as t_ends
from gpu_se_tpu_torch.ops.resample_coarse import indices_from_ends as t_indices

SIZES = [4096, 5000, 8192]
FAMILIES = ["near_uniform", "heavy"]


def _case(n, family, nx=5, seed=0):
    rng = np.random.default_rng([n, FAMILIES.index(family), seed])
    parts = rng.standard_normal((nx, n)).astype(np.float32)
    if family == "near_uniform":
        w = 1.0 + 0.1 * rng.random(n)
    else:   # lognormal with sigma 4: ~1-10% of particles survive
        w = np.exp(4.0 * rng.standard_normal(n))
    r = np.float32(rng.random())
    return parts, w.astype(np.float32), r


def _jax_ends(w, r):
    return np.array(j_ends(jnp.asarray(w), jnp.asarray(r)))


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("n", [4096, 8192])
def test_ends_from_weights_vs_jax(n, family):
    """Entries differ only at cumsum ties: by at most 1, and rarely
    (4 of 8192 seen for uniform weights; the bound is 4 per 1000)."""
    _, w, r = _case(n, family)
    want = _jax_ends(w, r)
    got = t_ends(torch.from_numpy(w), torch.tensor(r)).numpy()
    assert got.dtype == np.int32
    diff = got.astype(np.int64) - want
    assert np.abs(diff).max() <= 1
    assert np.count_nonzero(diff) <= 4 * n // 1000
    assert np.all(np.diff(got) >= 0) and got[-1] == n - 1


@pytest.mark.parametrize("n", [1, 1000, 1024, 5000, 8192])
def test_blocked_cumsum_vs_float64(n):
    """Float32 sums of positive terms: within 1e-6 relative of the
    float64 cumsum at these sizes, across the 1024-entry row joins."""
    w = np.random.default_rng(n).random(n).astype(np.float32)
    got = blocked_cumsum(torch.from_numpy(w)).numpy()
    assert got.dtype == np.float32 and got.shape == (n,)
    np.testing.assert_allclose(got, np.cumsum(w.astype(np.float64)),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("n", [1, 1000, 1024, 5000, 8192])
def test_blocked_cummax_exact(n):
    e = np.random.default_rng(n).integers(-1, n, n).astype(np.int32)
    got = blocked_cummax(torch.from_numpy(e)).numpy()
    np.testing.assert_array_equal(got, np.maximum.accumulate(e))


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("n", SIZES)
def test_compact_plain_vs_flatnonzero(n, family):
    parts, w, r = _case(n, family)
    ends = _jax_ends(w, r)
    c_keys, c_payload, c_idx, count = trp4.compact(
        torch.from_numpy(ends), torch.from_numpy(parts))
    kept = np.flatnonzero(ends > np.concatenate([[-1], ends[:-1]]))
    m = len(kept)
    assert count.tolist() == [m]
    np.testing.assert_array_equal(c_keys.numpy()[:m], ends[kept])
    np.testing.assert_array_equal(c_idx.numpy()[:m], kept)
    np.testing.assert_array_equal(c_payload.numpy()[:, :m], parts[:, kept])
    assert np.all(c_keys.numpy()[m:] == trp4.INT32_MAX)
    assert np.all(c_idx.numpy()[m:] == -1)
    assert np.all(c_payload.numpy()[:, m:] == 0.0)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("n", SIZES)
def test_both_routes_bit_equal_to_jax(n, family):
    """Compacted route (``resample_core``) and direct route
    (``search_gather`` on ``ends``) against the reference's
    ``indices_from_ends`` + ``sorted_row_gather``, given its ``ends``."""
    parts, w, r = _case(n, family)
    ends = _jax_ends(w, r)
    idx = np.asarray(j_indices(jnp.asarray(ends)))
    rows = np.asarray(j_gather(jnp.asarray(parts.T), jnp.asarray(idx))).T
    x, e = torch.from_numpy(parts), torch.from_numpy(ends)
    for out, anc in (trp4.resample_core(x, e), trp4.search_gather(e, x)):
        np.testing.assert_array_equal(anc.numpy(), idx)
        np.testing.assert_array_equal(out.numpy(), rows)
    np.testing.assert_array_equal(t_indices(e).numpy(), idx)


@pytest.mark.parametrize("n, family", [(4096, "near_uniform"),
                                       (5000, "heavy")])
def test_bit_equal_to_pallas_tiled_entry(n, family):
    """Against the reference's v4 kernel entry in interpret mode: the
    direct route at 2^12 and the compacted route at an odd n."""
    parts, w, r = _case(n, family)
    ends = _jax_ends(w, r)
    want_rows, want_anc = jrp4.pallas_systematic_resample_tiled(
        jnp.asarray(parts.T), jnp.asarray(w), jnp.asarray(r), interpret=True)
    out, anc = trp4.resample_core(torch.from_numpy(parts),
                                  torch.from_numpy(ends))
    np.testing.assert_array_equal(anc.numpy(), np.asarray(want_anc))
    np.testing.assert_array_equal(out.numpy().T, np.asarray(want_rows))


@pytest.mark.parametrize("family", FAMILIES)
def test_systematic_resample_tiled_entry(family):
    """The entry computes its own ``ends``: it equals the plain oracle
    ``systematic_resample_indices`` + ``sorted_row_gather``."""
    parts, w, r = _case(5000, family)
    p, wt, rt = torch.from_numpy(parts.T.copy()), torch.from_numpy(w), \
        torch.tensor(r)
    rows, anc = trp4.systematic_resample_tiled(p, wt, rt)
    idx = trs.systematic_resample_indices(wt, rt)
    torch.testing.assert_close(anc, idx, rtol=0, atol=0)
    torch.testing.assert_close(rows, trs.sorted_row_gather(p, idx),
                               rtol=0, atol=0)
    pos = trs.systematic_positions(5000, rt)
    cs = torch.cumsum(wt, 0) / torch.cumsum(wt, 0)[-1]
    # ancestors invert the stratified positions, up to cumsum ties
    seen = torch.searchsorted(cs, pos).clamp_max(4999).to(torch.int32)
    assert (seen != anc).sum() <= 4


def test_wrappers_reject_bad_inputs():
    e = torch.arange(16, dtype=torch.int32)
    x = torch.zeros((3, 16))
    with pytest.raises(TypeError):
        trp4.search_gather(e.to(torch.int64), x)
    with pytest.raises(ValueError):
        trp4.compact(e, torch.zeros((3, 15)))
    with pytest.raises(ValueError):
        trp4.search_gather(e, torch.zeros((16, 3)).T)
