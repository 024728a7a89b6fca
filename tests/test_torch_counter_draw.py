"""The counter-based draw (``gpu_se_tpu_torch/ops/counter_draw.py``) and
the ``GaussianSum`` methods over it, on the CPU.

- ``counter_draw_plain``'s words equal a pure-Python Philox4x32-10 written
  here from the published constants (Salmon et al., SC 2011), and the
  published known-answer vectors of Random123;
- its floats equal the transform of those words in float64 rounded to
  float32 within ``FLOAT_ATOL`` (the CPU's float32 ``log``, ``sqrt``,
  ``sin`` and ``cos`` against float64 ones);
- any split of ``[0, n)`` into slices concatenates to the whole draw
  bit for bit (hypothesis), in both layouts;
- ``draw_inputs_at`` on the rig's two-component state mixture and on a
  three-component mixture at 2^15 samples: the sample mean within 4
  standard errors of the mixture's mean, the covariance within 10% of
  the mixture's (relative to its diagonal), the component frequencies
  within 4 sigma of the weights; ``draw_inputs_at_t`` gives the same
  samples lanes-last.

On the card, ``tests/test_torch_kernels.py`` holds the kernel to the
plain version (the ``gpu`` marker).
"""
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gpu_se_tpu_torch import rig
from gpu_se_tpu_torch.distributions import GaussianSum
from gpu_se_tpu_torch.ops import counter_draw as cd

M0, M1, W0, W1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85
MASK = 0xFFFFFFFF
# Random123's known-answer vectors of philox4x32-10: (counter, key, out)
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((MASK,) * 4, (MASK, MASK),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]
# float32 transcendental functions on the CPU against float64 ones
FLOAT_ATOL = 4e-6
N_STAT = 2**15
KEY = (0x1234ABCD, 0x0F0E0D0C)


def oracle_philox(ctr, key):
    """Philox4x32-10 in Python ints."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for rnd in range(10):
        if rnd:
            k0, k1 = (k0 + W0) & MASK, (k1 + W1) & MASK
        p0, p1 = M0 * c0, M1 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & MASK,
                          (p0 >> 32) ^ c3 ^ k1, p0 & MASK)
    return c0, c1, c2, c3


def oracle_words(key, j, nx):
    out = []
    for b in range(cd.blocks_of(nx)):
        out.extend(oracle_philox((j & MASK, j >> 32, b, 0), key))
    return out


def _key(key=KEY):
    return torch.tensor(key, dtype=torch.int64)


@pytest.mark.parametrize("case", range(len(KAT)))
def test_philox_known_answers(case):
    ctr, key, want = KAT[case]
    assert oracle_philox(ctr, key) == want
    got = cd.philox_plain(tuple(torch.tensor([c]) for c in ctr),
                          *(torch.tensor(k) for k in key))
    assert tuple(int(g[0]) for g in got) == want


@pytest.mark.parametrize("start,count,nx", [
    (0, 64, 5), (12345, 37, 1), (2**32 - 20, 40, 3), (7 * 2**33 + 5, 9, 8)])
def test_plain_words_match_python_oracle(start, count, nx):
    key = (0xDEADBEEF, 0x01234567)
    _, _, words = cd.counter_draw_plain(_key(key), start, count, nx,
                                        words=True)
    assert words.shape == (count, 4 * cd.blocks_of(nx))
    want = [oracle_words(key, start + i, nx) for i in range(count)]
    np.testing.assert_array_equal(words.numpy(), np.array(want, np.int64))


def test_floats_are_the_words_transform():
    nx = 5
    eps, u, words = cd.counter_draw_plain(_key(), 1000, 4096, nx, words=True)
    w = words.numpy().astype(np.float64)
    np.testing.assert_array_equal(u.numpy(), np.floor(w[:, 0] / 256) / 2**24)
    for q in range(0, nx, 2):
        u1 = (np.floor(w[:, 1 + q] / 256) + 1) / 2**24
        u2 = np.floor(w[:, 2 + q] / 256) / 2**24
        radius = np.sqrt(-2 * np.log(u1))
        angle = np.float64(np.float32(cd.TWO_PI)) * u2
        np.testing.assert_allclose(eps[:, q].numpy(), radius * np.cos(angle),
                                   rtol=0, atol=FLOAT_ATOL)
        if q + 1 < nx:
            np.testing.assert_allclose(eps[:, q + 1].numpy(),
                                       radius * np.sin(angle), rtol=0,
                                       atol=FLOAT_ATOL)
    assert (u.numpy() >= 0).all() and (u.numpy() < 1).all()


@settings(max_examples=30, deadline=None)
@given(n=st.integers(1, 3000), cuts=st.lists(st.integers(0, 3000),
                                             max_size=6),
       nx=st.integers(1, 7), lanes_last=st.booleans())
def test_slices_concatenate_to_the_whole_draw(n, cuts, nx, lanes_last):
    bounds = sorted({0, n, *(c % (n + 1) for c in cuts)})
    whole_eps, whole_u = cd.counter_draw(_key(), 0, n, nx, lanes_last)
    parts = [cd.counter_draw(_key(), a, b - a, nx, lanes_last)
             for a, b in zip(bounds[:-1], bounds[1:])]
    dim = 1 if lanes_last else 0
    assert torch.equal(torch.cat([p[0] for p in parts], dim=dim), whole_eps)
    assert torch.equal(torch.cat([p[1] for p in parts]), whole_u)


def test_cpu_wrapper_launches_nothing_and_checks_its_inputs():
    before = cd.counter_draw.launches
    eps, u = cd.counter_draw(_key(), 3, 10, 5, lanes_last=True)
    assert eps.shape == (5, 10) and u.shape == (10,)
    assert cd.counter_draw.launches == before
    with pytest.raises(TypeError):
        cd.counter_draw(_key().to(torch.int32), 0, 4, 5)
    with pytest.raises(ValueError):
        cd.counter_draw(torch.zeros(3, dtype=torch.int64), 0, 4, 5)
    with pytest.raises(ValueError):
        cd.counter_draw(_key(), -1, 4, 5)


def test_key_from_advances_the_generator_alike():
    a, b = (torch.Generator().manual_seed(9) for _ in range(2))
    ka, kb = cd.key_from(a, "cpu"), cd.key_from(b, "cpu")
    assert torch.equal(ka, kb) and ka.dtype == torch.int64
    assert ((ka >= 0) & (ka < 2**32)).all()
    assert torch.rand((), generator=a) == torch.rand((), generator=b)


def _three_components():
    means = np.array([[1.0, -2.0, 0.5], [-1.0, 0.0, 2.0], [3.0, 1.0, -1.0]])
    covs = np.stack([np.diag([0.5, 1.0, 0.2]),
                     np.array([[1.0, 0.3, 0.0], [0.3, 0.8, 0.1],
                               [0.0, 0.1, 0.4]]),
                     np.diag([0.1, 0.3, 2.0])])
    return GaussianSum.create(means, covs, np.array([0.5, 0.3, 0.2]),
                              device="cpu")


def _mixtures():
    _, state_pdf, _ = rig.bench_rig()
    return {"rig_state_pdf": GaussianSum.create(*state_pdf, device="cpu"),
            "three_components": _three_components()}


@pytest.mark.parametrize("name", ["rig_state_pdf", "three_components"])
def test_draw_inputs_at_distribution(name):
    dist = _mixtures()[name]
    eps, comp = dist.draw_inputs_at(_key(), 0, N_STAT)
    x = dist.draw_from(eps, comp).double().numpy()
    w = dist.weights.double().numpy()
    w = w / w.sum()
    freq = np.bincount(comp.numpy(), minlength=len(w)) / N_STAT
    sigma = np.sqrt(w * (1 - w) / N_STAT)
    assert (np.abs(freq - w) <= 4 * sigma).all(), (freq, w)
    mean = dist.mean().double().numpy()
    cov = dist.covariance().double().numpy()
    se = np.sqrt(np.diag(cov) / N_STAT)
    assert (np.abs(x.mean(0) - mean) <= 4 * se).all()
    scale = np.sqrt(np.outer(np.diag(cov), np.diag(cov)))
    assert (np.abs(np.cov(x.T) - cov) <= 0.1 * scale).all()
    assert (eps.abs() < 5.8).all()


@pytest.mark.parametrize("name", ["rig_state_pdf", "three_components"])
def test_draw_inputs_at_t_is_the_same_draw_lanes_last(name):
    dist = _mixtures()[name]
    rows = dist.draw_from(*dist.draw_inputs_at(_key(), 77, 1000))
    lanes = dist.draw_t_from(*dist.draw_inputs_at_t(_key(), 77, 1000))
    assert lanes.shape == (dist.n_dim, 1000)
    # the row path selects by a one-hot product, the lanes path by a
    # where (two components) or a one-hot sum: the same sample to float32
    # rounding of the affine map
    np.testing.assert_allclose(lanes.T.numpy(), rows.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert math.isclose(float(lanes.mean()), float(rows.mean()),
                        rel_tol=1e-5, abs_tol=1e-6)


@pytest.mark.parametrize("nx,want", [(1, 1), (2, 2), (3, 3), (4, 4), (5, 5),
                                     (6, 0), (7, 0), (30, 0)])
def test_kernel_nx_dispatch(nx, want):
    """``nx`` up to ``MAX_FIXED_NX`` takes its own compile-time kernel,
    any other the run-time-nx one; the main paths' nx has its own."""
    assert cd.kernel_nx(nx) == want
    assert cd.kernel_nx(rig.NX) == rig.NX


def test_counter_words_hook_on_cpu():
    """The verification hook gives the plain words on the CPU, with the
    draw's checks, and launches nothing."""
    before = cd.counter_draw.launches
    w = cd.counter_words(_key(), 2**32 - 3, 7, 5)
    assert torch.equal(w, cd.words_plain(_key(), 2**32 - 3, 7, 5))
    _, _, w2 = cd.counter_draw_plain(_key(), 2**32 - 3, 7, 5, words=True)
    assert torch.equal(w2, w)
    assert cd.counter_draw.launches == before
    for bad in ((_key().to(torch.int32), 0, 4, 5),
                (torch.zeros(3, dtype=torch.int64), 0, 4, 5),
                (_key(), -1, 4, 5), (_key(), 0, -1, 5), (_key(), 0, 4, 0),
                (_key(), 2**63 - 2, 4, 5), (_key(), 0, 2**31, 5)):
        with pytest.raises((TypeError, ValueError)):
            cd.counter_words(*bad)


def test_study_reads_ptxas_and_cuobjdump():
    """The study's readers on lines in the form ``nvcc -Xptxas -v`` and
    ``cuobjdump -sass`` print them: the issue floor leaves out the
    stores and what a forward conditional branch skips."""
    from gpu_se_tpu_torch.results import counter_draw_study as cs

    name = "_ZN12_GLOBAL__N_110draw_fixedILi5ELb0EEEvPKxxiPfS3_"
    ptxas = (f"ptxas info    : Compiling entry function '{name}' for "
             f"'sm_90a'\nptxas info    : Function properties for {name}\n"
             "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
             "loads\nptxas info    : Used 72 registers, used 1 barriers, "
             "10240 bytes smem, 400 bytes cmem[0]\n")
    assert cs.ptxas_info(ptxas) == {"draw_fixed<5, rows>": {
        "stack_bytes": 0, "spill_store_bytes": 0, "spill_load_bytes": 0,
        "registers": 72, "smem_bytes": 10240}}
    sass = "\n".join([
        f"\t\tFunction : {name}",
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;",
        "        /*0010*/              @!P0 BRA 0x40 ;",
        "        /*0020*/                   CALL.REL.NOINC 0x80 ;",
        "        /*0030*/                   BRA 0x50 ;",
        "        /*0040*/                   IMAD.WIDE.U32 R2, R3, R4, RZ ;",
        "        /*0050*/                   STG.E.128 desc[UR6][R2.64], R4 ;",
        "        /*0060*/                   EXIT ;",
        "        /*0070*/                   NOP;",
        "\t\tFunction : _ZN12_GLOBAL__N_110draw_wordsEPKxxiiPj",
        "        /*0000*/                   EXIT ;"])
    got = cs.sass_counts(sass)
    assert got["draw_fixed<5, rows>"] == {
        "instructions": 7, "issue_floor": 3,
        "opcodes": {"LDC": 1, "BRA": 2, "CALL": 1, "IMAD": 1, "STG": 1,
                    "EXIT": 1}}
    assert got["draw_words"]["instructions"] == 1
    assert cs.kernel_name("_ZN12_GLOBAL__N_18draw_anyILb1EEEvPKxxiiPfS3_") \
        == "draw_any<lanes-last>"
    assert cs.launched_warps(2**20) == 2**20 // 4 // 32
    assert cs.issue_bound_ms(100, 528, 132, 1000.0) == pytest.approx(1e-4)


@pytest.mark.parametrize("name", ["sincosf of float32(2 pi) u2",
                                  "2 samples a thread",
                                  "256 threads a block",
                                  "rows stored from registers, 16 bytes a "
                                  "thread",
                                  "at most 32 registers (16 blocks an SM)"])
def test_study_variants_apply_to_the_source(name):
    """Each variant of the study changes the source it is built from, so
    a source edit that a variant no longer matches fails here."""
    from gpu_se_tpu_torch.results import counter_draw_study as cs

    assert cs.variant_source("as built") == cs.SOURCE.read_text()
    assert cs.variant_source(name) != cs.SOURCE.read_text()
