"""The bench rig and the seeded inputs of the reference fixtures, in numpy.

``scripts/make_torch_parity_fixture.py`` writes the fixtures from these
inputs, and the tests and ``chip_smoke.py`` recompute the noise and
inputs the fixtures do not store. It also holds the edge cases
that the CPU tests, the card tests and ``chip_smoke.py`` put ``compact``,
``expand``, ``ends_merge_round``, ``cumsum_merge`` and ``coarse_gather``
through, and the inputs of the scenario MPC that ``chip_smoke.py``
solves on the card. The module imports numpy only, so the card, which
has no JAX, can import it.
"""
from __future__ import annotations

import numpy as np

NX = 5
NOISE_SEED = 11                     # the GSUKF fixture's sigma-point noise
R_GSUKF = 0.37                      # the GSUKF fixture's resample uniform
V2_SEED = 12                        # the v2 fixture's particles and weights
V2_GEOMETRY = (1024, 1024)          # the v2 fixture's (window, block)
X_SS = np.array([280 / 180, 640 / 24.6, 1000 / 116, 0.0, 0.0])


def bench_rig():
    """``(x0, state_pdf, meas_pdf)``: each a ``(means, covariances,
    weights)`` tuple of the Gaussian mixtures of ``bench.py``."""
    x0 = (np.stack([X_SS, X_SS]),
          np.stack([np.eye(5) * 1e-4, np.eye(5) * 1e-3]),
          np.array([0.75, 0.25]))
    state_pdf = (np.zeros((2, 5)),
                 np.stack([np.diag([1e-4, 1e-7, 1e-3, 1e-3, 1e-7]),
                           np.diag([1e-3, 1e-6, 1e-2, 1e-2, 1e-6])]),
                 np.array([0.75, 0.25]))
    meas_pdf = (np.array([[1e-1, 0], [0, -1e-1]]),
                np.array([[[6e-2, 0], [0, 8e-2]], [[500, 100], [100, 700]]]),
                np.array([0.85, 0.15]))
    return x0, state_pdf, meas_pdf


def gsukf_noise(sd: np.ndarray, n: int, seed: int = NOISE_SEED):
    """Sigma-point noise lanes-last ``(2 nx + 1, nx, n)`` float32: normals
    from ``default_rng(seed)`` scaled by ``sd (nx,)``."""
    nx = sd.shape[0]
    eps = np.random.default_rng(seed).standard_normal((2 * nx + 1, nx, n))
    return (eps * sd[None, :, None]).astype(np.float32)


def v2_case(n: int, seed: int = V2_SEED):
    """``(particles (n, 5), integer-valued weights, r)`` float32."""
    rng = np.random.default_rng(seed)
    parts = rng.standard_normal((n, NX)).astype(np.float32)
    w = np.floor(np.exp(2.0 * rng.standard_normal(n))).astype(np.float32)
    return parts, w, np.float32(rng.random())


# ----------------------------------------------------------------------
# edge cases of compact and expand
# ----------------------------------------------------------------------
# every entry survives; one does; a heavy-tailed mix (lognormal, sigma 4)
EDGE_FAMILIES = ("all_survive", "one_survivor", "heavy")
COMPACT_TILE = 2048                 # csrc/resample.cu kTile
EXPAND_MAX_STAGE = 8193             # csrc/resample_expand.cu kMaxStage
# around compact's tile, odd, one past 2^20, many tiles
EDGE_NS = (1, 2047, 2048, 2049, 5001, 2**20 + 1, 2**24)
EDGE_ROWS = (1, 5, 20, 30)
# chunk sizes of expand: not a multiple of 4, the paths' own, the staging
# limit (8192) and past it
EXPAND_BLOCKS = (1, 3, 512, 1024, 4096, 8192, 10000)
CPU_EDGE_N = 5001                   # the largest edge case the CPU runs


def edge_cases(max_n: int | None = None):
    """``(family, n, rows)`` triples: every family at every ``EDGE_NS``
    (up to ``max_n``) with the row counts in turn (1 or 5 rows from 2^20
    on, to bound the memory), and every row count at n = 5001."""
    cases = []
    for k, n in enumerate(EDGE_NS):
        for f, family in enumerate(EDGE_FAMILIES):
            if n < 2**20:
                rows = EDGE_ROWS[(k + f) % len(EDGE_ROWS)]
            else:
                rows = 5 if family == "heavy" else 1
            cases.append((family, n, rows))
    cases += [("heavy", 5001, rows) for rows in EDGE_ROWS
              if ("heavy", 5001, rows) not in cases]
    return [c for c in cases if max_n is None or c[1] <= max_n]


def edge_id(case) -> str:
    return "-".join(str(v) for v in case)


def edge_weights(family: str, n: int, seed: int = 0):
    """``(weights (n,) float32, r float32)`` of an edge case; ``r`` keeps
    away from 0 and 1, where uniform weights tie."""
    rng = np.random.default_rng([seed, n, EDGE_FAMILIES.index(family)])
    if family == "all_survive":
        w = np.ones(n)
    elif family == "one_survivor":
        w = np.zeros(n)
        w[rng.integers(n)] = 1.0
    else:
        w = np.exp(4.0 * rng.standard_normal(n))
    return w.astype(np.float32), np.float32(0.25 + 0.5 * rng.random())


def edge_exact_ends(family: str, n: int):
    """The ``ends`` of an edge case where they are known without a
    cumulative sum, else None: when every entry survives, entry ``k``
    ends at slot ``k``. A float32 cumulative sum of ``n`` ones is exact
    only up to 2^24 and its division by the total ties before that, so
    the kernels' large cases take these ``ends`` instead."""
    if family == "all_survive":
        return np.arange(n, dtype=np.int32)
    return None


def edge_payload(rows: int, n: int, seed: int = 0):
    """``(rows, n)`` float32 in [-0.5, 0.5)."""
    rng = np.random.default_rng([seed, rows, n])
    return rng.random((rows, n), dtype=np.float32) - np.float32(0.5)


# weights without a finite positive sum: all 0, finite weights whose sum
# overflows (the second half float32's max), one NaN
NO_SUM_KINDS = ("zeros", "overflow", "nan")


def no_sum_weights(kind: str, n: int):
    """``(n,)`` float32 weights of a ``NO_SUM_KINDS`` case."""
    w = np.ones(n, np.float32)
    if kind == "zeros":
        w[:] = 0.0
    elif kind == "overflow":
        w[n // 2:] = np.finfo(np.float32).max
    else:
        w[n // 3] = np.nan
    return w


# ----------------------------------------------------------------------
# edge cases of the merge-path kernels: ends_merge_round, cumsum_merge
# ----------------------------------------------------------------------
MERGE_THREADS = 256                 # csrc/merge_path.cuh kMergeThreads
ENDS_MERGE_ITEMS = 8                # csrc/resample_block.cu kItems
CUMSUM_MERGE_ITEMS = 16             # csrc/resample_merge.cu kItems
# one key; two; around ends_merge_round's 2048-item block; odd; one past
# 2^20; 2^24
MERGE_NS = (1, 2, 2047, 2048, 2049, 5001, 2**20 + 1, 2**24)
MERGE_NX = (1, 5, 8, 30, 32)        # ends_merge_round payload columns
MERGE_ROWS = (1, 5, 8)              # cumsum_merge payload rows
# ring feeds of ends_merge_round: (family, n, source blocks, shards). The
# blocks and the shards split n unevenly, so n_blk != n_local; the exact
# ends of "all_survive" put whole blocks below and above a shard's slots
RING_FEEDS = (("all_survive", 4096, 3, 4), ("heavy", 5001, 5, 3),
              ("one_survivor", 4096, 4, 3), ("all_survive", 2**20 + 1, 3, 4),
              ("heavy", 2**20, 8, 3))


def _merge_cases(widths, max_n, ns=MERGE_NS, n_all=5001):
    """``(family, n, width)``: every family at every ``ns`` (up to
    ``max_n``) with the widths in turn (5 for the heavy family and 1 for
    the others from 2^20 on, to bound the memory), and every width at
    n = ``n_all``."""
    cases = []
    for k, n in enumerate(ns):
        for f, family in enumerate(EDGE_FAMILIES):
            if n < 2**20:
                width = widths[(k + f) % len(widths)]
            else:
                width = 5 if family == "heavy" else 1
            cases.append((family, n, width))
    cases += [("heavy", n_all, w) for w in widths
              if ("heavy", n_all, w) not in cases]
    return [c for c in cases if max_n is None or c[1] <= max_n]


def ends_merge_cases(max_n: int | None = None):
    """``(family, n, nx)`` cases of ``ends_merge_round``."""
    return _merge_cases(MERGE_NX, max_n)


def cumsum_merge_cases(max_n: int | None = None):
    """``(family, n, rows)`` cases of ``cumsum_merge``."""
    return _merge_cases(MERGE_ROWS, max_n)


# ----------------------------------------------------------------------
# edge cases of coarse_gather
# ----------------------------------------------------------------------
COARSE_CHUNK = 128                  # csrc/resample_coarse.cu kChunk
COARSE_CHUNKS = 8                   # csrc/resample_coarse.cu kChunks
COARSE_STAGE = 4096                 # csrc/resample_coarse.cu kStage
# one chunk; two; one block; two blocks; four; 2^20; 2^24 (multiples of
# the chunk only)
COARSE_NS = (128, 256, 2048, 4096, 2**13, 2**20, 2**24)
COARSE_ROWS = (1, 5, 6, 8)          # payload rows


def coarse_cases():
    """``(family, n, rows)`` cases of ``coarse_gather``: every row count
    at n = 4096."""
    return _merge_cases(COARSE_ROWS, None, COARSE_NS, 4096)


def ring_bounds(n: int, parts: int) -> list[int]:
    """``parts + 1`` ascending bounds that split ``[0, n)``."""
    return [n * k // parts for k in range(parts + 1)]


# ----------------------------------------------------------------------
# the scenario MPC: chip_smoke.py phase (f)
# ----------------------------------------------------------------------
SCENARIOS = 16                      # scenarios at the canonical rig's width
SCENARIO_SEED = 8
# the spread of each scenario's initial state about the first step's
# x2d, in the linear model's deviation units (g/L of Cg and Cfa)
SCENARIO_SCALE = 0.25


def scenario_offsets(n: int, nx: int, seed: int = SCENARIO_SEED):
    """``(n, nx)`` float64 normal offsets of scale ``SCENARIO_SCALE``."""
    return np.random.default_rng(seed).normal(scale=SCENARIO_SCALE,
                                              size=(n, nx))


def stable_model(seed: int):
    """``(A, B, C, D)`` of ``tests/test_mpc.random_stable_lin_model(seed,
    with_d=False)``: two states, inputs and outputs, A of spectral radius
    0.8, D zero."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(2, 2))
    A = 0.8 * A / np.max(np.abs(np.linalg.eigvals(A)))
    B = rng.normal(size=(2, 2))
    C = rng.normal(size=(2, 2))
    D = rng.normal(size=(2, 2)) * 0.0
    return A, B, C, D


def binding_case():
    """``tests/test_scenario_mpc._binding_setup``'s case: the seed-11
    model, P = 8, M = 3, four scenarios with one outlier whose outputs
    alone reach the +-0.8 output bounds. Returns a dict of ``model (A, B,
    C, D)``, ``P``, ``M``, ``Q``, ``R``, ``ysp``, ``x0s``, ``um1``,
    ``biases`` and ``y_bounds``."""
    return dict(
        model=stable_model(11), P=8, M=3, Q=np.eye(2),
        R=0.5 * np.eye(2), ysp=np.array([0.3, -0.2]),
        x0s=np.array([[0.1, 0.05], [-0.1, 0.02], [0.05, -0.08], [1.6, 1.2]]),
        um1=np.zeros(2), biases=np.zeros((4, 2)),
        y_bounds=[np.array([-0.8, 0.8]), np.array([-0.8, 0.8])],
    )


# ----------------------------------------------------------------------
# cases of counter_draw: (start, count, nx, lanes_last)
# ----------------------------------------------------------------------
# the main paths' draws (the flat step's 2^20 samples a rank, rows, at
# W = 1 and as W = 2's rank 1; 2^21 lanes-last; the GSUKF step's 2^18 x 11
# samples a rank, lanes-last, as W = 2's rank 0 and rank 1), an odd start
# and count, a range across the counter's 32-bit carry; then every
# compile-time nx (1 .. ops/counter_draw.MAX_FIXED_NX) and two run-time
# ones (6, 7), in both layouts, from unaligned starts, for counts that are
# no multiple of a block's 512 samples or of a float4 (a lanes-last row
# then starts off 16 bytes), and a draw smaller than one thread's four
# samples
COUNTER_CASES = ((0, 2**20, 5, False), (2**20, 2**20, 5, False),
                 (0, 2**21, 5, True), (0, 2**18 * 11, 5, True),
                 (2**18 * 11, 2**18 * 11, 5, True),
                 (123457, 999983, 5, False), (2**32 - 1001, 4097, 3, True),
                 (7, 4099, 1, False), (7, 4099, 1, True),
                 (1, 5003, 2, False), (1, 5003, 2, True),
                 (2**31 + 3, 3001, 3, False), (99, 2053, 4, False),
                 (99, 2053, 4, True), (2**33 + 5, 515, 5, True),
                 (11, 3, 5, False), (13, 1027, 6, False),
                 (13, 1027, 7, False), (2**32 - 5, 1027, 7, True))
