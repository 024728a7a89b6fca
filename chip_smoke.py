"""Smoke run of the PyTorch port (``gpu_se_tpu_torch``) on one CUDA card.

Phases, each of which raises on failure:

1. the card: ``nvidia-smi``'s name and power limit; no CUDA, no run;
2. build the kernels from ``gpu_se_tpu_torch/csrc`` with nvcc;
3. each kernel against its plain PyTorch version (``torch.equal`` on
   every output) for uniform, near-uniform and heavy-tailed weights at
   n = 4096, an odd or unaligned n and 2^20, and the ``ends`` merge fed
   four ascending blocks into four shards against one round;
4. the CUDA tiled and flat steps against the committed reference step
   (``tests/data/torch_parity_step.npz``);
5. the tiled main path: the tiled particle-filter step of ``bench.py``'s
   rig at 2^20 particles, one warm-up step and 50 chained steps timed
   with CUDA events; both of its kernels must have launched once per
   step. Then one step is checked against the same step through the
   plain resample, and each stage and each kernel is timed;
6. the flat main path: a ``ParticleFilter`` on the closed loop's
   configuration at 2^20 particles, one warm-up and 50 chained steps
   under auto routing (compact + search_gather), then 10 chained steps
   under each of the ``ends``, ``v3``, ``pallas`` and ``coarse`` routes
   (the ends merge, the cumsum merge, the coarse search); each route's
   kernel must have launched once per step, and one step per route is
   checked against the plain route;
7. the router's other auto routes at full width: a ``(2^20, 8)``
   payload (cumsum merge), a 2^18 Gaussian bank through
   ``systematic_resample`` (ends merge) and ``systematic_resample_bank``
   (compact + search_gather);
8. the merge and coarse kernels timed against their plain versions at
   the flat main path's inputs;
9. the flat step's stage times and, per route, ``torch.profiler`` over
   chained steps (device ops per step, busy share, the kernels with most
   device time).

Each path runs with every launch count set to 0 just before it and read
just after. Output: one line per phase, then a ``{"kernels": [...]}``
JSON line, the ``nvidia-smi`` line, the metric JSON line and, last,
``{"ok": true, "device": {...}}``. Run from the repository root::

    python3 chip_smoke.py [--seed 0]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from gpu_se_tpu_torch import convert  # noqa: E402
from gpu_se_tpu_torch.distributions import GaussianSum  # noqa: E402
from gpu_se_tpu_torch.filters import particle as pf  # noqa: E402
from gpu_se_tpu_torch.filters import particle_tiled as pft  # noqa: E402
from gpu_se_tpu_torch.filters import resampling as rs  # noqa: E402
from gpu_se_tpu_torch.models import bioreactor as bio  # noqa: E402
from gpu_se_tpu_torch.ops import _build  # noqa: E402
from gpu_se_tpu_torch.ops import resample_coarse as rc  # noqa: E402
from gpu_se_tpu_torch.ops import resample_pallas3 as rp3  # noqa: E402
from gpu_se_tpu_torch.ops import resample_pallas4 as rp4  # noqa: E402
from gpu_se_tpu_torch.ops import resample_pallas_block as rpb  # noqa: E402
from gpu_se_tpu_torch.ops.resample_coarse import ends_from_weights  # noqa: E402
from gpu_se_tpu_torch.pytree import tree_flatten  # noqa: E402

N = 2**20
N_BANK = 2**18
STEPS = 50
ROUTE_STEPS = 10
REPS = 30
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "tests", "data", "torch_parity_step.npz")
# rows of a 4096-particle step that may differ from the reference's: one
# per `ends` entry a cumsum tie moves (tests/test_torch_kernels.py)
STEP_TIE_ROWS = 8
# rows of a merge-route resample (float compare cs_k < (i + r) / n) that
# may differ from the plain route (integer ends) at any n: 0 read on the
# card at 2^20 and on the CPU (tests/test_torch_resample_router.py
# test_cross_route_tie_count); this is the margin over that reading
MERGE_TIE_ROWS = 2
W_RTOL = 1e-5        # measurement pdf: exp differs by ulps across libraries
X_SS = np.array([280 / 180, 640 / 24.6, 1000 / 116, 0.0, 0.0])
FAMILIES = ("uniform", "near_uniform", "heavy")
# name: (source, the TPU kernels it replaces, its wrapper)
KERNELS = {
    "search_gather": ("gpu_se_tpu_torch/csrc/resample.cu",
                      "gpu_se_tpu/ops/resample_pallas4.py:76",
                      rp4.search_gather),
    "compact": ("gpu_se_tpu_torch/csrc/resample.cu",
                "gpu_se_tpu/ops/resample_pallas4.py:266", rp4.compact),
    "ends_merge_round": ("gpu_se_tpu_torch/csrc/resample_block.cu",
                         "gpu_se_tpu/ops/resample_pallas_block.py:42, "
                         "gpu_se_tpu/ops/resample_pallas_block.py:231",
                         rpb.ends_merge_round),
    "cumsum_merge": ("gpu_se_tpu_torch/csrc/resample_merge.cu",
                     "gpu_se_tpu/ops/resample_pallas3.py:43, "
                     "gpu_se_tpu/ops/resample_pallas.py:35",
                     rp3.cumsum_merge),
    "coarse_gather": ("gpu_se_tpu_torch/csrc/resample_coarse.cu",
                      "gpu_se_tpu/ops/resample_coarse.py:117",
                      rc.coarse_gather),
}
# the kernel each flat-filter route must launch once per step
ROUTE_KERNELS = {"auto": ("compact", "search_gather"),
                 "ends": ("ends_merge_round",), "v3": ("cumsum_merge",),
                 "pallas": ("cumsum_merge",), "coarse": ("coarse_gather",)}
# routes whose result must equal the plain route's bit for bit; the
# merge routes may part from it at float ties (MERGE_TIE_ROWS)
EXACT_ROUTES = ("auto", "ends", "coarse")


def zero_counts() -> None:
    for _, _, wrapper in KERNELS.values():
        wrapper.launches = 0


def read_counts() -> dict[str, int]:
    return {name: k[2].launches for name, k in KERNELS.items()}


def expect_counts(path: str, counts: dict[str, int],
                  want: dict[str, int]) -> None:
    """Fail unless ``counts`` equals ``want`` (0 for every kernel not
    named)."""
    full = {name: want.get(name, 0) for name in KERNELS}
    if counts != full:
        raise AssertionError(f"{path}: launch counts {counts} != {full}")


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = REPS) -> float:
    """Median device time of ``fn`` over ``reps`` calls, by CUDA events."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_abs_err(got, want) -> float:
    return max(float((g.double() - w.double()).abs().max())
               for g, w in zip(got, want))


def assert_equal(name: str, got, want) -> None:
    for k, (g, w) in enumerate(zip(got, want)):
        if not torch.equal(g, w):
            raise AssertionError(f"{name}: output {k} differs from the "
                                 f"plain version")


def family_weights(family: str, n: int, rng, dev) -> torch.Tensor:
    if family == "uniform":
        w = np.ones(n)
    elif family == "near_uniform":
        w = 1.0 + 0.1 * rng.random(n)
    else:       # lognormal with sigma 4
        w = np.exp(4.0 * rng.standard_normal(n))
    return torch.from_numpy(w.astype(np.float32)).to(dev)


def randn(rng, shape, dev) -> torch.Tensor:
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dev)


def rows_differ(got, want) -> int:
    return int(torch.count_nonzero(torch.any(
        (got != want).reshape(got.shape[0], -1), dim=1)))


def bench_rig(dev):
    x0 = GaussianSum.create(
        np.stack([X_SS, X_SS]),
        np.stack([np.eye(5) * 1e-4, np.eye(5) * 1e-3]),
        np.array([0.75, 0.25]), device=dev)
    state_pdf = GaussianSum.create(
        np.zeros((2, 5)),
        np.stack([np.diag([1e-4, 1e-7, 1e-3, 1e-3, 1e-7]),
                  np.diag([1e-3, 1e-6, 1e-2, 1e-2, 1e-6])]),
        np.array([0.75, 0.25]), device=dev)
    meas_pdf = GaussianSum.create(
        np.array([[1e-1, 0], [0, -1e-1]]),
        np.array([[[6e-2, 0], [0, 8e-2]], [[500, 100], [100, 700]]]),
        np.array([0.85, 0.15]), device=dev)
    return x0, state_pdf, meas_pdf


# ----------------------------------------------------------------------
def phase_card() -> tuple[str, torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: the port's smoke run needs one")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    return card, torch.device("cuda", 0)


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load_library()
    log(f"build: {time.perf_counter() - t0:.2f} s -> "
        f"{os.path.relpath(_build.library_path())}")


def harness_rig(dev):
    """The closed loop's filter configuration: ``sim/harness.get_noise``'s
    state and measurement mixtures (``gpu_se_tpu/sim/harness.py:94-110``)
    and ``x0``, the state mixture moved to the steady state (``:72-75``).
    Returns ``(x0, state_pdf, meas_pdf)``."""
    state = (np.zeros((2, 5)),
             np.stack([np.diag([1e-4, 1e-7, 1e-3, 1e-3, 1e-7]),
                       np.diag([1e-3, 1e-6, 1e-2, 1e-2, 1e-6])]),
             np.array([0.75, 0.25]))
    meas = (np.array([[1e-1, 0], [0, -1e-1]]),
            np.array([[[6e-2, 0], [0, 8e-2]], [[500, 100], [100, 700]]]),
            np.array([0.85, 0.15]))
    return (GaussianSum.create(state[0] + X_SS, *state[1:], device=dev),
            GaussianSum.create(*state, device=dev),
            GaussianSum.create(*meas, device=dev))


def phase_kernels_vs_plain(dev, seed: int) -> dict[str, float]:
    errs = {name: 0.0 for name in ("search_gather", "compact")}
    rng = np.random.default_rng(seed)
    for n in (4096, 5001, N):
        for family in FAMILIES:
            x = torch.from_numpy(
                rng.standard_normal((5, n)).astype(np.float32)).to(dev)
            w = family_weights(family, n, rng, dev)
            r = torch.tensor(np.float32(rng.random()), device=dev)
            ends = ends_from_weights(w, r)
            got = rp4.compact(ends, x)
            want = rp4.compact_plain(ends, x)
            assert_equal(f"compact n={n} {family}", got, want)
            errs["compact"] = max(errs["compact"], max_abs_err(got, want))
            for route, args in (("compacted", got[:3]), ("direct", (ends, x))):
                g = rp4.search_gather(*args)
                p = rp4.search_gather_plain(*args)
                assert_equal(f"search_gather n={n} {family} {route}", g, p)
                errs["search_gather"] = max(errs["search_gather"],
                                            max_abs_err(g, p))
            torch.cuda.synchronize()
            log(f"kernels == plain: n={n} {family} "
                f"(survivors {int(got[3].item())})")
    return errs


def phase_merge_kernels_vs_plain(dev, seed: int) -> dict[str, float]:
    """``ends_merge_round`` at 5 and 30 payload columns, ``cumsum_merge``
    at 5 and 8 rows, ``coarse_gather`` at 5 and 6 rows, against their
    plain versions; then four ascending source blocks into four shards
    (``slot0`` offsets) against one round over the whole pool."""
    errs = {"ends_merge_round": 0.0, "cumsum_merge": 0.0,
            "coarse_gather": 0.0}
    rng = np.random.default_rng(seed + 1)
    for n in (4096, 5120, N):
        for family in FAMILIES:
            w = family_weights(family, n, rng, dev)
            r = torch.tensor(np.float32(rng.random()), device=dev)
            ends = ends_from_weights(w, r)
            cs = rp3.normalized_cumsum(w)
            for nx in (5, 30):
                parts = randn(rng, (n, nx), dev)
                got = rpb.ends_merge_round(
                    ends, parts, 0, *rpb.block_resample_state(n, nx, dev))
                want = rpb.ends_merge_round_plain(
                    ends, parts, 0, *rpb.block_resample_state(n, nx, dev))
                assert_equal(f"ends_merge_round n={n} {family} nx={nx}",
                             got, want)
                errs["ends_merge_round"] = max(errs["ends_merge_round"],
                                               max_abs_err(got, want))
            for rows in (5, 8):
                payload = randn(rng, (rows, n), dev)
                got = rp3.cumsum_merge(cs, payload, r)
                want = rp3.cumsum_merge_plain(cs, payload, r)
                assert_equal(f"cumsum_merge n={n} {family} rows={rows}",
                             got, want)
                errs["cumsum_merge"] = max(errs["cumsum_merge"],
                                           max_abs_err(got, want))
            o = rc.chunk_boundaries(ends, n)
            for rows in (5, 6):
                payload = randn(rng, (rows, n), dev)
                got = rc.coarse_gather(ends, o, payload)
                want = rc.coarse_gather_plain(ends, o, payload)
                assert_equal(f"coarse_gather n={n} {family} rows={rows}",
                             got, want)
                errs["coarse_gather"] = max(errs["coarse_gather"],
                                            max_abs_err(got, want))
            torch.cuda.synchronize()
            log(f"merge kernels == plain: n={n} {family} (ends_merge_round "
                f"at 5 and 30 columns, cumsum_merge at 5 and 8 rows, "
                f"coarse_gather at 5 and 6 rows)")
    w = family_weights("heavy", N, rng, dev)
    ends = ends_from_weights(w, torch.tensor(np.float32(0.37), device=dev))
    parts = randn(rng, (N, 5), dev)
    whole = rpb.ends_merge_round(ends, parts, 0,
                                 *rpb.block_resample_state(N, 5, dev))
    q = 4
    n_blk = n_local = N // q
    for shard in range(q):
        state = rpb.block_resample_state(n_local, 5, dev)
        for b in range(q):
            sl = slice(b * n_blk, (b + 1) * n_blk)
            state = rpb.ends_merge_round(ends[sl], parts[sl],
                                         shard * n_local, *state)
        rows = slice(shard * n_local, (shard + 1) * n_local)
        assert_equal(f"ends_merge_round four-block feed, shard {shard}",
                     state, [t[rows] for t in whole])
    torch.cuda.synchronize()
    log(f"ends_merge_round: four ascending blocks into four shards == one "
        f"round over n={N} (bit-equal)")
    return errs


def phase_fixture(dev) -> None:
    d = np.load(FIXTURE)
    meas = convert.gaussian_sum_from_numpy(
        *(d[f"meas_{f}"] for f in ("means", "covariances", "weights", "chol",
                                   "inv_cov", "log_const")), device=dev)

    def t(name):
        return torch.from_numpy(d[name]).to(dev)

    for regime in ("heavy", "near_uniform"):
        args = (t("x_in"), t("u"), t(f"{regime}_z"), t("dt"),
                bio.homeostatic_des, bio.static_outputs, meas)
        xn, w = pft.predict_update_local(*args, t("noise"))
        want_w = d[f"{regime}_w"]
        w_rel = float(np.max(np.abs(w.cpu().numpy() - want_w) / want_w))
        if not w_rel <= W_RTOL:
            raise AssertionError(f"fixture {regime}: weights off by {w_rel}")
        want = d[f"{regime}_x_out"]
        out, _ = rp4.resample_core(xn, t(f"{regime}_ends"))
        if not np.array_equal(out.cpu().numpy(), want):
            raise AssertionError(
                f"fixture {regime}: resample given the reference's ends "
                f"differs from the reference")
        got = pft.step_from_noise(*args, t("noise"), t("r")).cpu().numpy()
        rows = int(np.count_nonzero(np.any(got != want, axis=0)))
        if rows > STEP_TIE_ROWS:
            raise AssertionError(f"fixture {regime}: {rows} rows differ")
        log(f"fixture {regime}: weights rel err {w_rel:.3g} "
            f"(<= {W_RTOL}); resample given reference ends bit-equal; "
            f"step rows differing {rows} (<= {STEP_TIE_ROWS})")
        # the flat filter's step on the same inputs: uniform incoming
        # weights (exact at a power-of-two n), (n, nx) layout
        x, noise = t("x_in").T.contiguous(), t("noise").T.contiguous()
        n = x.shape[0]
        w_in = torch.full((n,), 1.0 / n, device=dev)
        # the coarse gate takes n >= 2^13 only: at 4096 it is the plain route
        for route in (r for r in ROUTE_KERNELS if r != "coarse"):
            with rs.impl(route):
                got, _ = pf.step_from_noise(
                    x, w_in, t("u"), t(f"{regime}_z"), t("dt"),
                    bio.homeostatic_des, bio.static_outputs, meas, noise,
                    t("r"))
            rows = int(np.count_nonzero(np.any(
                got.cpu().numpy() != want.T, axis=1)))
            if rows > STEP_TIE_ROWS:
                raise AssertionError(
                    f"fixture {regime}: flat step, route {route}: {rows} "
                    f"rows differ")
            log(f"fixture {regime}: flat step through route {route}: rows "
                f"differing {rows} (<= {STEP_TIE_ROWS})")


def phase_main_path(dev, seed: int, card: str):
    x0, state_pdf, meas_pdf = bench_rig(dev)
    u = torch.tensor([0.06, 0.2], dtype=torch.float32, device=dev)
    z = bio.static_outputs(torch.from_numpy(X_SS)).to(torch.float32).to(dev)
    dt = 0.1
    f, g = bio.homeostatic_des, bio.static_outputs
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = pft.init(gen, N, x0)

    def step(s):
        return pft.step(s, u, z, dt, f, g, state_pdf, meas_pdf)

    zero_counts()
    state = step(state)                       # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(STEPS):
        state = step(state)
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    expect_counts("tiled main path", launches,
                  {"compact": STEPS + 1, "search_gather": STEPS + 1})
    est = pft.point_estimate(state)
    if not (torch.isfinite(state.x).all() and torch.isfinite(est).all()):
        raise AssertionError("non-finite state or point estimate")
    if state.x.shape != (5, N):
        raise AssertionError(f"state shape {tuple(state.x.shape)}")
    ms_per_step = start.elapsed_time(end) / STEPS
    log(f"main path: {STEPS} chained steps at n={N}: {ms_per_step:.4f} "
        f"ms/step (CUDA events), host wall {wall_s / STEPS * 1e3:.4f} "
        f"ms/step; launches {launches}; point estimate "
        f"{[round(v, 5) for v in est.tolist()]}")

    # one step through the kernels vs the same step through the plain
    # resample, same noise and r
    x = state.x
    noise = state_pdf.draw_t(gen, N)
    r = torch.rand((), generator=gen, device=dev)
    got = pft.step_from_noise(x, u, z, dt, f, g, meas_pdf, noise, r)
    xn, w = pft.predict_update_local(x, u, z, dt, f, g, meas_pdf, noise)
    ends = ends_from_weights(w, r)
    want, _ = rp4.resample_core_plain(xn, ends)
    if not torch.equal(got, want):
        raise AssertionError("kernel step != plain-resample step")
    c_keys, c_payload, c_idx, count = rp4.compact(ends, xn)
    log(f"main path: kernel step == plain-resample step (bit-equal); "
        f"survivors {int(count.item())} of {N}")

    # per-stage and per-kernel times at the main path's inputs
    stage = {
        "noise draw": lambda: state_pdf.draw_t(gen, N),
        "predict+update": lambda: pft.predict_update_local(
            x, u, z, dt, f, g, meas_pdf, noise),
        "ends": lambda: ends_from_weights(w, r),
        "compact": lambda: rp4.compact(ends, xn),
        "search+gather": lambda: rp4.search_gather(c_keys, c_payload, c_idx),
    }
    for name, fn in stage.items():
        log(f"stage {name}: {time_ms(fn):.4f} ms (median of {REPS}, "
            f"{card})")
    errs = {
        "compact": max_abs_err(rp4.compact(ends, xn),
                               rp4.compact_plain(ends, xn)),
        "search_gather": max_abs_err(
            rp4.search_gather(c_keys, c_payload, c_idx),
            rp4.search_gather_plain(c_keys, c_payload, c_idx)),
    }
    pairs = {
        "compact": (lambda: rp4.compact(ends, xn),
                    lambda: rp4.compact_plain(ends, xn)),
        "search_gather": (
            lambda: rp4.search_gather(c_keys, c_payload, c_idx),
            lambda: rp4.search_gather_plain(c_keys, c_payload, c_idx)),
        "search_gather direct route": (
            lambda: rp4.search_gather(ends, xn),
            lambda: rp4.search_gather_plain(ends, xn)),
    }
    times = {}
    for name, (kern, plain) in pairs.items():
        # plain, kernel, kernel, plain
        p1, k1, k2, p2 = (time_ms(plain), time_ms(kern), time_ms(kern),
                          time_ms(plain))
        times[name] = (min(k1, k2), min(p1, p2))
        log(f"time {name}: kernel {k1:.4f}/{k2:.4f} ms, plain "
            f"{p1:.4f}/{p2:.4f} ms (median of {REPS}, {card})")
    log(f"resample routes: compacted (compact + search_gather) "
        f"{times['compact'][0] + times['search_gather'][0]:.4f} ms, direct "
        f"(search_gather on ends) {times['search_gather direct route'][0]:.4f}"
        f" ms ({card})")

    metric = {
        "metric": "pf_full_step_throughput_2^20_particles",
        "value": 1e3 / ms_per_step, "unit": "steps/s",
        "ms_per_step": ms_per_step, "steps": STEPS, "seed": seed,
        "card": card,
    }
    return launches, errs, times, metric


def phase_flat_pf(dev, seed: int, card: str):
    """The flat ``ParticleFilter`` at 2^20 particles on the closed loop's
    configuration, through the entry points a user calls. Returns the
    launch counts of its route runs, and a predicted-and-updated state
    and ``r`` for the kernel timings."""
    x0, state_pdf, meas_pdf = harness_rig(dev)
    f, g = bio.homeostatic_des, bio.static_outputs
    u = torch.tensor([0.06, 0.2], dtype=torch.float32, device=dev)
    z = bio.static_outputs(torch.from_numpy(X_SS)).to(torch.float32).to(dev)
    dt = 0.1
    filt = pf.ParticleFilter(f, g, N, x0, state_pdf, meas_pdf, seed=seed)
    if filt.particles.shape != (N, 5) or filt.particles.device != dev:
        raise AssertionError(f"particles {tuple(filt.particles.shape)} on "
                             f"{filt.particles.device}")

    def run(route: str, steps: int, warm: int = 0):
        zero_counts()
        with rs.impl(route):
            for _ in range(warm):
                filt.step(u, z, dt)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(steps):
                filt.step(u, z, dt)
            end.record()
            torch.cuda.synchronize()
        counts = read_counts()
        expect_counts(f"flat filter, route {route}", counts,
                      {k: warm + steps for k in ROUTE_KERNELS[route]})
        est, cov = filt.moments()
        if not (torch.isfinite(filt.particles).all()
                and torch.isfinite(est).all() and torch.isfinite(cov)):
            raise AssertionError(f"flat filter, route {route}: non-finite "
                                 f"state or moments")
        ms = start.elapsed_time(end) / steps
        log(f"flat main path, route {route}: {steps} chained steps at n={N}:"
            f" {ms:.4f} ms/step (CUDA events, {card}); launches "
            f"{ {k: v for k, v in counts.items() if v} }; point estimate "
            f"{[round(v, 5) for v in est.tolist()]}, covariance "
            f"{float(cov):.6g}")
        return counts, ms

    route_counts = {"auto": run("auto", STEPS, warm=1)[0]}
    for route in ("ends", "v3", "pallas", "coarse"):
        route_counts[route] = run(route, ROUTE_STEPS)[0]

    # one step per route against the same step through the plain route
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    x, w = filt.particles, filt.weights
    noise = state_pdf.draw(gen, (N,))
    r = torch.rand((), generator=gen, device=dev)

    def one_step():
        return pf.step_from_noise(x, w, u, z, dt, f, g, meas_pdf, noise, r)[0]

    with rs.impl("xla"):
        want = one_step()
    for route in ROUTE_KERNELS:
        with rs.impl(route):
            got = one_step()
        rows = rows_differ(got, want)
        bound = 0 if route in EXACT_ROUTES else MERGE_TIE_ROWS
        if rows > bound:
            raise AssertionError(f"flat step, route {route}: {rows} rows "
                                 f"differ from the plain route")
        log(f"flat step, route {route} vs plain route: {rows} of {N} rows "
            f"differ (at most {bound})")

    state = pf.update(pf.predict(filt.state, u, torch.tensor(dt, device=dev),
                                 f, state_pdf), u, z, g, meas_pdf)
    return route_counts, state, r


def phase_router_routes(dev, seed: int) -> None:
    """The router's other auto routes at full width, through
    ``systematic_resample`` and ``systematic_resample_bank``; each
    against the plain route with the same generator seed."""
    rng = np.random.default_rng(seed + 2)

    def check(name, kernels, entry, exact):
        zero_counts()
        got = entry(torch.Generator(device=dev).manual_seed(seed))
        torch.cuda.synchronize()
        expect_counts(name, read_counts(), {k: 1 for k in kernels})
        with rs.impl("xla"):
            want = entry(torch.Generator(device=dev).manual_seed(seed))
        got_l, want_l = tree_flatten(got)[0], tree_flatten(want)[0]
        rows = max(rows_differ(a, b) for a, b in zip(got_l, want_l))
        n = got_l[0].shape[0]
        if rows > (0 if exact else MERGE_TIE_ROWS):
            raise AssertionError(f"{name}: {rows} rows differ from the "
                                 f"plain route")
        log(f"router {name}: launches {kernels}; {rows} of {n} rows differ "
            f"from the plain route")

    w = family_weights("heavy", N, rng, dev)
    x8 = randn(rng, (N, 8), dev)
    check("auto (2^20, 8) payload", ("cumsum_merge",),
          lambda gen: rs.systematic_resample(x8, w, gen), exact=False)
    wb = family_weights("heavy", N_BANK, rng, dev)
    means = randn(rng, (N_BANK, 5), dev)
    a = randn(rng, (N_BANK, 5, 5), dev)
    covs = a + a.transpose(1, 2)                 # exactly symmetric
    check("auto (2^18) bank pytree", ("ends_merge_round",),
          lambda gen: rs.systematic_resample((means, covs), wb, gen),
          exact=True)
    check("systematic_resample_bank (2^18)", ("compact", "search_gather"),
          lambda gen: rs.systematic_resample_bank(means, covs, wb, gen),
          exact=True)


def phase_merge_times(dev, card: str, state, r):
    """The merge and coarse kernels against their plain versions at the
    flat main path's inputs: the 2^20 predicted particles and their
    weights. ``ends_merge_round`` is timed with a fresh carried state per
    call, as ``systematic_resample_ends`` makes one."""
    parts = state.particles.contiguous()
    ends = ends_from_weights(state.weights, r)
    cs = rp3.normalized_cumsum(state.weights)
    payload = parts.T.contiguous()
    o = rc.chunk_boundaries(ends, N)

    def ends_round(fn):
        return lambda: fn(ends, parts, 0, *rpb.block_resample_state(N, 5, dev))

    pairs = {
        "ends_merge_round": (ends_round(rpb.ends_merge_round),
                             ends_round(rpb.ends_merge_round_plain)),
        "cumsum_merge": (lambda: rp3.cumsum_merge(cs, payload, r),
                         lambda: rp3.cumsum_merge_plain(cs, payload, r)),
        "coarse_gather": (lambda: rc.coarse_gather(ends, o, payload),
                          lambda: rc.coarse_gather_plain(ends, o, payload)),
    }
    errs, times = {}, {}
    for name, (kern, plain) in pairs.items():
        got, want = kern(), plain()
        assert_equal(f"{name} at the main path's inputs", got, want)
        errs[name] = max_abs_err(got, want)
        p1, k1, k2, p2 = (time_ms(plain), time_ms(kern), time_ms(kern),
                          time_ms(plain))
        times[name] = (min(k1, k2), min(p1, p2))
        log(f"time {name}: kernel {k1:.4f}/{k2:.4f} ms, plain "
            f"{p1:.4f}/{p2:.4f} ms (median of {REPS}, {card})")
    return errs, times


def busy_ms(prof) -> tuple[float, float, int, dict[str, float]]:
    """Device time seen by ``prof``: ``(busy, span, ops, per_name)``, with
    busy the union of the device ops' intervals, span from the first
    op's start to the last op's end (both ms), ops their count, and
    per_name each op name's summed duration (ms)."""
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not evs:
        return 0.0, 0.0, 0, {}
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    per_name: dict[str, float] = {}
    for e in evs:
        per_name[e.name] = (per_name.get(e.name, 0.0)
                            + (e.time_range.end - e.time_range.start) / 1e3)
    return (busy / 1e3, (max(e for _, e in spans) - spans[0][0]) / 1e3,
            len(evs), per_name)


def phase_profile(dev, seed: int, card: str) -> None:
    """Where the flat step's time goes. Stage times at the flat main
    path's inputs (median of 30, each call synchronised, so host launch
    latency is in them), then ``torch.profiler`` over ``ROUTE_STEPS``
    chained steps per route: device ops per step, busy share (the union
    of device-op intervals over their span) and the five op names with
    most device time."""
    from torch.profiler import ProfilerActivity, profile

    x0, state_pdf, meas_pdf = harness_rig(dev)
    f, g = bio.homeostatic_des, bio.static_outputs
    u = torch.tensor([0.06, 0.2], dtype=torch.float32, device=dev)
    z = bio.static_outputs(torch.from_numpy(X_SS)).to(torch.float32).to(dev)
    dt = torch.tensor(0.1, device=dev)
    filt = pf.ParticleFilter(f, g, N, x0, state_pdf, meas_pdf, seed=seed)
    filt.step(u, z, dt)
    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    state = filt.state
    noise = state_pdf.draw(gen, (N,))
    pred = pf.predict(state, u, dt, f, state_pdf)
    upd = pf.update(pred, u, z, g, meas_pdf)
    r = torch.rand((), generator=gen, device=dev)

    def routed(route):
        def call():
            with rs.impl(route):
                rs.systematic_resample_from_r(upd.particles, upd.weights, r)
        return call

    stages = {
        "noise draw": lambda: state_pdf.draw(gen, (N,)),
        "predict": lambda: pf.predict_from_noise(state.particles, u, dt, f,
                                                 noise),
        "update": lambda: pf.update(pred, u, z, g, meas_pdf),
        "moments": lambda: (pf.point_estimate(upd),
                            pf.point_covariance(upd)),
    }
    for route in ("auto", "ends", "v3", "pallas", "coarse", "xla"):
        stages[f"resample {route}"] = routed(route)
    for name, fn in stages.items():
        log(f"profile stage {name}: {time_ms(fn):.4f} ms (median of {REPS}, "
            f"synchronised, {card})")

    for route in ("auto", "ends", "v3", "coarse"):
        with rs.impl(route):
            filt.step(u, z, dt)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(ROUTE_STEPS):
                    filt.step(u, z, dt)
                torch.cuda.synchronize()
        busy, span, ops, per_name = busy_ms(prof)
        if not ops:
            log(f"profile route {route}: the profiler saw no device time")
            continue
        top = sorted(per_name.items(), key=lambda kv: -kv[1])[:5]
        log(f"profile route {route}: {ops / ROUTE_STEPS:.1f} device ops/step,"
            f" busy {busy / ROUTE_STEPS:.4f} of span {span / ROUTE_STEPS:.4f}"
            f" ms/step (busy share {busy / span:.3f}; {card}); top: "
            + "; ".join(f"{name[:60]} {ms / ROUTE_STEPS:.4f} ms/step "
                        f"({ms / busy:.3f})" for name, ms in top))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    card, dev = phase_card()
    phase_build()
    errs = phase_kernels_vs_plain(dev, args.seed)
    errs.update(phase_merge_kernels_vs_plain(dev, args.seed))
    phase_fixture(dev)
    launches, main_errs, times, metric = phase_main_path(dev, args.seed, card)
    route_counts, state, r = phase_flat_pf(dev, args.seed, card)
    phase_router_routes(dev, args.seed)
    merge_errs, merge_times = phase_merge_times(dev, card, state, r)
    phase_profile(dev, args.seed, card)
    times.update(merge_times)
    launches["ends_merge_round"] = route_counts["ends"]["ends_merge_round"]
    launches["cumsum_merge"] = (route_counts["v3"]["cumsum_merge"]
                                + route_counts["pallas"]["cumsum_merge"])
    launches["coarse_gather"] = route_counts["coarse"]["coarse_gather"]
    kernels = [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches[name],
        "max_abs_err": max(errs[name], main_errs.get(name, 0.0),
                           merge_errs.get(name, 0.0)),
        "ms": times[name][0], "plain_ms": times[name][1],
    } for name, (source, replaces, _) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps(metric))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
