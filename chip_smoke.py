"""Smoke run of the PyTorch port (``gpu_se_tpu_torch``) on one CUDA card.

Phases, each of which raises on failure:

1. the card: ``nvidia-smi``'s name and power limit; no CUDA, no run;
2. build the kernels from ``gpu_se_tpu_torch/csrc`` with nvcc;
3. each kernel against its plain PyTorch version (``torch.equal`` on
   every output) for uniform, near-uniform and heavy-tailed weights at
   n = 4096, an odd n and 2^20;
4. the CUDA step against the committed reference step
   (``tests/data/torch_parity_step.npz``);
5. the main path: the tiled particle-filter step of ``bench.py``'s rig
   at 2^20 particles, one warm-up step and 50 chained steps timed with
   CUDA events; both kernels must have launched once per step. Then one
   step is checked against the same step through the plain resample,
   and each stage and each kernel is timed at the main path's inputs.

Output: one line per phase, then a ``{"kernels": [...]}`` JSON line, the
``nvidia-smi`` line, the metric JSON line and, last,
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
from gpu_se_tpu_torch.filters import particle_tiled as pft  # noqa: E402
from gpu_se_tpu_torch.models import bioreactor as bio  # noqa: E402
from gpu_se_tpu_torch.ops import _build  # noqa: E402
from gpu_se_tpu_torch.ops import resample_pallas4 as rp4  # noqa: E402
from gpu_se_tpu_torch.ops.resample_coarse import ends_from_weights  # noqa: E402

N = 2**20
STEPS = 50
REPS = 30
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "tests", "data", "torch_parity_step.npz")
# rows of a 4096-particle step that may differ from the reference's: one
# per `ends` entry a cumsum tie moves (tests/test_torch_kernels.py)
STEP_TIE_ROWS = 8
W_RTOL = 1e-5        # measurement pdf: exp differs by ulps across libraries
X_SS = np.array([280 / 180, 640 / 24.6, 1000 / 116, 0.0, 0.0])
SOURCE = "gpu_se_tpu_torch/csrc/resample.cu"
KERNELS = {
    "search_gather": "gpu_se_tpu/ops/resample_pallas4.py:76",
    "compact": "gpu_se_tpu/ops/resample_pallas4.py:266",
}


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


def phase_kernels_vs_plain(dev, seed: int) -> dict[str, float]:
    errs = {name: 0.0 for name in KERNELS}
    rng = np.random.default_rng(seed)
    for n in (4096, 5001, N):
        for family in ("uniform", "near_uniform", "heavy"):
            x = torch.from_numpy(
                rng.standard_normal((5, n)).astype(np.float32)).to(dev)
            if family == "uniform":
                w = np.ones(n)
            elif family == "near_uniform":
                w = 1.0 + 0.1 * rng.random(n)
            else:
                w = np.exp(4.0 * rng.standard_normal(n))
            w = torch.from_numpy(w.astype(np.float32)).to(dev)
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


def phase_main_path(dev, seed: int, card: str) -> tuple[list[dict], dict]:
    x0, state_pdf, meas_pdf = bench_rig(dev)
    u = torch.tensor([0.06, 0.2], dtype=torch.float32, device=dev)
    z = bio.static_outputs(torch.from_numpy(X_SS)).to(torch.float32).to(dev)
    dt = 0.1
    f, g = bio.homeostatic_des, bio.static_outputs
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = pft.init(gen, N, x0)

    def step(s):
        return pft.step(s, u, z, dt, f, g, state_pdf, meas_pdf)

    rp4.compact.launches = 0
    rp4.search_gather.launches = 0
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
    launches = {"compact": rp4.compact.launches,
                "search_gather": rp4.search_gather.launches}
    if launches != {"compact": STEPS + 1, "search_gather": STEPS + 1}:
        raise AssertionError(f"launch counts {launches} != {STEPS + 1} steps")
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
    kernels = [{
        "name": name, "route": "cuda", "source": SOURCE,
        "replaces": KERNELS[name], "launches": launches[name],
        "max_abs_err": errs[name], "ms": times[name][0],
        "plain_ms": times[name][1],
    } for name in KERNELS]
    return kernels, metric


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    card, dev = phase_card()
    phase_build()
    errs = phase_kernels_vs_plain(dev, args.seed)
    phase_fixture(dev)
    kernels, metric = phase_main_path(dev, args.seed, card)
    for k in kernels:
        k["max_abs_err"] = max(k["max_abs_err"], errs[k["name"]])
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps(metric))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
