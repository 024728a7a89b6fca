"""A closed measurement stream through a filter shell: each step is the
shell's graphed ``predict(u, dt)``, ``update(u, z)`` and ``resample()``,
fed host values as they arrive, then its ``point_estimate()``; the next
step is enqueued as soon as this one is.

CUDA events around each stage give every step's device time (its tail)
and every stage's (the rooflines). Each step's resample route is the
hand-written kernels its resample launched (the program's launch counts,
``graphs.KERNELS``). ``check_steps`` steps drawn from the seed by
reservoir sampling over the window, and one more of each route that
none of those took, keep references to the state before the step and
after each stage for the comparison, which runs once the window has
closed and the peak memory has been read: every route the window took
is compared. With ``--trace 1`` a stretch of ``trace_steps`` more steps
after the window runs under the profiler.
"""
from __future__ import annotations

import time

import numpy as np

from port_bench import manifest, tracing, traffic_gen
from port_bench.reference.mixture import Mixture

STAGES = ("predict", "update", "resample")


def mixtures(cfg: dict) -> dict:
    return {"state": Mixture.from_config(cfg["state_noise"]),
            "measurement": Mixture.from_config(cfg["measurement_noise"])}


def _f32(v):
    return np.asarray(v, dtype=np.float32).astype(np.float64)


def run(s) -> None:
    import torch

    s.mark("imports")
    cfg, tr = s.config, s.traffic
    est = manifest.module("estimators", cfg["estimator"])
    mix = mixtures(cfg)
    dt = float(tr["dt"])
    warm = int(tr["warmup_steps"])
    n_traj = warm + int(s.seconds * tr["max_steps_per_s"]) + 1
    if s.trace:
        n_traj += int(tr["trace_steps"])
    x_start, us, zs = traffic_gen.ss2ss(cfg, tr, s.seed, n_traj, mix)
    s.mark("trajectory")
    shell = est.build(cfg, s.seed, s.device, x_start)
    s.mark("filter")
    on_card = s.device.type == "cuda"

    def events():
        return [torch.cuda.Event(enable_timing=True) for _ in range(4)] \
            if on_card else None

    from gpu_se_tpu_torch.graphs import KERNELS

    def launches():
        return [k.launches for k in KERNELS]

    def step(i, ev=None, snap=None, label=False, keep=None):
        """One step; returns its point estimate and its resample route
        (``(kernel, launches)`` of each kernel its resample launched)."""
        u, z = us[i], zs[i]
        calls = (lambda: shell.predict(u, dt), lambda: shell.update(u, z),
                 shell.resample)
        if snap is not None:
            snap.update(i=i, before=est.snapshot(shell))
        for k, call in enumerate(calls):
            if k == 2:
                n0 = launches()
            if ev is not None:
                ev[k].record()
            if label:
                with torch.profiler.record_function(f"bench.{STAGES[k]}"):
                    call()
            else:
                call()
            if snap is not None:
                snap[("predicted", "updated", "resampled")[k]] = \
                    est.snapshot(shell)
            if keep is not None and k == 1:
                keep.append(est.snapshot(shell)["weights"])
        route = tuple((kern.__name__, b - a) for kern, a, b in
                      zip(KERNELS, n0, launches()) if b != a)
        if ev is not None:
            ev[3].record()
        if label:
            with torch.profiler.record_function("bench.point_estimate"):
                return shell.point_estimate(), route
        estimate = shell.point_estimate()
        if snap is not None:
            snap["estimate"] = estimate
        return estimate, route

    for i in range(warm):
        step(i)
    if on_card:
        torch.cuda.synchronize()
    s.mark("warm-up")
    pool = [events() for _ in range(int(s.seconds * tr["max_steps_per_s"]))] \
        if on_card else []
    s.mark("events")
    graphs = list(shell.graphs.values())
    captures = sum(g.captures for g in graphs)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng([s.seed, 1])
    k_check = int(tr["check_steps"])
    stride = int(tr["resample_count_stride"])
    limit = n_traj - (int(tr["trace_steps"]) if s.trace else 0)
    snaps, ests, evs, weights = [], [], [], []
    routes = {}        # route -> [steps that took it, one of them drawn]
    i, j = warm, 0
    s.card_state("start")
    s.end_to_end["setup_s"] = time.time() - s.process_start
    t0 = time.perf_counter()
    while i < limit:
        slot = j if j < k_check else int(rng.integers(0, j + 1))
        snap = {"j": j}
        ev = (pool[j] if j < len(pool) else events()) if on_card else None
        keep = [] if j % stride == 0 and len(weights) < 64 else None
        estimate, route = step(i, ev, snap, keep=keep)
        ests.append(estimate)
        evs.append(ev)
        snap["route"] = route
        seen = routes.setdefault(route, [0, None])
        seen[0] += 1
        if rng.random() * seen[0] < 1.0:
            seen[1] = snap
        if keep:
            weights.append((j, keep[0]))
        if slot < k_check:
            if slot < len(snaps):
                snaps[slot] = snap
            else:
                snaps.append(snap)
        i, j = i + 1, j + 1
        if time.perf_counter() - t0 >= s.seconds:
            break
    if on_card:
        torch.cuda.synchronize()
    window = time.perf_counter() - t0
    s.card_state("end")
    if i >= limit:
        s.say(f"the trajectory ran out after {j} steps")
    s.captures_in_window = sum(g.captures for g in graphs) - captures
    taken = {snap["route"] for snap in snaps}
    snaps += [pick for route, (_, pick) in routes.items()
              if route not in taken]
    for snap in snaps:
        snap.update(u=_f32(us[snap["i"]]), z=_f32(zs[snap["i"]]),
                    dt=float(np.float32(dt)))
    s.say("resample routes in the window (kernel, launches a step): "
          + "; ".join(f"{dict(r) or 'none'}: {n} steps"
                      for r, (n, _) in routes.items()))
    s.say("checked steps (window step: route): " + ", ".join(
        f"{snap['j']}: {dict(snap['route']) or 'none'}" for snap in snaps))
    del routes
    s.memory_peak_bytes = (torch.cuda.max_memory_allocated()
                           if on_card else 0)
    s.attempted = j
    est_all = torch.stack(ests)
    s.failed = int((~torch.isfinite(est_all).all(dim=1)).sum())
    s.end_to_end["filter_steps_per_s"] = j / window
    s.work = {"estimator": cfg["estimator"], "n": 2 ** cfg["n_log2"],
              "nx": len(cfg["plant"]["x_guess"])}
    if on_card:
        per = np.array([[evs[m][k].elapsed_time(evs[m][k + 1])
                         for k in range(3)] for m in range(j)])
        s.stage_ms = {name: per[:, k].tolist()
                      for k, name in enumerate(STAGES)}
        step_ms = per.sum(axis=1)
        s.say(f"step ms over the window: median "
              f"{np.percentile(step_ms, 50):.4f}, p95 "
              f"{np.percentile(step_ms, 95):.4f}, p99 "
              f"{np.percentile(step_ms, 99):.4f}, max {step_ms.max():.4f}")
        s.resample_inputs = [(s.stage_ms["resample"][m], w)
                             for m, w in weights]
    if s.trace and on_card:
        out = {}
        with tracing.traced(out):
            for m in range(int(tr["trace_steps"])):
                step(i + m, label=True)
        s.trace_data = out
    del shell, ests
    if on_card:
        torch.cuda.synchronize()
    s.compared = est.check(snaps, mix, s.control, s.seed)
