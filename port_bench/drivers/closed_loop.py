"""Monte Carlo episodes of the device closed loop through the program's
own entry: ``sim.loop.make_scan_loop`` on the rig of ``sim.harness.
get_parts``, each episode ``run.start`` then ``run.steps``, back to back.

Every seed runs the same pool of episodes, in an order drawn from the
seed: each episode's plant and measurement noise comes from the
traffic's ``noise_seed`` plus its index in ``pool``, and every episode
starts from the same plant state and the same filter (drawn from the
traffic's ``filter_seed``). The QP's stalls hang on the estimates to the
last bit, so a filter drawn from the seed would change the work from
seed to seed; the pool's episodes stall different numbers of times, so
an episode's device time against its WHILE iterations gives the cost of
one chunk. The window runs whole cycles of the pool and starts none
once ``--seconds`` has passed; the seed also picks the episodes the
reference checks and the reference filter's own stream (the filter of
the configuration's estimator, ``loop_filter`` of
``estimators/<estimator>.py``). After each episode its records, its
statuses and the WHILE iterations the card counted are read. Set-up
captures the step's graphs (one a pair of event masks) and the QP's by
calling the loop's graphed step twice for each pair. With ``--trace 1``
one short episode (``trace_end_time``) through a second loop of the same
rig runs under the profiler after the window. Where the estimator's
module reads the program's bank (``bank_survivors``), each checked
episode runs once more after that, through the same graphs from the same
inputs, its records held bit for bit to the window's, for the bank after
each control event.
"""
from __future__ import annotations

import time

import numpy as np

from port_bench import manifest, tracing, traffic_gen
from port_bench.drivers.stream import mixtures
from port_bench.reference import loop_check, plant
from port_bench.reference.mpc import ReferenceMPC


def _host(t):
    return t.detach().cpu().numpy().astype(float)


def run(s) -> None:
    import torch

    from gpu_se_tpu_torch.control.qp import SOLVED
    from gpu_se_tpu_torch.filters import gs_ukf, particle
    from gpu_se_tpu_torch.sim import harness, loop

    s.mark("imports")
    cfg, tr = s.config, s.traffic
    dev = s.device
    on_card = dev.type == "cuda"
    dt_control = float(cfg["mpc"]["dt_control"])
    dt_predict = float(tr["dt_predict"])
    core = particle if cfg["estimator"] == "pf" else gs_ukf
    bio, lin, K, est = harness.get_parts(
        dt_control=dt_control, N_particles=2 ** cfg["n_log2"],
        pf=cfg["estimator"] == "pf", seed=int(tr["filter_seed"]),
        device=dev)
    state_pdf, meas_pdf = harness.get_noise(device=dev)
    s.mark("rig")

    def make(end_time):
        run, ts = loop.make_scan_loop(
            K, lin, state_pdf.dist, meas_pdf.dist, end_time=end_time,
            dt_control=dt_control, dt_predict=dt_predict, filter_core=core)
        masks = loop.event_masks(ts, dt_control, dt_predict)
        return run, ts, masks

    def warm(run, masks):
        """A short episode: the first steps, chained, until every pair of
        event masks has been captured (its first carry, from
        ``run.start``, and the later ones, the step's own output, are
        laid out apart) and replayed."""
        gen = torch.Generator(device=dev).manual_seed(int(tr["noise_seed"]))
        carry, noise = run.start(state0, x0, gen)
        step = run.graphs["step"]
        keys = list(zip(*(m.tolist() for m in masks)))
        seen = {}
        for i, key in enumerate(keys):
            carry = step(*carry, noise[i], *key)[0]
            seen[key] = seen.get(key, 0) + 1
            if i >= 2 and all(seen.get(k, 0) >= 3 for k in set(keys)):
                break

    state0, x0 = est.state, bio.X.copy()
    run, ts, masks = make(float(tr["end_time"]))
    warm(run, masks)
    if s.trace and on_card:
        run_t, _, masks_t = make(float(tr["trace_end_time"]))
        warm(run_t, masks_t)
    if on_card:
        torch.cuda.synchronize()
    s.mark("warm-up")
    events_per_episode = int(masks[1].sum())
    if on_card:
        from gpu_se_tpu_torch.ops import graph_cond

        def iterations():
            return graph_cond.iterations(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    else:
        def iterations():
            return None
    step_g = run.graphs["step"]
    captures = step_g.captures
    order = traffic_gen.episode_order(tr, s.seed)
    episodes = []
    s.card_state("start")
    s.end_to_end["setup_s"] = time.time() - s.process_start
    t0 = time.perf_counter()
    while True:
        for e in order:
            gen = torch.Generator(device=dev).manual_seed(
                int(tr["noise_seed"]) + e)
            it0 = iterations()
            if on_card:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            carry, noise = run.start(state0, x0, gen)
            h0 = time.perf_counter()
            rec = run.steps(carry, noise)
            enqueue = time.perf_counter() - h0
            if on_card:
                ev[1].record()
            status = rec.status.cpu().numpy()
            it1 = iterations()
            episodes.append({
                "pool_index": e, "events": events_per_episode,
                "enqueue_s": enqueue,
                "device_ms": ev[0].elapsed_time(ev[1]) if on_card else None,
                "while_iterations": None if it0 is None else it1 - it0,
                "unsolved": int((status[masks[1]] != SOLVED).sum()),
                "rec": rec, "noise": noise})
        if time.perf_counter() - t0 >= s.seconds:
            break
    window = time.perf_counter() - t0
    s.card_state("end")
    s.captures_in_window = step_g.captures - captures
    s.memory_peak_bytes = (torch.cuda.max_memory_allocated()
                           if on_card else 0)
    s.attempted = sum(ep["events"] for ep in episodes)
    s.failed = sum(ep["unsolved"] for ep in episodes)
    s.end_to_end["control_event_ms"] = window * 1e3 / s.attempted
    s.episodes = episodes_meta = [
        {k: v for k, v in ep.items() if k not in ("rec", "noise")}
        for ep in episodes]
    s.say(f"window: {window:.3f} s for {len(episodes)} episodes, "
          f"{window - s.seconds:.3f} s past --seconds")
    for k, ep in enumerate(s.episodes):
        s.say(f"episode {k}: pool {ep['pool_index']}, "
              f"{ep['while_iterations']} WHILE iterations, "
              f"{ep['unsolved']} unsolved, device {ep['device_ms']} ms, "
              f"enqueue {ep['enqueue_s']:.4f} s")
    if s.trace and on_card:
        out = {}
        gen = torch.Generator(device=dev).manual_seed(int(tr["noise_seed"]))
        with tracing.traced(out):
            with torch.profiler.record_function("bench.episode.start"):
                carry, noise = run_t.start(state0, x0, gen)
            with torch.profiler.record_function("bench.episode.steps"):
                rec_t = run_t.steps(carry, noise)
            with torch.profiler.record_function("bench.episode.read"):
                rec_t.status.cpu()
        s.trace_data = out
        s.say("the profiler records no kernel that runs inside a conditional "
              "node's body: busy_s leaves out the QP's WHILE chunks")

    t_check = time.perf_counter()
    survivors = getattr(manifest.module("estimators", cfg["estimator"]),
                        "bank_survivors", None)

    def replay(ep):
        """The episode once more through the same graphs from the same
        inputs, for what the records leave out: the filter's bank after
        each control event, read by the estimator's ``bank_survivors``.
        NaN throughout where the replay's records depart from the
        window's by a bit."""
        gen = torch.Generator(device=dev).manual_seed(
            int(tr["noise_seed"]) + ep["pool_index"])
        carry, noise = run.start(state0, x0, gen)
        flags = list(zip(*(m.tolist() for m in masks)))
        outs, kept = [], []
        for i, key in enumerate(flags):
            carry, out = step_g(*carry, noise[i], *key)
            outs.append(out)
            if key[1]:
                kept.append(survivors(carry[0]))
        same = all(torch.equal(torch.stack(v), w)
                   for v, w in zip(zip(*outs), ep["rec"]))
        shares = torch.stack(kept).cpu().numpy()
        if not same:
            s.say(f"the replay of pool episode {ep['pool_index']} departs "
                  f"from the window's records")
            shares[:] = np.nan
        return shares
    rng = np.random.default_rng([s.seed, 3])
    picks = rng.choice(len(episodes), size=min(int(tr["check_episodes"]),
                                               len(episodes)), replace=False)
    recs = []
    for p in sorted(int(v) for v in picks):
        ep = episodes[p]
        r = ep["rec"]
        recs.append((p, {"us": _host(r.us), "xs": _host(r.xs),
                         "zs": _host(r.ys_meas), "xs_f": _host(r.xs_f),
                         "status": r.status.cpu().numpy(),
                         "noise": _host(ep["noise"]),
                         "predict": masks[0], "control": masks[1]}))
        if survivors is not None:
            kept = recs[-1][1]["survivors"] = replay(ep)
            low = np.flatnonzero(kept < 0.999)
            s.say(f"pool episode {ep['pool_index']}: share of the bank kept "
                  f"by each control event's resample: min "
                  f"{float(kept.min())!r}, mean {float(kept.mean())!r}; "
                  f"under 0.999 at {len(low)} events: {low[:12].tolist()}")
    del episodes, run, K, est, state0, step_g
    if s.trace and on_card:
        del run_t, rec_t
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    mpc_ref = ReferenceMPC(cfg, device=dev)
    x_start = plant.steady_state(cfg["plant"]["u_start"],
                                 cfg["plant"]["x_guess"])
    mix = mixtures(cfg)
    dt = float(np.float32(ts[1]))
    loop_filter = manifest.module("estimators", cfg["estimator"]).loop_filter
    out = {}
    for p, rec in recs:
        got = loop_check.check_episode(
            rec, x_start, mpc_ref, cfg, mix, dt, SOLVED,
            seed=(s.seed * 7919 + p) % 2 ** 63, device=dev,
            loop_filter=loop_filter, control=s.control)
        s.say(f"episode {p} ({episodes_meta[p]['pool_index']} of the pool): "
              f"estimate gap over the spread by state: "
              f"{got.pop('_estimate_gap_by_state')}")
        for k, v in got.items():
            out[k] = loop_check.worse(out.get(k, 0), v) \
                if k != "fallback_misses" else out.get(k, 0) + v
    s.compared = out
    s.say(f"check: {time.perf_counter() - t_check:.2f} s for {len(recs)} "
          f"episodes")
