"""The experiment campaign on the card: run sequences, energy per step,
the pacf series, the MPC run sequence, the closed-loop frontiers and the
host experiments, recorded in ``artifacts/CAMPAIGN_H100.json``.

Counterpart of the reference's ``scripts/campaign_tpu.py`` and
``scripts/campaign_cpu.py``. Legs are chosen by name (all of them when
none is named). Each leg computes its data through the experiments'
memoized entry points, so the jar (``picklejar_torch/``, or
``GPU_SE_TORCH_PICKLEJAR_ROOT``) then holds what the figures are drawn
from, and the artifact is rewritten after every size: a run cut short
leaves a file that says which legs and sizes ran. A leg that fails
raises, and the command exits non-zero.

The card's run sequences, breakdown, energy and MPC chain are timed as
graph replays, the reference's ``jax.jit``; each card size is also timed
eagerly right after (``graphs.disabled``, not memoized) and recorded
beside, under ``eager``, as the pacf leg records its eager chain.

Usage, on a host with a CUDA card (and no matplotlib needed)::

    python -m gpu_se_tpu_torch.results.campaign pf_run_seq gsf_run_seq
    python -m gpu_se_tpu_torch.results.campaign --out other.json power

and, where matplotlib is, the figures from the jar and the artifact::

    python -m gpu_se_tpu_torch.results.campaign --figures pf_run_seq power
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from gpu_se_tpu_torch import graphs
from gpu_se_tpu_torch.results import _common

LEGS = ("pf_run_seq", "gsf_run_seq", "power", "pacf", "mpc", "frontier",
        "openloop")
RUNS = 30
BREAKDOWN_N = 2**18
POWER_T_RUN = 3.0
MPC_RUNS = 300
PF_FRONTIER_LOG2 = np.arange(4, 21, 4.0)
GSF_FRONTIER_LOG2 = np.arange(2, 15, 3.0)
PERF_VS_CP = (12, 3)          # control periods, Monte-Carlo runs


def _finite(x):
    """A float for JSON: ``None`` where it is NaN or infinite."""
    x = float(x)
    return x if math.isfinite(x) else None


def card_info() -> dict:
    """The card's ``nvidia-smi`` name and power limit, and the torch and
    CUDA versions; raises where there is no card."""
    if not torch.cuda.is_available():
        raise RuntimeError("the campaign runs on a CUDA card; torch sees none")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", f"GPU-{torch.cuda.get_device_properties(0).uuid}"],
        capture_output=True, text=True, check=True).stdout.strip()
    return {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}


class Artifact:
    """The campaign's record: loaded from ``base`` where it exists, each
    leg's entry replaced as the leg runs, written to ``out`` after every
    size."""

    def __init__(self, base: str, out: str, card: dict):
        self.out = out
        self.data = {"legs": {}}
        if os.path.exists(base):
            with open(base) as fh:
                self.data = json.load(fh)
        self.data["card"] = card

    def start(self, leg: str, **settings) -> dict:
        entry = {"status": "running", "started": time.strftime(
            "%Y-%m-%dT%H:%M:%SZ", time.gmtime()), **settings}
        self.data["legs"][leg] = entry
        self.write()
        return entry

    def write(self) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(self.out)), exist_ok=True)
        tmp = self.out + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self.data, fh, indent=1)
        os.replace(tmp, self.out)


def seq_stats(seq) -> dict:
    """Median and 10/90% quantiles of a run sequence (seconds), and its
    max |pacf| over lags 1..10."""
    from gpu_se_tpu_torch.utils import max_abs_pacf

    seq = np.asarray(seq, dtype=float)
    return {"median_s": float(np.median(seq)),
            "q10_s": float(np.quantile(seq, 0.1)),
            "q90_s": float(np.quantile(seq, 0.9)),
            "max_abs_pacf": _finite(max_abs_pacf(seq))}


def run_seq_legs(art, entry, entries, grids):
    """Each ``(name, fn)`` of ``entries`` over each leg's grid, ``RUNS``
    runs a size, one size at a time; ``entry["sizes"][leg][op]`` gains a
    row per size, a card row with the eager timing of its size
    (``graphs.disabled``, the unmemoized function ``fn.raw``: an eager
    timing is never read from, or written to, the jar of the graphed
    one) under ``eager``."""
    entry["sizes"] = {leg: {name: [] for name, _ in entries} for leg in grids}
    for leg, (gpu, log2s) in grids.items():
        for log2 in log2s:
            n = int(2.0 ** log2)
            for name, fn in entries:
                _, (seq,) = fn(np.array([n]), RUNS, gpu)
                row = {"log2": float(log2), "n": n, **seq_stats(seq)}
                if gpu:
                    with graphs.disabled():
                        row["eager"] = seq_stats(
                            fn.raw(n, RUNS, gpu))
                entry["sizes"][leg][name].append(row)
            art.write()


def leg_pf_run_seq(art):
    from gpu_se_tpu_torch.results.pf_openloop import pf_run_seq as m

    entry = art.start("pf_run_seq", runs=RUNS,
                      card_log2=m.ACC_LOG2.tolist(),
                      cpu_log2=m.CPU_LOG2.tolist(), breakdown_n=BREAKDOWN_N)
    entries = [("predict", m.predict_run_seq), ("update", m.update_run_seq),
               ("resample", m.resample_run_seq), ("step", m.step_run_seq)]
    run_seq_legs(art, entry, entries,
                 {"card": (True, m.ACC_LOG2), "cpu": (False, m.CPU_LOG2)})
    entry["breakdown"] = {}
    for leg, gpu in (("card", True), ("cpu", False)):
        rows = m.breakdown_run_seqs(BREAKDOWN_N, RUNS, gpu)
        entry["breakdown"][leg] = {k: seq_stats(v) for k, v in rows.items()}
        art.write()
    with graphs.disabled():
        rows = m.breakdown_run_seqs.raw(BREAKDOWN_N, RUNS, True)
    entry["breakdown"]["card"]["eager"] = {k: seq_stats(v)
                                           for k, v in rows.items()}


def leg_gsf_run_seq(art):
    from gpu_se_tpu_torch.results.gsf_openloop import gsf_run_seq as m

    entry = art.start("gsf_run_seq", runs=RUNS,
                      card_log2=m.ACC_LOG2.tolist(),
                      cpu_log2=m.CPU_LOG2.tolist())
    entries = [("predict", m.predict_run_seq), ("update", m.update_run_seq),
               ("resample", m.resample_run_seq),
               ("sigma_points", m.sigma_points_run_seq)]
    run_seq_legs(art, entry, entries,
                 {"card": (True, m.ACC_LOG2), "cpu": (False, m.CPU_LOG2)})
    _, noop = m.noop_run_seq(np.array([1]), RUNS, False)
    entry["noop"] = seq_stats(noop[0])


def leg_power(art):
    from gpu_se_tpu_torch.results.gsf_openloop import gsf_power
    from gpu_se_tpu_torch.results.pf_openloop import pf_power

    entry = art.start("power", t_run_s=POWER_T_RUN)
    for name, mod in (("pf", pf_power), ("gsf", gsf_power)):
        entry[name] = {"log2": mod.N_LOG2.tolist(), "card": [], "cpu": []}
        for gpu, leg in ((True, "card"), (False, "cpu")):
            for log2 in mod.N_LOG2:
                (n, e_cpu, e_card), = mod.energy_per_run(
                    POWER_T_RUN, gpu, np.array([log2]))
                row = {"n": n, "cpu_j_per_step": _finite(e_cpu),
                       "card_j_per_step": _finite(e_card)}
                if gpu:
                    with graphs.disabled():
                        (_, e_cpu, e_card), = pf_power.per_step(
                            [n], [mod.step_energy.raw(
                                n, POWER_T_RUN, gpu)])
                    row["eager"] = {"cpu_j_per_step": _finite(e_cpu),
                                    "card_j_per_step": _finite(e_card)}
                entry[name][leg].append(row)
                art.write()


def leg_pacf(art):
    """The pacf series of record, one CUDA graph replay a rep, beside the
    eager chain's series (one launch a kernel) taken first in the same
    call; each with its host-ms and device-ms series."""
    from gpu_se_tpu_torch.results import pacf_series

    entry = art.start("pacf")
    eager = pacf_series.pacf_series(graphed=False)
    entry.update(pacf_series.pacf_series(graphed=True), eager=eager)


def leg_mpc(art):
    from gpu_se_tpu_torch.results.bioreactor_closedloop import mpc_run_seq as m

    entry = art.start("mpc", n_runs=MPC_RUNS, dt_control=0.1)
    times = m.mpc_run_seq(MPC_RUNS)[1:]   # the first call is cold
    entry["k_step"] = seq_stats(times)
    art.write()
    ms, iters = m.device_solve_ms()
    entry["device_solve_ms"] = ms
    entry["cold_start_iterations"] = iters
    entry["eager"] = {"device_solve_ms": m.device_solve_ms(graphed=False)[0]}


def leg_frontier(art):
    from gpu_se_tpu_torch.results.gsf_closedloop import (
        bioreactor_performance_gsf as gsf,
    )
    from gpu_se_tpu_torch.results.pf_closedloop import (
        bioreactor_performance_pf as pf,
    )

    entry = art.start("frontier", dt_control=pf.DT_CONTROL, end_time=50,
                      pf_log2=PF_FRONTIER_LOG2.tolist(),
                      gsf_log2=GSF_FRONTIER_LOG2.tolist())
    for name, mod, log2s in (("pf", pf, PF_FRONTIER_LOG2),
                             ("gsf", gsf, GSF_FRONTIER_LOG2)):
        entry[name] = []
        for log2 in log2s:
            n = int(2**log2)
            row = {"n": n}
            for shell, fn in (("host", mod.get_sim_summary),
                              ("device", mod.get_sim_summary_device)):
                s = fn(n, pf.DT_CONTROL, pf.DT_CONTROL, 0, 50)
                row[shell] = {"itse": _finite(s["performance"]),
                              "utilization": pf.utilization(s),
                              "runtime_s": s["runtime"],
                              "mpc_frac": s["mpc_frac"]}
            entry[name].append(row)
            art.write()


def leg_openloop(art):
    from gpu_se_tpu_torch.results.bioreactor_closedloop import (
        no_noise,
        performance_vs_control_period as pvcp,
        with_noise,
    )
    from gpu_se_tpu_torch.results.bioreactor_openloop import step_tests

    entry = art.start("openloop", perf_vs_control_period=list(PERF_VS_CP))
    slope, arg = step_tests.max_slope(dt=0.1)
    entry["max_slope"] = {"slope": float(slope),
                          "at": [float(a) for a in arg]}
    for name, fn in (("no_noise", no_noise.trajectory),
                     ("with_noise", with_noise.noisy_trajectory)):
        t0 = time.perf_counter()
        entry[name] = {"itse": fn()["itse"],
                       "seconds": time.perf_counter() - t0}
        art.write()
    t0 = time.perf_counter()
    dtcs, table = pvcp.sweep(*PERF_VS_CP)
    entry["perf_vs_control_period"] = {
        "seconds": time.perf_counter() - t0,
        "dt_control": dtcs.tolist(),
        "median_itse": [_finite(v) for v in np.nanmedian(
            np.where(table > 1e8, np.nan, table), axis=1)]}


LEG_FNS = {"pf_run_seq": leg_pf_run_seq, "gsf_run_seq": leg_gsf_run_seq,
           "power": leg_power, "pacf": leg_pacf, "mpc": leg_mpc,
           "frontier": leg_frontier, "openloop": leg_openloop}


def figures(legs) -> None:
    """Each named leg's figures, from the jar (and the card's name from
    the artifact where this host has no card)."""
    from gpu_se_tpu_torch.results.gsf_closedloop import (
        bioreactor_performance_gsf,
    )
    from gpu_se_tpu_torch.results.gsf_openloop import gsf_power, gsf_run_seq
    from gpu_se_tpu_torch.results.pf_closedloop import bioreactor_performance_pf
    from gpu_se_tpu_torch.results.pf_openloop import pf_power, pf_run_seq
    from gpu_se_tpu_torch.results.bioreactor_closedloop import (
        mpc_run_seq,
        no_noise,
        performance_vs_control_period,
        with_noise,
    )
    from gpu_se_tpu_torch.results.bioreactor_openloop import (
        batch_production_growth,
        ss2ss,
        step_tests,
    )

    makers = {
        "pf_run_seq": [lambda: pf_run_seq.plot(RUNS),
                       lambda: pf_run_seq.plot_breakdown(BREAKDOWN_N, RUNS)],
        "gsf_run_seq": [lambda: gsf_run_seq.plot(RUNS)],
        "power": [lambda: pf_power.plot(POWER_T_RUN),
                  lambda: gsf_power.plot(POWER_T_RUN)],
        "mpc": [lambda: mpc_run_seq.plot(MPC_RUNS)],
        "frontier": [
            lambda: bioreactor_performance_pf.plot(PF_FRONTIER_LOG2),
            lambda: bioreactor_performance_gsf.plot(GSF_FRONTIER_LOG2)],
        "openloop": [ss2ss.plot, step_tests.plot,
                     batch_production_growth.plot, no_noise.plot,
                     with_noise.plot,
                     lambda: performance_vs_control_period.plot(*PERF_VS_CP)],
    }
    for leg in legs:
        for make in makers.get(leg, []):
            make()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("legs", nargs="*", choices=LEGS)
    ap.add_argument("--out", default=_common.ARTIFACT,
                    help="where to write the artifact (default: %(default)s);"
                         " it starts from the committed one")
    ap.add_argument("--figures", action="store_true",
                    help="draw the named legs' figures from the jar instead")
    args = ap.parse_args(argv)
    legs = args.legs or list(LEGS)
    if args.figures:
        figures(legs)
        return 0
    art = Artifact(_common.ARTIFACT, args.out, card_info())
    for leg in legs:
        t0 = time.perf_counter()
        print(f"[campaign] {leg} ...", flush=True)
        LEG_FNS[leg](art)
        entry = art.data["legs"][leg]
        entry["status"] = "done"
        entry["seconds"] = time.perf_counter() - t0
        art.write()
        print(f"[campaign] {leg}: done in {entry['seconds']:.1f} s -> "
              f"{args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
