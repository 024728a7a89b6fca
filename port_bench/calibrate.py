"""Readings for the comparison's limits, many runs in one process.

    python3 -m port_bench.calibrate --workload <cell> --seeds 1,2,3 \
        --seconds 3 --modes none,reduced,unchanged,half_batch,altered

runs the cell once per seed and mode (``none``: the program as it
stands; ``reduced``: the control of ``run.py``; ``twin``, closed-loop
cells only: the program's estimates replaced by a second float64
reference filter on its own stream, the witness of how far two sound
filters part; the others a fault of ``faults.py`` planted under the
timed path) on the card and prints one JSON line a run: the mode, the
seed and every number compared. The lower reading of a number is the
largest over sound runs, the upper the smallest over the control's;
``limits/<cell>.json`` records both beside the limit set between them.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    from port_bench import run as brun

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--modes", default="none")
    args = p.parse_args(argv)
    brun._caches()
    import torch

    from port_bench import faults, manifest
    from port_bench.session import Session

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = manifest.cell(args.workload)
    if "twin" in args.modes.split(",") and \
            cell.traffic["kind"] != "closed_loop":
        print("twin is a mode of the closed-loop cells", file=sys.stderr)
        return 2
    for mode in args.modes.split(","):
        control = mode if mode in ("reduced", "twin") else "none"
        fault = mode if mode in faults.FAULTS else "none"
        for seed in (int(v) for v in args.seeds.split(",")):
            s = Session(cell=cell, seed=seed, seconds=args.seconds,
                        trace=False, device=torch.device("cuda", 0),
                        process_start=time.time(), control=control,
                        fault=fault)
            t0 = time.perf_counter()
            res = brun.execute(s)
            print(json.dumps({
                "mode": mode, "seed": seed, "attempted": res["attempted"],
                "failed": res["failed"],
                "seconds": time.perf_counter() - t0,
                "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                "compared": {k: v["value"]
                             for k, v in res["compared"].items()}}),
                flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
