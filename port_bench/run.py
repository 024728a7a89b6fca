"""Run one cell of the benchmark once.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell
asks for. The last line of standard output is the result (JSON: the
end-to-end metrics with ``--trace 0``, the per-layer metrics with
``--trace 1``); the lines before it on standard error say what the run
saw, and the last of them are the numbers compared, each with its
limit. Without a CUDA card the run exits with code 2 and prints no
result; it also exits without one if, once the window has closed, the
process holds a module of JAX or of the JAX package (compared by whole
top-level names).

``--control reduced`` runs the comparison's control: the reference put
in the program's place, its products from TF32 operands and its other
float32 work rounded to bfloat16; ``--fault`` plants one of
``faults.FAULTS`` under the timed path. Both are for the readings that
set the limits and for the tests.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gpu_se_tpu")


def process_start() -> float:
    """The epoch second this process started (from ``/proc``), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole (``gpu_se_tpu_torch`` is not ``gpu_se_tpu``)."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def _caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = ROOT / ".bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ["USE_FLAX"] = "0"


def parse(argv):
    from port_bench.faults import FAULTS

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("none", "reduced"),
                   default="none")
    p.add_argument("--fault", choices=FAULTS, default="none")
    return p.parse_args(argv)


def first_run() -> bool:
    """Whether the port's kernel library is not built yet: this run
    builds it."""
    build = ROOT / "gpu_se_tpu_torch" / "_build"
    return not (build.is_dir() and any(build.glob("libgst_kernels_*.so")))


def execute(session) -> dict:
    """Run the session's cell (the driver its traffic names), read the
    per-layer metrics, judge the comparison; returns the result line."""
    import torch

    from port_bench import card, faults, manifest

    cell = session.cell
    # every configuration states float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    on_card = session.device.type == "cuda"
    if on_card:
        session.say(f"card: {card.name_and_limit()}")
    driver = manifest.module("drivers", session.traffic["kind"])
    with faults.planted(session.fault):
        driver.run(session)
    session.say("set-up, seconds since the process started: " + ", ".join(
        f"{name} {t:.2f}" for name, t in session.marks))
    session.say(f"graph captures inside the window: "
                f"{session.captures_in_window}")
    session.say(f"first run in this checkout (builds): {session.first_run}")
    names = [m["name"] for m in
             (cell.per_layer if session.trace else cell.end_to_end)]
    units = {m["name"]: m["unit"] for m in cell.per_layer + cell.end_to_end}
    values = {}
    for name in names:
        v = session.end_to_end.get(name) if not session.trace else \
            manifest.metric_reader(name)(session)
        if v is not None:
            values[name] = {"value": float(v), "unit": units[name]}
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": 1, "memory_peak_bytes": int(session.memory_peak_bytes)}
    result = {"correct": False, "attempted": session.attempted,
              "failed": session.failed, "metrics": values, "device": device}
    if session.trace and session.trace_data:
        device["busy_s"] = session.trace_data["busy_s"]
        device["window_s"] = session.trace_data["window_s"]
        result["breakdown"] = session.trace_data["breakdown"]
    compared, correct = {}, bool(session.compared)
    for name, value in session.compared.items():
        limit = cell.limits.get(name, {}).get("limit")
        ok = limit is not None and value <= limit
        correct = correct and ok
        compared[name] = {"value": value, "limit": limit}
    result["correct"] = correct
    result["compared"] = compared
    for name, c in compared.items():
        session.say(f"compared {name}: {c['value']!r} (limit {c['limit']!r})")
    return result


def main(argv=None) -> int:
    start = process_start()
    args = parse(argv)
    _caches()
    sys.path.insert(0, str(ROOT))
    import torch

    from port_bench import manifest
    from port_bench.session import Session

    marks = [("torch", time.time() - start)]
    cell = manifest.cell(args.workload)
    chips = int(cell.entry.get("chips", 1))
    ok = torch.cuda.is_available() and torch.cuda.device_count() >= chips
    marks.append(("cuda", time.time() - start))
    if not ok:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    session = Session(cell=cell, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device=torch.device("cuda", 0),
                      process_start=start, control=args.control,
                      fault=args.fault, first_run=first_run(), marks=marks)
    result = execute(session)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded JAX or the JAX package: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
