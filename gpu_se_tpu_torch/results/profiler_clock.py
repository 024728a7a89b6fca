"""How far ``torch.profiler``'s device times drift from the host's clock,
and which ranges assign a timed call's device ops to it.

``chip_smoke.device_ms`` marks each timed call with a ``record_function``
range and adds up the device ops that belong to it. The profiler records
that range twice: on the host, from the call's start to the end of its
synchronise, and on the device, from the first to the last op launched
under it. The device's times are mapped onto the host's clock, so an op
lies in its call's host range only while the two clocks agree.

For a hand-written kernel (``cumsum_merge``, one launch a call, through
ctypes) and its plain version (``cumsum_merge_plain``, seven PyTorch ops)
at 2^20 slots, each profiled for ``--sessions`` sessions of ``--calls``
synchronised calls, this prints per session:

- ``host_whole``: the calls whose host range holds exactly as many ops
  as a call launches;
- ``device_whole``: the same by the call's range on the device, the
  assignment ``device_ms`` makes;
- ``offset_us``: the least and the most of (device range's start − host
  range's start) over the session's calls.

Usage, on a host with a CUDA card::

    python -m gpu_se_tpu_torch.results.profiler_clock

prints the card's ``nvidia-smi`` name and power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from gpu_se_tpu_torch.ops import resample_pallas3 as rp3

MARK = "profiler_clock call"
N = 2**20


def session(fn, calls: int) -> dict:
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            with record_function(MARK):
                fn()
                torch.cuda.synchronize()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.events()
    host = sorted((e.time_range.start, e.time_range.end) for e in events
                  if e.name == MARK and e.device_type == cpu)
    device = sorted((e.time_range.start, e.time_range.end) for e in events
                    if e.name == MARK and e.device_type == cuda)
    starts = [e.time_range.start for e in events
              if e.device_type == cuda and e.name != MARK]
    per_call = len(starts) // calls

    def whole(ranges):
        return sum(sum(s <= t <= e for t in starts) == per_call
                   for s, e in ranges)

    offsets = [d[0] - h[0] for d, h in zip(device, host)]
    return {"ops": len(starts), "host_whole": whole(host),
            "device_whole": whole(device),
            "offset_us": [min(offsets), max(offsets)] if offsets else None}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sessions", type=int, default=5)
    ap.add_argument("--calls", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    w = torch.softmax(torch.randn(N, device="cuda", generator=gen), 0)
    r = torch.rand((), device="cuda", generator=gen)
    cs = rp3.normalized_cumsum(w, r)
    payload = torch.randn(5, N, device="cuda", generator=gen)
    fns = {"cumsum_merge": lambda: rp3.cumsum_merge(cs, payload, r),
           "cumsum_merge_plain": lambda: rp3.cumsum_merge_plain(cs, payload,
                                                                r)}
    out = {"calls": args.calls}
    for name, fn in fns.items():
        out[name] = [session(fn, args.calls) for _ in range(args.sessions)]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
