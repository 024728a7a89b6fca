"""What the ``counter_draw`` kernels compile to, the issue-rate bound that
follows, and the time of each of the kernel's design choices.

SASS: compiles ``csrc/counter_draw.cu`` alone with the library's flags
(``ops/_build.NVCC_FLAGS``) and ``-Xptxas -v`` and reads each kernel's
registers, stack frame and spills, then counts the SASS instructions of
each kernel in the built library (``cuobjdump -sass``, NOPs left out) by
opcode. A kernel's
issue floor is the instructions before its first store that no forward
conditional branch can skip (the Philox rounds and Box–Muller
transforms every thread runs, without ``sqrtf``'s slow path): each warp
of a launch issues at least these. The issue bound of a draw is its
launch's warps times that floor over the card's issue rate, four
warp-instructions a cycle on each SM at ``nvidia-smi``'s
``clocks.max.sm``; integer instructions issue at half that rate and
conversions and ``MUFU`` at an eighth, so the bound is a least time, not
a prediction.

Design choices: each variant is the source with one choice undone by a
text substitution (:data:`VARIANTS`), built alone into a library of its
own and timed in a process of its own at the main paths' two draws (a
rank's 2^20 samples, rows, and the GSUKF's 2^18 x 11, lanes-last; nx =
5) by the kernel's device time under ``torch.profiler``, in turns (the
variants, then again in reverse order); each is checked against
``counter_draw_plain`` first (uniforms bit-equal, normals within
``NORMAL_ATOL``). No variant is in the tree: this module makes them.

Usage, on a host with a CUDA card and the CUDA toolkit::

    python -m gpu_se_tpu_torch.results.counter_draw_study

prints the card's ``nvidia-smi`` name and power limit, then one JSON
line: per kernel the ``ptxas`` reading and the instruction counts, the
issue bounds of the two draws, and each variant's device ms.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import torch

from gpu_se_tpu_torch.ops import _build
from gpu_se_tpu_torch.ops import counter_draw as cd

SOURCE = _build.CSRC / "counter_draw.cu"
NX = 5
# the main paths' draws: (name, kernel, samples, lanes_last)
DRAWS = (("rows 2^20", "draw_fixed<5, rows>", 2**20, False),
         ("lanes-last 2^18 x 11", "draw_fixed<5, lanes-last>", 2**18 * 11,
          True))
ISSUE_PER_SM_CYCLE = 4       # warp schedulers an SM, one instruction each
KEY = (0x1234ABCD, 0x0F0E0D0C)
LAUNCHES = 50                # profiled launches a draw and variant
_STAGED = ("    __shared__ __align__(16) float tile[kTile * NX];",
           "out[k] = tile[k];\n    }\n")
_UNSTAGED = """    float* mine = eps + static_cast<size_t>(first) * NX;
    if (valid >= kSamples) {
#pragma unroll
      for (int k = 0; k < kSamples * NX; k += 4) {
        *reinterpret_cast<float4*>(mine + k) = make_float4(
            z[k / NX][k % NX], z[(k + 1) / NX][(k + 1) % NX],
            z[(k + 2) / NX][(k + 2) % NX], z[(k + 3) / NX][(k + 3) % NX]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kSamples * NX; ++k) {
        if (k / NX < valid) mine[k] = z[k / NX][k % NX];
      }
    }
"""
# each design choice undone: (name, [(old, new), ...]); a pair whose old
# text is a 2-tuple replaces the span from its first to its last string
VARIANTS = {
    "as built": [],
    "sincosf of float32(2 pi) u2": [(
        "sincospif(2.0f * unit(w2), &s, &c);",
        "sincosf(6.28318530717958647692f * unit(w2), &s, &c);")],
    "2 samples a thread": [("constexpr int kSamples = 4;",
                            "constexpr int kSamples = 2;")],
    "256 threads a block": [("constexpr int kThreads = 128;",
                             "constexpr int kThreads = 256;")],
    "rows stored from registers, 16 bytes a thread": [(_STAGED, _UNSTAGED)],
    "at most 32 registers (16 blocks an SM)": [(
        "__launch_bounds__(kThreads)\ndraw_fixed(",
        "__launch_bounds__(kThreads, 16)\ndraw_fixed(")],
}


# ----------------------------------------------------------------------
# SASS
# ----------------------------------------------------------------------
_LINE = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                   r"([A-Z0-9_.]+)([^;]*);")


def kernel_name(mangled: str) -> str | None:
    """``draw_fixed<NX, rows|lanes-last>``, ``draw_any<...>`` or
    ``draw_words`` of a mangled name; None for another symbol."""
    layout = {"0": "rows", "1": "lanes-last"}
    m = re.search(r"draw_fixedILi(\d+)ELb([01])E", mangled)
    if m:
        return f"draw_fixed<{m.group(1)}, {layout[m.group(2)]}>"
    m = re.search(r"draw_anyILb([01])E", mangled)
    if m:
        return f"draw_any<{layout[m.group(1)]}>"
    return "draw_words" if "draw_words" in mangled else None


def ptxas_info(text: str) -> dict:
    """Registers, stack frame, spill stores and loads and shared memory of
    each kernel in ``-Xptxas -v``'s output."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\S+?)'?(?: for '\w+')?$", line.strip())
        if m:
            name = kernel_name(m.group(1))
            if name:
                out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name].update(stack_bytes=int(m.group(1)),
                             spill_store_bytes=int(m.group(2)),
                             spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[name]["smem_bytes"] = int(m.group(1)) if m else 0
    return out


def issue_floor(instrs) -> int:
    """The instructions before the first store that no forward
    conditional branch can skip, of ``(address, predicated, opcode,
    operands)`` in address order."""
    head = []
    for ins in instrs:
        if ins[2].split(".")[0] in ("STG", "STS", "ST", "STL", "RED", "ATOM"):
            break
        head.append(ins)
    skipped = set()
    for addr, predicated, op, operands in head:
        target = re.match(r"\s*(0x[0-9a-f]+)", operands)
        if op.startswith("BRA") and predicated and target:
            skipped.update(range(addr + 1, int(target.group(1), 16)))
    return sum(1 for ins in head if ins[0] not in skipped)


def sass_counts(text: str) -> dict:
    """Per kernel of ``cuobjdump -sass``'s output: its instructions (NOPs
    left out), its opcodes' counts, most frequent first, and its
    :func:`issue_floor`."""
    kernels, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = kernel_name(m.group(1))
            if name:
                kernels[name] = []
            continue
        m = _LINE.match(line)
        if name and m and m.group(3) != "NOP":
            kernels[name].append((int(m.group(1), 16), bool(m.group(2)),
                                  m.group(3), m.group(4)))
    out = {}
    for k, instrs in kernels.items():
        ops = collections.Counter(op.split(".")[0] for _, _, op, _ in instrs)
        out[k] = {"instructions": len(instrs),
                  "issue_floor": issue_floor(instrs),
                  "opcodes": dict(ops.most_common())}
    return out


def source_constant(name: str, src: str | None = None) -> int:
    src = SOURCE.read_text() if src is None else src
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def launched_warps(samples: int) -> int:
    """The warps of a ``draw_fixed`` launch over ``samples``."""
    threads = source_constant("kThreads")
    tile = threads * source_constant("kSamples")
    return -(-samples // tile) * threads // 32


def issue_bound_ms(instructions: int, warps: int, sms: int,
                   clock_mhz: float) -> float:
    return (warps * instructions
            / (sms * ISSUE_PER_SM_CYCLE * clock_mhz * 1e6) * 1e3)


def _query(field: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _nvcc(args, tmp: str):
    return subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                           str(_build.CSRC), *args], capture_output=True,
                          text=True, check=True, cwd=tmp)


def sass_reading() -> dict:
    nvcc = _build._nvcc()
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(nvcc), "cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        built = _nvcc(["-Xptxas", "-v", "-c", str(SOURCE), "-o",
                       os.path.join(tmp, "counter_draw.o")], tmp)
    sass = subprocess.run([cuobjdump, "-sass", str(_build.build())],
                          capture_output=True, text=True, check=True).stdout
    info = ptxas_info(built.stdout + built.stderr)
    counts = sass_counts(sass)
    kernels = {k: {**info.get(k, {}), **counts[k]} for k in sorted(counts)}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = float(_query("clocks.max.sm").split()[0])
    draws = {}
    for name, kernel, samples, _ in DRAWS:
        warps = launched_warps(samples)
        floor = kernels[kernel]["issue_floor"]
        draws[name] = {"kernel": kernel, "samples": samples, "warps": warps,
                       "issue_floor_a_warp": floor,
                       "issue_bound_ms": issue_bound_ms(floor, warps, sms,
                                                        clock),
                       "bytes_bound_ms": cd.draw_bytes(samples, NX)
                       / 3.35e12 * 1e3}
    return {"sms": sms, "clock_max_sm_mhz": clock,
            "issue_per_sm_cycle": ISSUE_PER_SM_CYCLE, "draws": draws,
            "kernels": kernels}


# ----------------------------------------------------------------------
# design choices
# ----------------------------------------------------------------------
def variant_source(name: str) -> str:
    """The source with ``name``'s substitutions; raises where one does not
    match exactly once."""
    src = SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if isinstance(old, tuple):
            first, last = old
            if src.count(first) != 1 or src.count(last) != 1:
                raise ValueError(f"{name}: the span {first!r} .. {last!r} "
                                 f"is not in the source once")
            a = src.index(first)
            b = src.index(last, a) + len(last)
            src = src[:a] + new + src[b:]
        else:
            if src.count(old) != 1:
                raise ValueError(f"{name}: {old!r} is not in the source once")
            src = src.replace(old, new)
    return src


def time_variant(name: str) -> dict:
    """Build ``name`` alone, check it against the plain version and time
    both draws; device ms a launch."""
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    key = torch.tensor(KEY, dtype=torch.int64, device=dev)
    stream = _build.stream(dev)
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "counter_draw.cu")
        with open(src, "w") as fh:
            fh.write(variant_source(name))
        _nvcc(["-shared", src, "-o", "lib.so"], tmp)
        lib = ctypes.CDLL(os.path.join(tmp, "lib.so"))
    fn = lib.gst_counter_draw
    fn.argtypes = _build._SIGNATURES["gst_counter_draw"]
    out = {}
    for draw, _, count, lanes in DRAWS:
        eps = torch.empty((NX, count) if lanes else (count, NX), device=dev)
        u = torch.empty((count,), device=dev)
        args = (key.data_ptr(), 0, count, NX, NX, int(lanes), eps.data_ptr(),
                u.data_ptr(), stream)
        _build.launch_check(name, fn(*args))
        p_eps, p_u = cd.counter_draw_plain(key, 0, count, NX, lanes)
        err = float((eps - p_eps).abs().max())
        if not (torch.equal(u, p_u) and err <= cd.NORMAL_ATOL):
            raise AssertionError(f"{name} {draw}: uniforms or normals differ "
                                 f"({err})")
        for _ in range(5):
            fn(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(LAUNCHES):
                fn(*args)
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "draw_fixed" in e.name]
        if len(spans) < LAUNCHES // 2:
            raise AssertionError(f"{name} {draw}: the profiler saw "
                                 f"{len(spans)} of {LAUNCHES} launches")
        out[draw] = {"ms": sum(spans) / len(spans) / 1e3,
                     "launches_seen": len(spans), "max_abs_err": err}
    return out


def study() -> dict:
    """Each variant timed twice, in turns, each time in a process of its
    own."""
    names = list(VARIANTS)
    runs = collections.defaultdict(list)
    for name in names + names[::-1]:
        proc = subprocess.run(
            [sys.executable, "-m", "gpu_se_tpu_torch.results."
             "counter_draw_study", "--variant", name], capture_output=True,
            text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r} failed:\n{proc.stderr}")
        runs[name].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    return {name: {draw: {"ms": [r[draw]["ms"] for r in runs[name]],
                          "max_abs_err": runs[name][0][draw]["max_abs_err"]}
                   for draw, _, _, _ in DRAWS} for name in names}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", choices=list(VARIANTS),
                    help="build and time this variant alone (one process "
                         "of the study)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the counter_draw study runs on a CUDA card's host")
    if args.variant:
        print(json.dumps(time_variant(args.variant)), flush=True)
        return
    print(_query("name,power.limit"), flush=True)
    print(json.dumps({"source": str(SOURCE.relative_to(_build._PKG.parent)),
                      "flags": _build.NVCC_FLAGS, "sass": sass_reading(),
                      "variants": study()}), flush=True)


if __name__ == "__main__":
    main()
