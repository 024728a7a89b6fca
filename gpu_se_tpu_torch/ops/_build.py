"""Build ``csrc/*.cu`` with nvcc into one shared library, load it, and
check what the wrappers hand to it.

The library has a plain C interface and is bound with ``ctypes``; it
includes no PyTorch header, so ``nvcc`` takes seconds. Each ``*.cu``
compiles in its own ``nvcc`` process, all started together, then one
more links them. The output lands in ``gpu_se_tpu_torch/_build/`` under
a name keyed by a hash of the flags, the sources and the ``*.cuh``
headers they include, is built at first use and reused after. Only a
CUDA tensor reaches :func:`load_library`; a missing ``nvcc`` raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_H = ctypes.c_ulonglong      # a conditional node's handle
_SIGNATURES = {
    # the entries of a compact tile; the keys an expand block stages at most;
    # the threads of a merge-path block; the merged items one of them walks
    # in ends_merge_round and in cumsum_merge; the chunks a coarse_gather
    # block takes and the keys it stages at most
    "gst_compact_tile": [],
    "gst_expand_max_stage": [],
    "gst_merge_threads": [],
    "gst_ends_merge_thread_items": [],
    "gst_cumsum_merge_thread_items": [],
    "gst_coarse_chunks": [],
    "gst_coarse_stage": [],
    # n -> 64-bit scratch words (the ticket and one word per tile)
    "gst_compact_words": [_I],
    # ends, payload, rows, n, words, c_keys, c_payload, c_idx, count, stream
    "gst_compact": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P],
    # ends, n_blk, parts, nx, slot0, n_local, counts, acc, cols,
    # finalized, stream
    "gst_ends_merge_round": [_P, _I, _P, _I, _I, _I, _P, _P, _I, _P, _P],
    # cs, payload, rows, r, n, out, anc, stream
    "gst_cumsum_merge": [_P, _P, _I, _P, _I, _P, _P, _P],
    # ends, o, payload, rows, n, out, anc, stream
    "gst_coarse_gather": [_P, _P, _P, _I, _I, _P, _P, _P],
    # keys, L, payload, rows, src_idx, n, block, out, anc, stream
    "gst_expand": [_P, _I, _P, _I, _P, _I, _I, _P, _P, _P],
    # nx -> 32-bit words a sample of counter_draw takes
    "gst_counter_draw_words": [_I],
    # key, start, count, nx, fixed_nx, lanes_last, eps, u, stream
    "gst_counter_draw": [_P, ctypes.c_longlong, _I, _I, _I, _I, _P, _P, _P],
    # key, start, count, nx, words, stream
    "gst_counter_words": [_P, ctypes.c_longlong, _I, _I, _P, _P],
    # conditional nodes (graph_cond.cu): ready the set kernel; in the
    # capture on a stream: a handle (stream, default, out), its set kernel
    # (stream, handle, flag, counted), the node (stream, handle, type,
    # body out); in a body graph: a handle (graph, default, out), a child
    # (graph, last, child), a set kernel (graph, last, handle, flag,
    # counted, the recorder's ring or null), a node (graph, last, handle,
    # type, body out); the count
    "gst_cond_prepare": [],
    "gst_capture_handle": [_P, _U, _P],
    "gst_capture_set": [_P, _H, _P, _I],
    "gst_capture_cond": [_P, _H, _I, _P],
    "gst_graph_handle": [_P, _U, _P],
    "gst_graph_child": [_P, _P, _P],
    "gst_graph_set": [_P, _P, _H, _P, _I, _P],
    "gst_graph_cond": [_P, _P, _H, _I, _P],
    "gst_cond_count": [_P],
    "gst_cond_count_reset": [],
    # the span recorder's stamp (trace.cu): ring, tag, stream
    "gst_stamp": [_P, _H, _P],
}


def sources() -> list[pathlib.Path]:
    """The translation units: every ``csrc/*.cu``."""
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[pathlib.Path]:
    """The shared headers the sources include: every ``csrc/*.cuh``."""
    return sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the CUDA "
        "kernels of gpu_se_tpu_torch cannot be built")


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgst_kernels_{h.hexdigest()[:16]}.so"


def commands(nvcc: str, out: str, obj_dir: str):
    """``(compiles, link)``: one ``nvcc -c`` per source into ``obj_dir``
    (the headers found through ``-I csrc``), then the link into ``out``."""
    objs = [os.path.join(obj_dir, src.stem + ".o") for src in sources()]
    compiles = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", obj]
                for src, obj in zip(sources(), objs)]
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", out, *objs]
    return compiles, link


def _run_all(cmds) -> None:
    """Run the commands side by side; raise with the output of the first
    that fails."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    failed = None
    for cmd, proc in zip(cmds, procs):
        output, _ = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, output)
    if failed is not None:
        cmd, rc, output = failed
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{output}")


def build() -> pathlib.Path:
    """Compile the sources unless the library for their hash exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build to a private name and rename, so concurrent builds never
    # load a half-written file
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = os.path.join(tmp, "lib.so")
        compiles, link = commands(_nvcc(), lib, tmp)
        _run_all(compiles)
        _run_all([link])
        os.replace(lib, out)
    return out


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built if needed, with every
    function's argument and return types declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


# ----------------------------------------------------------------------
# what every wrapper checks before a launch
# ----------------------------------------------------------------------
def check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
          device: torch.device) -> None:
    """Raise unless ``t`` has ``dtype``, ``ndim`` dims, lies on ``device``
    and is contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-d, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def launch_check(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one
    (take the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
