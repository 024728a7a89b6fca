"""Conditional nodes of CUDA graphs: a WHILE loop and an IF that run on
the card inside a captured graph, with no read to the host.

The reference keeps data-dependent control flow inside one compiled
program: its QP solve is a ``lax.while_loop`` with a ``lax.cond`` around
the adaptive-rho refactorization (``gpu_se_tpu/control/qp.py:404-489``).
PyTorch captures only IF nodes (``torch.cond``), so the port inserts the
nodes itself (``csrc/graph_cond.cu``, CUDA 12.3 or later):

* :func:`while_loop` inserts a WHILE node into the graph being captured
  on the current stream. Its body runs the ``body`` items in order, then
  a one-thread kernel that sets the node's handle from ``flag`` (a 0-d
  bool on the card that the body wrote): the loop runs again while it is
  true. The handle is 1 at every launch of the graph, so the body runs
  at least once, as each launch starts the loop afresh;
* :func:`if_then` inserts the kernel that sets a new handle from
  ``flag`` and an IF node after it;
* a body item is a :class:`torch.cuda.CUDAGraph` captured beforehand with
  ``keep_graph=True`` (the node runs a clone of its raw graph: its
  kernels, at the addresses it was captured with, so the caller keeps the
  graph, its memory pool and the tensors it reads alive), or an
  :class:`If` (a nested IF node and its set kernel). A kept graph that
  itself holds a conditional node is refused as a child (CUDA error 801
  on the H100 with CUDA 12.8): nest with :class:`If` instead.

Every WHILE iteration adds one to a count on the card
(:func:`iterations`, :func:`reset_iterations`: each reads or writes the
card, so call them outside a run). There is no plain version: a flag on
the CPU raises, and so does a call outside a capture. The host-driven
loop that does the same work from Python lives with its caller
(``control/qp.py``).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Sequence, Union

import torch

from gpu_se_tpu_torch.ops import _build

IF, WHILE = 0, 1

_prepared: set = set()


@dataclass(frozen=True, eq=False)
class If:
    """A nested IF node: ``body`` runs when ``flag`` is true."""

    flag: torch.Tensor
    body: tuple


Item = Union[torch.cuda.CUDAGraph, If]


def _check_flag(flag: torch.Tensor) -> None:
    if not isinstance(flag, torch.Tensor) or flag.dtype != torch.bool \
            or flag.dim() != 0:
        raise TypeError("graph_cond: a flag is a 0-d torch.bool tensor")
    if flag.device.type != "cuda":
        raise ValueError(f"graph_cond: flag on {flag.device}; conditional "
                         f"nodes run only on a CUDA card")


def _capturing(flag: torch.Tensor) -> int:
    """The current stream of the flag's card, which must be capturing."""
    _check_flag(flag)
    if not torch.cuda.is_current_stream_capturing():
        raise RuntimeError("graph_cond: a conditional node goes into a graph "
                           "being captured; no capture is underway")
    if flag.device.index not in _prepared:
        raise RuntimeError(f"graph_cond: prepare({flag.device}) first, "
                           f"outside the capture")
    return _build.stream(flag.device)


def _rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"graph_cond: {name} failed with CUDA error {rc}")


def prepare(device) -> None:
    """Build and load the library and ready its set kernel on ``device``;
    call outside any capture, before the first node."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"graph_cond: {device} is not a CUDA card")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device.index in _prepared:
        return
    lib = _build.load_library()
    with torch.cuda.device(device):
        _rc("prepare", lib.gst_cond_prepare())
    _prepared.add(device.index)


def _fill(lib, graph: int, items: Sequence[Item]):
    """Append ``items`` to the body ``graph``, in order; the last node."""
    last = ctypes.c_void_p(None)
    for item in items:
        if isinstance(item, If):
            _check_flag(item.flag)
            h = ctypes.c_ulonglong()
            _rc("handle", lib.gst_graph_handle(graph, 0, ctypes.byref(h)))
            _rc("set", lib.gst_graph_set(graph, ctypes.byref(last), h,
                                         item.flag.data_ptr(), 0))
            inner = ctypes.c_void_p()
            _rc("if", lib.gst_graph_cond(graph, ctypes.byref(last), h, IF,
                                         ctypes.byref(inner)))
            _fill(lib, inner.value, item.body)
        elif isinstance(item, torch.cuda.CUDAGraph):
            _rc("child", lib.gst_graph_child(graph, ctypes.byref(last),
                                             item.raw_cuda_graph()))
        else:
            raise TypeError(f"graph_cond: a body item is a kept CUDAGraph or "
                            f"an If, not {type(item).__name__}")
    return last


def while_loop(flag: torch.Tensor, body: Sequence[Item]) -> None:
    """Insert ``WHILE { body; set <- flag }`` into the capture underway on
    the current stream; the body runs once before ``flag`` is first
    read."""
    stream = _capturing(flag)
    lib = _build.load_library()
    h = ctypes.c_ulonglong()
    _rc("handle", lib.gst_capture_handle(stream, 1, ctypes.byref(h)))
    graph = ctypes.c_void_p()
    _rc("while", lib.gst_capture_cond(stream, h, WHILE, ctypes.byref(graph)))
    last = _fill(lib, graph.value, body)
    _rc("set", lib.gst_graph_set(graph.value, ctypes.byref(last), h,
                                 flag.data_ptr(), 1))


def if_then(flag: torch.Tensor, body: Sequence[Item]) -> None:
    """Insert ``IF (flag) { body }`` into the capture underway on the
    current stream."""
    stream = _capturing(flag)
    lib = _build.load_library()
    h = ctypes.c_ulonglong()
    _rc("handle", lib.gst_capture_handle(stream, 0, ctypes.byref(h)))
    _rc("set", lib.gst_capture_set(stream, h, flag.data_ptr(), 0))
    graph = ctypes.c_void_p()
    _rc("if", lib.gst_capture_cond(stream, h, IF, ctypes.byref(graph)))
    _fill(lib, graph.value, body)


def iterations(device) -> int:
    """WHILE iterations run on ``device`` since the last reset."""
    out = ctypes.c_ulonglong()
    with torch.cuda.device(torch.device(device)):
        _rc("count", _build.load_library().gst_cond_count(ctypes.byref(out)))
    return out.value


def reset_iterations(device) -> None:
    with torch.cuda.device(torch.device(device)):
        _rc("reset", _build.load_library().gst_cond_count_reset())
