"""CUDA graphs of the port's steps: its counterpart of ``jax.jit``.

The reference compiles each filter step into one program (``jax.jit`` of
the shells' methods, ``gpu_se_tpu/filters/particle.py:176-188``, of the
tiled step in ``bench.py`` and of the whole closed loop). On the card the
port captures such a step once as a CUDA graph and replays it:
:class:`Graphed` wraps a function of tensors, and a call

* on CPU tensors runs the function directly (the caller asked for the
  CPU);
* on the card, the first time a key is seen, runs the function eagerly on
  a side stream (the warm-up, whose result it returns), then captures it;
  later calls copy their input tensors into the graph's static buffers
  and replay it. A capture or a replay that fails raises: nothing falls
  back to eager dispatch.

The arguments are walked as a tree: tuples, lists, dicts and dataclasses
(field by field) are descended into, and each leaf is

* a tensor: an input, copied into its static buffer at every call;
* a ``torch.Generator``: registered with the graph
  (``CUDAGraph.register_generator_state``), so a replay draws what eager
  dispatch draws from the generator's state at the call and advances it
  as eager dispatch does; ``set_state`` between calls is honoured;
* a frozen dataclass (a ``GaussianSum``): a constant the graph reads at
  its tensors' addresses, as ``jax.jit`` bakes in a closed-over array.
  The cache entry keeps the object, so its memory cannot be reused; a
  call with another object (a dist assigned anew) captures anew;
* anything else (callables, numbers, flags, strings, ``None``): part of
  the key.

A key is the arguments' structure, every tensor's shape, strides, the
alignment of its first element, dtype and device (over another layout a
kernel may sum in another order; the static buffers and the copies
handed out are laid out as the tensors they stand for), every other
leaf's value, and ``key()`` of the caller (the resample route, for a
function that resamples): what makes ``jax.jit`` retrace. Another
generator or constant object under the same key replaces the entry,
which frees its graph and memory pool; the others live as long as the
:class:`Graphed` object (a filter shell's, a scan loop's).

A replay rewrites the graph's output tensors. With ``copy_out`` (the
default) a call hands out clones, so a tensor a caller holds keeps its
values after later calls, as a JAX array does; an output that is an input
passed through is handed back as the caller's own tensor, uncopied.

Inside :class:`disabled` every graphed function (or those it names)
runs eagerly, one op at a time, as the reference's do under
``jax.disable_jit()``: the eager side of a comparison.

A graphed function called while its card's current stream is capturing
(a graphed step that calls a graphed solve) runs inline: its ops join
the caller's capture, as a jitted function called inside ``jax.jit`` is
traced into its caller. Conditional nodes (``ops/graph_cond``) go into
whatever graph is being captured, so a step that holds a QP solve holds
its whole device loop.

The kernel wrappers (:data:`KERNELS`) count launches in Python, where
they enqueue: during a capture nothing reaches the card, so the counts a
capture adds are taken back, kept as the graph's launches, and added at
every replay. A launch inside a conditional node's body runs or not as
the card decides: such a body adds one to a count on the card
(:func:`count_on_card`), which :func:`settle_counts` folds into the
wrapper's count, so a count read after it is of launches that ran.

A value from the host (a Python float, a numpy array) that a graphed
call takes goes to the card through :func:`as_input`: staged in pinned
memory and copied without waiting for the card, where
``torch.as_tensor(v, device=card)`` copies from pageable memory and
synchronises.

Every call is a span of the recorder (``gpu_se_tpu_torch.trace``):
``graphed.<function>`` on the host, marked when its replay begins and
when it returns (so its copies in come before the first mark and its
hand-out after the second), with a child ``capture`` on a key's first
call; and on the card a device span from a stamp before the first input
copy (or the warm-up) to one after the last clone handed out. A call
inside a caller's capture captures its two stamps into the caller's
graph, so its span runs, nested in the caller's, at every replay. A
call's span carries the key part and the kernels its graph launches
(``(route, ((kernel, launches), ...))``; the route is None without
``key``).
"""
from __future__ import annotations

import dataclasses
import gc
import weakref
from typing import Any, Callable, Optional

import torch

from gpu_se_tpu_torch import trace
from gpu_se_tpu_torch.ops import counter_draw as _cdraw
from gpu_se_tpu_torch.ops import resample_coarse as _rc
from gpu_se_tpu_torch.ops import resample_pallas3 as _rp3
from gpu_se_tpu_torch.ops import resample_pallas4 as _rp4
from gpu_se_tpu_torch.ops import resample_pallas_block as _rpb

# every hand-written kernel's wrapper, each with a ``launches`` count
KERNELS = (_rp4.compact, _rp4.expand, _rpb.ends_merge_round,
           _rp3.cumsum_merge, _rc.coarse_gather, _cdraw.counter_draw)


_DISABLED: list = []     # the open ``disabled`` contexts' sets, or None
# owner -> (wrapper, launches a body run, int64 count); an entry goes
# with its owner
_CARD_COUNTS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def count_on_card(owner, wrapper, launches: int,
                  count: torch.Tensor) -> None:
    """Register ``count``, a 0-d int64 tensor on the card that a
    conditional body adds one to each time it runs, as ``launches``
    launches of ``wrapper``'s kernel a run, for as long as ``owner`` (the
    object that holds the body) lives."""
    _CARD_COUNTS[owner] = (wrapper, launches, count)


def settle_counts() -> None:
    """Add the runs counted on the card since the last call to their
    wrappers' ``launches`` and zero the counts: one read of the card
    (call it outside a run, before the counts are read or zeroed)."""
    entries = list(_CARD_COUNTS.values())
    if not entries:
        return
    runs = torch.stack([count for _, _, count in entries]).tolist()
    for (wrapper, launches, count), n in zip(entries, runs):
        wrapper.launches += launches * n
        count.zero_()


def fork(state):
    """A copy of a filter state (its tensors cloned, layouts kept) with a
    generator of its own in the same state: the input of an eager run
    held against a graphed run from ``state``."""
    gen = torch.Generator(device=state.generator.device)
    gen.set_state(state.generator.get_state())
    return dataclasses.replace(state, generator=gen, **{
        f.name: getattr(state, f.name).clone()
        for f in dataclasses.fields(state) if f.name != "generator"})


def as_input(v, device: torch.device) -> torch.Tensor:
    """``v`` as a float32 tensor on ``device``. A tensor already on the
    card is taken as it is; a host value bound for the card is converted
    on the host, staged in pinned memory and copied with
    ``non_blocking=True``, so the call does not wait for the card (the
    caching host allocator keeps the pinned block until the copy has
    run). On the CPU, ``torch.as_tensor(v, dtype=float32)``."""
    device = torch.device(device)
    if device.type != "cuda" or (isinstance(v, torch.Tensor)
                                 and v.device.type == "cuda"):
        return torch.as_tensor(v, dtype=torch.float32, device=device)
    host = torch.as_tensor(v, dtype=torch.float32, device="cpu")
    return host.pin_memory().to(device, non_blocking=True)


class disabled:
    """Context manager: inside it the given graphed functions, or every
    one if none is given, run eagerly."""

    def __init__(self, *graphed: "Graphed"):
        self.only = {id(g) for g in graphed} or None

    def __enter__(self):
        _DISABLED.append(self.only)

    def __exit__(self, *exc):
        _DISABLED.remove(self.only)


def is_disabled(g: "Graphed") -> bool:
    """Whether ``g`` runs eagerly: an open :class:`disabled` names it or
    names none."""
    return any(only is None or id(g) in only for only in _DISABLED)


def _is_const(x) -> bool:
    return (dataclasses.is_dataclass(x) and not isinstance(x, type)
            and x.__dataclass_params__.frozen)


def _flatten(tree, tensors: list, gens: list, consts: list):
    """The key part of ``tree``; its tensors, generators and constants are
    appended to the lists in walk order."""
    if isinstance(tree, torch.Tensor):
        tensors.append(tree)
        return ("T", tuple(tree.shape), tree.stride(), _alignment(tree),
                tree.dtype, tree.device)
    if isinstance(tree, torch.Generator):
        gens.append(tree)
        return ("G", tree.device)
    if _is_const(tree):
        consts.append(tree)
        return ("C", type(tree), tuple(
            (tuple(v.shape), v.dtype, v.device) if isinstance(v, torch.Tensor)
            else v for v in (getattr(tree, f.name)
                             for f in dataclasses.fields(tree))))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return ("D", type(tree), tuple(
            _flatten(getattr(tree, f.name), tensors, gens, consts)
            for f in dataclasses.fields(tree) if f.init))
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(_flatten(c, tensors, gens, consts)
                                  for c in tree))
    if isinstance(tree, dict):
        return (dict, tuple((k, _flatten(tree[k], tensors, gens, consts))
                            for k in sorted(tree)))
    return ("V", tree)


def _alignment(t: torch.Tensor) -> int:
    """The first element's offset in 16-byte units of its storage, in
    elements: kernels pick vectorized paths, and with them an order of
    summation, by it."""
    return (t.storage_offset() * t.element_size()) % 16 // t.element_size()


def _like(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` laid out as ``t`` is: its size, strides and
    alignment (``clone`` makes a strided view contiguous). A tensor with
    a zero stride (expanded) is copied contiguous."""
    if t.numel() == 0 or 0 in t.stride():
        return t.clone()
    extent = 1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
    align = _alignment(t)
    base = torch.empty(align + extent, dtype=t.dtype, device=t.device)
    return base.as_strided(t.shape, t.stride(), align).copy_(t)


def _map_tensors(tree, fn: Callable):
    """``tree`` rebuilt with ``fn`` of each tensor outside its constants
    (frozen dataclasses, kept as they are)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if _is_const(tree):
        return tree
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_tensors(getattr(tree, f.name), fn)
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, (tuple, list)):
        built = [_map_tensors(c, fn) for c in tree]
        if hasattr(tree, "_fields"):          # a namedtuple
            return type(tree)(*built)
        return type(tree)(built)
    if isinstance(tree, dict):
        # in :func:`_flatten`'s order
        return {k: _map_tensors(tree[k], fn) for k in sorted(tree)}
    return tree


def _substitute(tree, it):
    """``tree`` with its tensors replaced, in walk order, by ``it``'s."""
    return _map_tensors(tree, lambda _: next(it))


@dataclasses.dataclass
class Entry:
    """One captured graph: its static inputs, the generators and constants
    it was captured with, its output tree, the kernel launches of one
    replay, its memory pool's size and its route (the key part and the
    kernels one replay launches, by name: each call's span attribute)."""

    graph: torch.cuda.CUDAGraph
    static: list
    gens: list
    consts: list
    out: Any
    launches: dict
    pool_bytes: int
    route: tuple

    def holds(self, gens: list, consts: list) -> bool:
        return (len(gens) == len(self.gens)
                and all(a is b for a, b in zip(gens, self.gens))
                and all(a is b for a, b in zip(consts, self.consts)))


# ----------------------------------------------------------------------
# the card's side: the tests on the CPU put stand-ins in their place
# ----------------------------------------------------------------------
def on_card(dev: torch.device) -> bool:
    """Whether tensors on ``dev`` are graphed (CUDA) or run directly."""
    return dev.type == "cuda"


def warm_up(fn: Callable, args, kwargs, dev):
    """``fn`` run eagerly on a side stream; its result."""
    side = torch.cuda.Stream(device=dev)
    main = torch.cuda.current_stream(dev)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        out = fn(*args, **kwargs)
    main.wait_stream(side)
    # the outputs were allocated on the side stream and are used on the
    # caller's: the allocator waits for both before reusing them
    _map_tensors(out, lambda t: t.record_stream(main))
    return out


def capturing(dev: torch.device) -> bool:
    """Whether the current stream of the card ``dev`` is capturing."""
    return dev.type == "cuda" and torch.cuda.is_current_stream_capturing()


def capture(fn: Callable, args, kwargs, gens: list, dev,
            keep_graph: bool = False):
    """``(graph, outputs, pool bytes)``: ``fn`` captured with the
    generators ``gens`` registered; the pool's size is the card's reserved
    memory grown by the capture. With ``keep_graph`` the graph keeps its
    raw CUDA graph (``raw_cuda_graph()``), which a conditional node's body
    clones (``ops/graph_cond``), and is instantiated at its first replay.

    Only this thread's calls can spoil the capture (``thread_local``):
    another thread's CUDA calls (a process group's watchdog, a sampler)
    go on. The cyclic garbage collector is held off during it, so no
    finalizer of an earlier graph or stream runs inside the capture
    (``torch.cuda.graph`` collects once before it begins)."""
    graph = torch.cuda.CUDAGraph(keep_graph=keep_graph)
    for gen in gens:
        graph.register_generator_state(gen)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved(dev)
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = fn(*args, **kwargs)
    finally:
        if collecting:
            gc.enable()
    return graph, out, torch.cuda.memory_reserved(dev) - before


class Graphed:
    """``fn`` captured once per key as a CUDA graph on the card and
    replayed after (the module docstring says how arguments are read).

    Parameters
    ----------
    fn : callable
        A function of tensors; on the card it must not read the device
        from the host (a sync breaks the capture, which raises).
    key : callable, optional
        Returns a hashable part of the key read at every call (the
        resample route of ``filters/resampling.route``).
    copy_out : bool
        Hand out clones of the graph's outputs (default). Without it the
        outputs are the graph's own tensors, rewritten by the next call.
    warm : bool
        Run a key's first call eagerly before the capture (default).
        Without it the first call captures and replays: for a function
        that can run only inside a capture (one that inserts conditional
        nodes, ``ops/graph_cond``).
    """

    def __init__(self, fn: Callable, key: Optional[Callable] = None,
                 copy_out: bool = True, warm: bool = True):
        self.fn = self.__wrapped__ = fn
        self.key = key
        self.copy_out = copy_out
        self.warm = warm
        self.entries: dict = {}
        self.captures = 0
        self.replays = 0
        self.span_name = "graphed." + getattr(fn, "__name__", "fn")
        self.site = trace.site(self.span_name)

    def __call__(self, *args, **kwargs):
        span = trace.begin(self.span_name)
        try:
            return self._call(span, args, kwargs)
        finally:
            trace.end(span)

    def _call(self, span: int, args, kwargs):
        tensors, gens, consts = [], [], []
        spec = _flatten((args, kwargs), tensors, gens, consts)
        dev = tensors[0].device if tensors else None
        if is_disabled(self) or not tensors or not on_card(dev):
            trace.stamp(span, dev, trace.BEGIN)
            out = self.fn(*args, **kwargs)
            trace.stamp(span, dev, trace.END)
            return out
        if capturing(dev):
            # inside a caller's capture: the ops join it, and its
            # Graphed counts their launches at each of its replays
            trace.stamp_site(self.site, dev, trace.BEGIN)
            out = self.fn(*args, **kwargs)
            trace.stamp_site(self.site, dev, trace.END)
            return out
        part = self.key() if self.key is not None else None
        key = (spec, part)
        entry = self.entries.get(key)
        if entry is not None and not entry.holds(gens, consts):
            del self.entries[key]          # frees the graph and its pool
            entry = None
        trace.stamp(span, dev, trace.BEGIN)
        if entry is None:
            first = trace.begin("capture")
            out = None
            if self.warm:
                out = warm_up(self.fn, args, kwargs, dev)
            entry = self.entries[key] = self._capture(args, kwargs, tensors,
                                                      gens, consts, part)
            trace.end(first)
            if self.warm:
                trace.annotate(span, entry.route)
                trace.stamp(span, dev, trace.END)
                return out
        trace.annotate(span, entry.route)
        out = self._replay(entry, tensors, span)
        trace.stamp(span, dev, trace.END)
        return out

    def _capture(self, args, kwargs, tensors, gens, consts,
                 part) -> Entry:
        static = [_like(t) for t in tensors]
        s_args, s_kwargs = _substitute((args, kwargs), iter(static))
        counts = [k.launches for k in KERNELS]
        graph, out, pool = capture(self.fn, s_args, s_kwargs, gens,
                                   tensors[0].device)
        launches = {}
        for k, c in zip(KERNELS, counts):
            if k.launches != c:
                launches[k] = k.launches - c
                k.launches = c             # the capture launched nothing
        self.captures += 1
        kernels = tuple(sorted((k.__name__, n) for k, n in launches.items()))
        return Entry(graph, static, list(gens), list(consts), out, launches,
                     pool, (part, kernels))

    def _replay(self, entry: Entry, tensors: list, span: int):
        for s, t in zip(entry.static, tensors):
            s.copy_(t)
        trace.mark(span, 0)
        entry.graph.replay()
        trace.mark(span, 1)
        self.replays += 1
        for k, c in entry.launches.items():
            k.launches += c
        if not self.copy_out:
            return entry.out
        passed = {id(s): t for s, t in zip(entry.static, tensors)}
        return _map_tensors(entry.out,
                            lambda o: passed.get(id(o)) if id(o) in passed
                            else _like(o))

    def clear(self) -> None:
        """Drop every captured graph, its static buffers and its pool."""
        self.entries.clear()

    def pool_bytes(self) -> int:
        """The memory pools of the graphs held, bytes (the card's reserved
        memory grown by each capture)."""
        return sum(e.pool_bytes for e in self.entries.values())
