"""A stand-in for the card's side of ``gpu_se_tpu_torch/graphs.py``, for
the CPU tests of graphed functions.

A CUDA graph exists only on the card. The :func:`stand_in` fixture
replaces the helper's card side (``graphs.on_card``, ``warm_up``,
``capture``) by a graph that keeps the captured outputs, as a CUDA graph
keeps its tensors' addresses, and rewrites them in place at each replay
by running the function again on the static inputs; its capture draws
nothing from the generators, as a CUDA graph's capture does not advance
them. So the helper's own logic runs as on the card: keys, static
buffers, inputs copied in, outputs handed out, constants and generators
held, launch counts moved from the capture to the replays.
"""
import pytest

from gpu_se_tpu_torch import graphs


def _tensors(tree) -> list:
    out = []
    graphs._map_tensors(tree, out.append)
    return out


class StandInGraph:
    """Replays by running ``fn`` on the static inputs and writing each
    output into the tensor the capture returned."""

    def __init__(self, fn, args, kwargs, out):
        self.fn, self.args, self.kwargs, self.out = fn, args, kwargs, out

    def replay(self):
        # a replay runs no Python: the wrappers' counts stay as they are
        counts = [k.launches for k in graphs.KERNELS]
        fresh = self.fn(*self.args, **self.kwargs)
        for k, c in zip(graphs.KERNELS, counts):
            k.launches = c
        for o, f in zip(_tensors(self.out), _tensors(fresh)):
            o.copy_(f)


def stand_in_capture(fn, args, kwargs, gens, dev):
    saved = [g.get_state() for g in gens]
    out = fn(*args, **kwargs)
    for g, s in zip(gens, saved):
        g.set_state(s)
    return StandInGraph(fn, args, kwargs, out), out, 0


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(graphs, "on_card", lambda dev: True)
    monkeypatch.setattr(graphs, "warm_up",
                        lambda fn, args, kwargs, dev: fn(*args, **kwargs))
    monkeypatch.setattr(graphs, "capture", stand_in_capture)
