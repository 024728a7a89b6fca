"""Filter and controller state checkpointing, by ``torch.save``.

Counterpart of ``gpu_se_tpu/utils/checkpoint.py`` (orbax there). Saves a
state (a dataclass, dict, tuple or list of tensors, ``torch.Generator``s
and plain values, nested) every few control steps and restores it on
restart. A generator is saved as its ``get_state()`` and restored into
the target's own generator, so a resumed run draws what an unbroken run
draws. Each step is one file ``<directory>/step_<step>.pt``, written to
a temporary file and moved into place by ``os.replace``; only the newest
``max_to_keep`` steps are kept.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Optional

import torch

_FILE = re.compile(r"^step_(\d+)\.pt$")


def _leaves(tree):
    """The leaves of ``tree`` in order: dataclass fields (those its
    constructor takes), dict entries by sorted key, sequence items."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            if f.init:
                yield from _leaves(getattr(tree, f.name))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for c in tree:
            yield from _leaves(c)
    else:
        yield tree


def _rebuild(tree, leaves):
    """``tree``'s structure with the next of ``leaves`` at each leaf."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), leaves)
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        built = [_rebuild(c, leaves) for c in tree]
        if hasattr(tree, "_fields"):          # a namedtuple
            return type(tree)(*built)
        return type(tree)(built)
    return next(leaves)


def _saved(leaf):
    if isinstance(leaf, torch.Generator):
        return {"generator": leaf.get_state()}
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu()
    return leaf


def _restored(saved, target, k):
    """Leaf ``k`` of the checkpoint on ``target``'s device and dtype; a
    generator's state goes into ``target`` itself."""
    if isinstance(target, torch.Generator):
        target.set_state(saved["generator"])
        return target
    if isinstance(target, torch.Tensor):
        if tuple(saved.shape) != tuple(target.shape):
            raise ValueError(f"leaf {k}: saved shape {tuple(saved.shape)}, "
                             f"target {tuple(target.shape)}")
        return saved.to(device=target.device, dtype=target.dtype)
    return saved


class StateCheckpointer:
    """Rolling checkpointer for nested states of tensors and generators."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self._dir = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self._dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"step_{step}.pt")

    def steps(self) -> list[int]:
        """The saved steps, oldest first."""
        return sorted(int(m.group(1)) for m in map(_FILE.match,
                                                   os.listdir(self._dir)) if m)

    def save(self, step: int, state: Any):
        leaves = [_saved(leaf) for leaf in _leaves(state)]
        tmp = self._path(step) + ".tmp"
        torch.save(leaves, tmp)
        os.replace(tmp, self._path(step))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, target: Any, step: Optional[int] = None) -> Any:
        """Restore into the structure of ``target``: its tensors give the
        device and dtype, its generators take the saved states."""
        step = self.latest_step() if step is None else step
        if step is None or not os.path.exists(self._path(step)):
            raise FileNotFoundError(f"no checkpoint of step {step} under "
                                    f"{self._dir}")
        saved = torch.load(self._path(step), weights_only=True)
        targets = list(_leaves(target))
        if len(saved) != len(targets):
            raise ValueError(f"checkpoint has {len(saved)} leaves, the "
                             f"target {len(targets)}")
        return _rebuild(target, iter(
            _restored(s, t, k) for k, (s, t) in enumerate(zip(saved, targets))))

    def close(self):
        """Nothing to release: every save is complete when it returns."""
