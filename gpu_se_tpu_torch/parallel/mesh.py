"""The particle axis over the ranks of a ``torch.distributed`` group.

Counterpart of ``gpu_se_tpu/parallel/mesh.py``. The reference's one
parallel axis is the particle (or Gaussian-bank, or scenario) axis; here
it runs over the ranks of a process group, one process per device, each
holding a contiguous slice of every sharded array. A :class:`Mesh` is
this process's view of that axis: the group, its size, this rank, and
the device this rank computes on.

The reference's ``particle_sharding`` and ``replicated`` are shardings
that ``jax.device_put`` applies; here they are the two placements
themselves: :func:`particle_sharding` gives this rank its slice of a
global array, :func:`replicated` the whole array, each on the mesh's
device.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

PARTICLE_AXIS = "particles"     # the reference's name of the mesh axis


@dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-d mesh over the particle axis.

    Attributes
    ----------
    size, rank : int
        Ranks on the axis, and this process's place on it.
    device : torch.device
        Where this rank's slices live and its work runs.
    group : process group or None
        The ``torch.distributed`` group the collectives run over; ``None``
        for a mesh of one rank, whose collectives are the identity.
    """

    size: int
    rank: int
    device: torch.device
    group: object = None

    def global_rank(self, rank: int) -> int:
        """The rank in the default group of this mesh's ``rank``."""
        if self.group is None or self.group is dist.group.WORLD:
            return rank
        return dist.get_global_rank(self.group, rank)

    @property
    def backend(self) -> str | None:
        return None if self.group is None else dist.get_backend(self.group)


def _default_device(device, rank: int) -> torch.device:
    """``device`` if given, else the card of this rank's local index
    (``LOCAL_RANK``, or the rank), modulo the cards there are: two ranks
    of one host with one card share it."""
    if device is not None:
        return torch.device(device)
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def make_mesh(n_devices: int | None = None, group=None,
              device=None) -> Mesh:
    """This rank's :class:`Mesh` over ``group`` (default: the initialized
    default group, else a mesh of this process alone).

    ``n_devices``, where given, must be the group's size, or 1: a mesh of
    this process alone whatever the group. ``device`` defaults to this
    rank's card (:func:`_default_device`); the CPU must be asked for.
    """
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None or n_devices == 1:
        if n_devices not in (None, 1):
            raise ValueError(
                f"a mesh of {n_devices} ranks needs a process group of that "
                f"size: call initialize_distributed first")
        return Mesh(1, 0, _default_device(device, 0), None)
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"n_devices={n_devices} but the group has {size} "
                         f"ranks")
    return Mesh(size, rank, _default_device(device, rank), group)


def _tensor(x) -> torch.Tensor:
    """``x`` if a tensor, else a tensor copy of the array."""
    return x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))


def particle_sharding(mesh: Mesh, x, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous slice of the global ``x`` (a tensor or a
    numpy array) along ``dim``, on the mesh's device; ``x.shape[dim]``
    must divide evenly over the ranks."""
    x = _tensor(x)
    n = x.shape[dim]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split over {mesh.size} ranks")
    n_local = n // mesh.size
    return x.narrow(dim, mesh.rank * n_local, n_local).contiguous().to(
        mesh.device)


def replicated(mesh: Mesh, x) -> torch.Tensor:
    """The whole of ``x`` (a tensor or a numpy array) on the mesh's
    device."""
    return _tensor(x).to(mesh.device)
