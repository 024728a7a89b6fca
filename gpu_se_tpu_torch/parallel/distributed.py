"""Multi-process start-up.

Counterpart of ``gpu_se_tpu/parallel/distributed.py``. The reference
starts ``jax.distributed``; here :func:`initialize_distributed` starts
``torch.distributed``'s default group, one process per rank, and
:func:`global_mesh` lays the particle axis over all of it.

The backend is the caller's, or follows the machine: NCCL where there is
a card, gloo where there is none. One is never swapped for the other:
NCCL refuses two ranks on one card, so such a run asks for gloo itself
(the collectives then copy device tensors through the host,
``parallel/_comm.py``).
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from gpu_se_tpu_torch.parallel.mesh import Mesh, make_mesh

DEFAULT_TIMEOUT_S = 300.0


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           backend: str | None = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Start the default process group if the call or the environment
    asks for more than one process; return whether it did.

    With no arguments and neither ``MASTER_ADDR`` nor ``WORLD_SIZE`` set,
    this is a single-process run: nothing happens and the result is
    ``False``. ``coordinator_address`` is ``host:port`` (or a
    ``tcp://`` URL) of rank 0's store; without it the group starts from
    the environment (``env://``). ``backend`` defaults to NCCL when a
    card is available, gloo otherwise.
    Every collective of the group gives up after ``timeout_s``.
    """
    env_says_multi = any(os.environ.get(k)
                         for k in ("MASTER_ADDR", "WORLD_SIZE"))
    if (coordinator_address is None and num_processes is None
            and not env_says_multi):
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def global_mesh(device=None) -> Mesh:
    """This rank's mesh over every rank of the default group (a mesh of
    one when no group was started)."""
    return make_mesh(device=device)
