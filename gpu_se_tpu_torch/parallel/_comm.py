"""The collectives of the sharded protocols, over a :class:`Mesh`.

What ``shard_map`` gave the reference (its axis index and size are the
mesh's ``rank`` and ``size``): an all-gather, sum and min reductions, a
broadcast, the ``ppermute`` ring
of ``gpu_se_tpu/parallel/sharded.py:146-148`` (rank ``s`` sends to
``s + 1``, so after ``k`` rounds it holds block ``(s - k) mod W``) as one
``batch_isend_irecv`` a round, and a ragged all-to-all.

On a mesh of one rank every collective is the identity and launches
nothing: the protocols' degenerate case, not a fallback.

The ragged all-to-all is ``all_to_all_single``, which takes its split
sizes as Python ints: the protocols read their ``(W, W)`` sizes matrix
to the host once per step for it (one device-to-host copy and its
synchronise).

Transport: under gloo, a device tensor is copied to the host, exchanged
there and copied back (gloo moves host memory only). That is the only
way two ranks can share one card, which NCCL refuses; the compute stays
on the card. Under NCCL tensors go as they are.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from gpu_se_tpu_torch.parallel.mesh import Mesh


def _host(mesh: Mesh, t: torch.Tensor) -> bool:
    """Whether ``t`` goes through the host: gloo and a device tensor."""
    return t.device.type != "cpu" and mesh.backend == "gloo"


def _out(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` as the collective takes it: contiguous, on the host under
    gloo."""
    t = t.contiguous()
    return t.cpu() if _host(mesh, t) else t


def all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``(W, *t.shape)``: every rank's ``t`` in rank order."""
    if mesh.size == 1:
        return t[None]
    src = _out(mesh, t)
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.stack(parts).to(t.device)


def _reduce(mesh: Mesh, t: torch.Tensor, op) -> torch.Tensor:
    if mesh.size == 1:
        return t
    buf = _out(mesh, t).clone()
    dist.all_reduce(buf, op=op, group=mesh.group)
    return buf.to(t.device)


def psum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, on every rank."""
    return _reduce(mesh, t, dist.ReduceOp.SUM)


def pmin(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The minimum of ``t`` over the ranks, on every rank."""
    return _reduce(mesh, t, dist.ReduceOp.MIN)


def broadcast(mesh: Mesh, t: torch.Tensor, src: int) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank: a copy, so every bit arrives
    as sent (``-0.0`` stays ``-0.0``, a NaN touches nothing else)."""
    if mesh.size == 1:
        return t
    if mesh.rank == src:
        buf = _out(mesh, t)
    else:
        buf = torch.empty(t.shape, dtype=t.dtype,
                          device="cpu" if _host(mesh, t) else t.device)
    dist.broadcast(buf, src=mesh.global_rank(src), group=mesh.group)
    return t if mesh.rank == src else buf.to(t.device)


def ring_shift(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """One ``ppermute`` round: send ``t`` to rank ``s + 1``, return what
    rank ``s - 1`` sent (mod W)."""
    if mesh.size == 1:
        return t
    src = _out(mesh, t)
    buf = torch.empty_like(src)
    nxt = mesh.global_rank((mesh.rank + 1) % mesh.size)
    prv = mesh.global_rank((mesh.rank - 1) % mesh.size)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, src, nxt, group=mesh.group),
        dist.P2POp(dist.irecv, buf, prv, group=mesh.group)])
    for req in reqs:
        req.wait()
    return buf.to(t.device)


def all_to_all(mesh: Mesh, send: torch.Tensor, send_sizes: list[int],
               recv_sizes: list[int]) -> torch.Tensor:
    """Ragged all-to-all along dim 0: rows ``send[sum(send_sizes[:d]) :
    ... + send_sizes[d]]`` go to rank ``d``; the result holds what each
    rank sent here, in rank order, ``sum(recv_sizes)`` rows."""
    if mesh.size == 1:
        return send
    src = _out(mesh, send)
    out = torch.empty((sum(recv_sizes),) + tuple(send.shape[1:]),
                      dtype=send.dtype, device=src.device)
    dist.all_to_all_single(out, src, recv_sizes, send_sizes,
                           group=mesh.group)
    return out.to(send.device)
