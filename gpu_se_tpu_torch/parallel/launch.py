"""Run one function in W fresh processes that form a gloo process group.

:func:`run_group` spawns ``world_size`` processes, starts the default
gloo group in each (gloo serves the CPU, and two ranks on one card,
which NCCL refuses) through :func:`~gpu_se_tpu_torch.parallel.distributed.
initialize_distributed` at a TCP address on this host, calls ``fn(*args)``
in each and returns their results in rank order. ``fn`` must be
importable (defined at a module's top level) and its result picklable.

A rank that hangs cannot hold its caller: every collective gives up
after ``timeout_s``, and the caller stops waiting at the same deadline,
kills every rank and raises. A rank that raises makes the call raise at
once with its traceback. Each rank runs with one CPU thread.
"""
from __future__ import annotations

import multiprocessing
import queue
import socket
import time
import traceback

DEFAULT_TIMEOUT_S = 120.0


def free_port() -> int:
    """A TCP port that was free on this host a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world_size, port, timeout_s, tasks, results):
    try:
        fn, args = tasks.get(timeout=timeout_s)
        import torch
        import torch.distributed as dist

        from gpu_se_tpu_torch.parallel.distributed import (
            initialize_distributed,
        )

        torch.set_num_threads(1)
        initialize_distributed(f"127.0.0.1:{port}", world_size, rank,
                               backend="gloo", timeout_s=timeout_s)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def run_group(fn, world_size: int, *args,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """``[fn(*args) on rank 0, ..., on rank world_size - 1]``, each in its
    own spawned process of a ``world_size``-rank gloo group.
    Raises ``RuntimeError`` if a rank fails, ``TimeoutError`` if the
    ranks are not all done within ``timeout_s``."""
    ctx = multiprocessing.get_context("spawn")
    tasks, results = ctx.Queue(), ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(rank, world_size, port, timeout_s, tasks,
                               results))
             for rank in range(world_size)]
    # the function and its arguments go through a queue, written by a
    # thread of this process: through the start pipe, each start would
    # wait for its rank to import them before the next rank could start
    for p in procs:
        p.start()
        tasks.put((fn, args))
    done = {}
    deadline = time.monotonic() + timeout_s
    finished = False
    try:
        # drain the queue before joining: a rank blocks on exit until its
        # result is read
        while len(done) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"ranks {sorted(set(range(world_size)) - set(done))} "
                    f"not done after {timeout_s} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"ranks {dead} died (exit codes "
                                       f"{[procs[r].exitcode for r in dead]})")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n"
                                   f"{out}")
            done[rank] = out
        finished = True
    finally:
        for p in procs:
            if finished:
                p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join()
    return [done[r] for r in range(world_size)]
