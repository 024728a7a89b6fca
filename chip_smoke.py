"""Smoke run of the PyTorch port (``gpu_se_tpu_torch``) on one CUDA card.

Phases, each of which raises on failure:

1. the card: ``nvidia-smi``'s name and power limit; no CUDA, no run;
2. build the kernels from ``gpu_se_tpu_torch/csrc`` with nvcc;
3. each kernel against its plain PyTorch version (``torch.equal`` on
   every output) for uniform, near-uniform and heavy-tailed weights at
   n = 4096, an odd or unaligned n and 2^20, and the ``ends`` merge fed
   four ascending blocks into four shards against one round; ``compact``
   and ``expand`` also on the edge cases of ``gpu_se_tpu_torch/rig.py``
   (all survive, one survivor, heavy tails; n from 1 to 2^24 around
   ``compact``'s tile; 1 to 30 rows; ``expand`` in chunks of 1 to 10000
   slots on compacted and on repeated keys), and ``compact`` 200 times in
   a row on one input at 2^20 and at 2^24 with the same bits every time
   (a race in its look-back would show as a rare wrong prefix), timed at
   both sizes; ``ends_merge_round`` and ``cumsum_merge`` also on their
   edge cases of ``rig`` (the same families; n from 1 to 2^24 around the
   merge path's 2048-item block; 1 to 32 columns, 1 to 8 rows) and
   ``ends_merge_round`` on ``rig``'s ring feeds (unequal source blocks
   and shards, blocks wholly below and above a shard, rounds over state
   that is already part-finalized), each round against the plain round;
   ``coarse_gather`` on its edge cases of ``rig`` (the same families; n
   from 128 to 2^24, the one survivor's last chunk holding every key
   from the survivor on; 1 to 8 rows). A watchdog ends the run if these
   cases hang. ``counter_draw`` (Philox, the sharded steps' per-rank
   noise) against its plain version at the main paths' draws (2^20
   samples a rank of the flat step, rows, from 0 and 2^20; 2^21
   lanes-last; 2^18 x 11 a rank of the GSUKF step, lanes-last, from 0
   and 2^18 x 11), an odd start and count, a range across the counter's
   32-bit carry, and every nx with an instantiation of its own (1 to 5)
   and two without (6, 7) in both layouts, from unaligned starts and for
   counts that fill no whole block or float4: the production kernel's
   uniforms bit-equal, the normals within ``NORMAL_ATOL``, the
   verification hook's words bit-equal; slices of 2^21 samples
   concatenated bit-equal to the whole draw; timed at a rank's
   2^20-sample draw, rows, and at the GSUKF's 2^18 x 11, lanes-last, each
   beside ``torch.randn`` plus ``torch.rand`` of the same shape.
   ``mixture_pdf`` (the filters' update density) bit-equal to
   ``GaussianSum.pdf_t`` on the card at the flat PF's and the GSUKF's
   column-major residuals (2^20 and 2^18 rows), bare and scaled, and on
   a 3 x 5 mixture (the same kernel: its sizes are read at run time);
   its log mode within ``LOG_ATOL``/``LOG_RTOL`` of the CPU's plain
   version, far points included (some must underflow ``pdf`` to 0);
   timed at both sizes on fresh inputs beside the einsum the port
   called before;
4. the CUDA tiled and flat steps against the committed reference step
   (``tests/data/torch_parity_step.npz``);
5. the tiled main path: the tiled particle-filter step of ``bench.py``'s
   rig at 2^20 particles as ``bench.py`` jits it, one CUDA graph replay a
   step (``particle_tiled.graphed_step``), one warm-up step (the
   capture's) and 50 chained steps timed with CUDA events; both of its
   kernels must have launched once per step. Then one step is checked against the same step through the
   plain resample, and each stage and each kernel is timed;
6. the flat main path: a ``ParticleFilter`` on the closed loop's
   configuration at 2^20 particles, two warm-ups and 50 chained steps
   under auto routing (compact + expand), then 10 chained steps
   under each of the ``ends``, ``v3``, ``pallas`` and ``coarse`` routes
   (the ends merge, the cumsum merge, the coarse search); each route's
   kernel must have launched once per step, and one step per route is
   checked against the plain route;
7. the router's other auto routes at full width: a ``(2^20, 8)``
   payload (cumsum merge), a 2^18 Gaussian bank through
   ``systematic_resample`` (ends merge) and ``systematic_resample_bank``
   (compact + expand); and the ``v3`` and ``pallas`` routes at 2^20 on
   weights without a finite sum (``rig.no_sum_weights``: all 0, a sum
   that overflows, a NaN), each equal to the CPU's result, one particle
   in every slot;
8. the merge and coarse kernels timed against their plain versions at
   the flat main path's inputs; ``ends_merge_round`` also at 8 columns
   there, at the router's 2^18 bank tree (30 columns), all three on the
   heavy edge case at 2^24 and ``coarse_gather`` also on the one-survivor
   and all-survive cases at 2^24 (a long key range against none), each
   time beside its bound and, at the flat path's input, beside the time
   of the one-thread-per-slot kernel each replaced;
9. the flat step's stage times and, per route, ``torch.profiler`` over
   chained steps (device ops per step, busy share, the kernels with most
   device time);
10. the v2 path: the flat PF step of ``scripts/bench_v2.py`` (predict,
    update, ``fused_systematic_resample_v2``, uniform weights) at 2^20
    in each of its five ``(window, block)`` geometries, one warm-up and
    10 chained steps each; ``compact`` and ``expand`` must launch once per
    step; then, as ``bench_v2.py`` jits it, the step as one graph replay
    (``graphs.Graphed``), 10 chained steps in each geometry bit-equal to
    the same step eager from the same state and generator state (one
    capture a geometry), timed both ways; one step must equal the plain
    route bit for bit, and ``expand`` is timed against its plain version
    at each block size;
11. the GSUKF path: ``GaussianSumUnscentedKalmanFilter.step`` at 2^18
    Gaussians on the bench rig, two warm-ups and 30 chained steps;
    ``compact`` and ``expand`` must launch once per step, the
    covariances must stay exactly symmetric, one step must equal the
    same step through the plain resample bit for bit; stage times and a
    ``torch.profiler`` busy share. Its fixture
    (``tests/data/torch_parity_gsukf.npz``) is checked in phase 4;
    (k) graphed steps (``gpu_se_tpu_torch/graphs.py``: a step captured
    once as a CUDA graph and replayed, the counterpart of ``jax.jit``):
    the tiled step at 2^20 (``particle_tiled.graphed_step`` and
    ``graphed_step_from_noise``), the flat ``ParticleFilter`` (auto) at
    2^20 and the GSUKF at 2^18, each against eager dispatch from the
    same state and generator state over 10 chained steps, bit for bit
    (states, moments, generators; the shells' ``predict``, ``update``,
    ``resample``, ``step`` and ``moments``; the flat ``step`` also once
    captured under ``impl("ends")``), tensors handed out unchanged after
    3 more calls, a measurement mixture assigned anew and a state
    assigned from outside computed with, a generator's ``set_state``
    honoured, ``compact`` and ``expand`` counted at every replay; 50
    chained calls graphed and eager timed by CUDA events, with the host
    ms a call, and each graph's memory pool; three graphed shell steps
    from host ``u``, ``z`` and ``dt`` (as the harness passes them) under
    ``torch.cuda.set_sync_debug_mode("error")``: the inputs go through
    pinned memory (``graphs.as_input``), so a graphed call never waits
    for the card, and its host ms must be below its device ms;
    every capture or replay
    that fails raises; then ``graph_cond`` alone (``ops/graph_cond``, the
    conditional nodes of the QP's device loop): a WHILE node of 1000
    iterations over a two-kernel body and an IF never taken, timed a
    iteration against the same body driven from the host (a replay and a
    read of the flag an iteration) and against the body's kernels
    unrolled in one graph, its iterations counted on the card;
12. the control slice, on the canonical rig's MPC at dt_control = 0.1
    (P = 2999, M = 1999: the reference's ``int(300 // 0.1)``; a QP of
    n = 4000, m = 2), one host setup for (a) to (c): the ``Simulation``
    of (b), built first, and the same MPC on the CPU, its setup time
    printed. Every QP solve on the card is one graph whose ADMM loop is a
    conditional WHILE node (``control/qp.py``). Between the phases the
    MPC is ``reset``:
    (a) the no-noise closed loop of
    ``results/bioreactor_closedloop/no_noise.py`` to t = 5: each solve
    solved again from the same state under ``qp.host_driven()`` and held
    to it bit for bit (statuses, iterations, x, y, z, residuals, the
    carried rho and refactorization counts, the control), the WHILE
    iterations counted on the card equal to the solves' chunks, one read
    to the host a ``K.step`` (the profiler counts both ways); then
    ``rig.QP_CASES`` the same way, three members each (a general Hessian
    refactorizing its n x n K, a stall at a max_iter between checks, the
    Woodbury path's stall refactorizing its m x m factor); ``K.step``
    latency (median and spread), solves per second, CUDA-event ms per
    solve and per stall both ways, iterations per solve, the steps
    accepted as near-solved and
    those that raised ``ValueError`` (a stall at max_iter, which the
    reference's float32 ADMM shows on 8 of these 49 steps on the CPU:
    they fall back as in
    ``results/bioreactor_closedloop/mpc_run_seq.py``; the first step
    raising, or more than 8, fails the run), five solves again under
    ``torch.profiler``, and the first step against the same MPC on the
    CPU (within 1e-4);
    (b) ``Simulation`` with the particle filter at 2^20 particles to
    t = 5, (c) ``make_scan_loop`` at the same size from (b)'s initial
    state, one graph replay a time step (the predict, the measurement,
    the control event with its solve and WHILE node, the plant): a first
    run captures, the second runs its steps under
    ``torch.cuda.set_sync_debug_mode("error")`` (a read to the host
    raises) with the host's enqueue timed against the card's time, and
    its records must equal the capturing run's and the host-driven
    loop's (the step eager, its QP under ``qp.host_driven()``) bit for
    bit; (d) ``Simulation`` with the GSUKF at 2^18 Gaussians to t = 2
    (its own setup): ``compact`` and ``expand`` must launch once per
    control event (the resample), every output must be finite; ms per
    control event, ``mpc_frac`` and ``performance``; (e) ``MPC.step`` on
    the first QP of the no-noise loop at P = 300, M = 200 on the card
    and on the CPU (status, iterations and residuals from
    ``last_solution``, control), the CPU's control held to
    ``u = [-0.028, -0.1]`` and the card's, when it solves, to the CPU's;
13. the scenario MPC and the instrumentation: (f) at the canonical
    rig's width (dt_control = 1: P = 300, M = 200, u bounds only) over
    ``rig.SCENARIOS`` = 16 scenarios about (e)'s ``x2d``: the stacked
    ``ScenarioMPC`` (n_D = 6402) on the card against a CPU copy within
    1e-4, the consensus step (40 outer iterations, ``rho_consensus``
    the du_0 block's Schur complement, mean diagonal) within 2e-3 of the
    stacked control with a gap under 1e-3, the independent solves
    (``make_scenario_solver``) within 1e-4 of single ``make_device_step``
    solves with no more rows unsolved than the reference's
    ``REF_UNSOLVED``, the consensus step's and the independent batched
    solves bit-equal to the same under ``qp.host_driven()``, and
    ``rig.binding_case()`` on the card against the
    CPU (the hedge above 1e-3, every scenario within 1e-3 of its bounds);
    the median ms of 10 calls of each; (g) ``RunSequences`` of the flat
    step (auto) at 2^16, 2^18 and 2^20, 50 runs each in chunks of 5,
    with ``max_abs_pacf`` printed beside the 0.2 gate,
    ``PowerMeasurement`` over 5 s of steps at 2^20 (fails unless the
    card's energy is finite, positive and its mean power under 105% of
    the power limit) and a ``StateCheckpointer`` resume at 2^20 that must
    equal the unbroken run bit for bit;
14. (h) the multi-device slice (``gpu_se_tpu_torch/parallel``): at W = 1,
    a one-rank NCCL group in this process (one ``all_reduce`` on the
    card, then a mesh of one, whose collectives launch nothing): the
    sharded flat step at 2^20 (``bench.py``'s rig) through each route
    (``xla``, ``kernel``: ends merge, ``a2a``: compact + expand over the
    ragged exchange, ``a2a_xla``, ``a2a_ring``, ``a2a_ring_v4``: compact
    + expand over the ring), each equal to the plain gather at the same
    segmented ``ends`` bit for bit, its device-to-host copies a step
    counted by ``torch.profiler``, then 10 chained steps timed after two
    untimed ones (a graphed step's captures), each
    drawing its noise by one ``counter_draw`` of samples [0, 2^20); the
    sharded tiled step at 2^20 with both exchanges (bit-equal to each
    other, its resample to the ring route's); the sharded GSUKF step at
    2^18 (``xla``, ``kernel`` on the 30-column bank, ``a2a``), routes
    bit-equal; the auto-sharded steps against the single-device steps
    and (f)'s scenario solvers through a mesh of one against
    ``mesh=None``, bit for bit; each route's kernels launched as it
    says. Then W = 2: two spawned processes on this card over gloo (NCCL
    refuses two ranks on one card; gloo copies through the host), 2^20
    particles each of 2^21, the ``kernel``, ``a2a`` and tiled ``ragged``
    resamples equal to W = 1's on the same global input bit for bit;
    then the entry points from each rank's slice of one global state:
    ``make_shard_map_step`` (``kernel``, ``a2a``) and
    ``make_shard_map_gsukf_step`` (``kernel``, 2^18 Gaussians a rank),
    their first step equal to W = 1's bit for bit, each rank's
    ``counter_draw`` counted at its own ``n_local`` samples (``n_local (2
    nx + 1)`` for the GSUKF) and the next step's peak memory above its
    state printed, and ``make_shard_map_tiled_step`` (``ragged``), finite,
    each launching its kernels on both ranks and timed over 5 chained
    steps by ``results/sharded_steps.step_rows``;
15. (j) the sharded closed-loop control step
    (``parallel/control.make_sharded_control_step``: the sharded filter
    step, ``parallel/sharded.point_estimate`` of the whole population,
    the MPC's device solve on rank 0, broadcast) on (b)'s canonical MPC
    (P = 2999, M = 1999, its float64 setup built once; the W = 2 ranks
    get its CPU copy and move it to the card with ``MPC.to``): at W = 1
    in a one-rank NCCL
    group, 5 control events of the flat step at 2^20 (``bench.py``'s
    rig) through ``a2a`` (compact + expand + counter_draw) and
    ``kernel`` (ends_merge_round + counter_draw), and 5 at 2^21, each
    event's ``u`` equal bit for bit to a single-rank
    ``make_device_step`` fed the same estimate and warm start, each
    kernel launched once an event; one event of the GSUKF (``kernel``)
    at 2^18 and 2^19 and of the tiled step (``ragged``) at 2^20; then
    W = 2, two processes on this card over gloo, 2^20 a
    rank: both routes' estimates and ``u`` equal W = 1's at 2^21 bit for
    bit on both ranks, each kernel launched once an event a rank
    (``ends_merge_round`` once a block not skipped), the port's rank-0
    solve and broadcast timed against a solve replicated on both ranks
    (the reference's) in turns, one
    event of the GSUKF (2^18 a rank, equal to W = 1's at 2^19) and of
    the tiled step; ms per control event by CUDA events and the QP's
    statuses printed. At W = 1 also each sharded entry point its factory
    graphs (``step.graphed``: the flat ``xla``, ``kernel``,
    ``a2a_ring_v4``, ``a2a_ring``, the GSUKF ``xla``, ``kernel``,
    ``a2a_ring``, the tiled ``ring``; the ragged routes must report
    False) over 5 chained steps at 2^20 a rank (2^18 Gaussians), bit-equal
    to the same step under ``graphs.disabled``, its kernels counted at
    each replay (``counter_draw`` inside the graph; the kernel route's
    ``ends_merge_round`` inside its IF node, counted on the card), timed
    both ways; and the ``kernel`` control step, one replay an event (the
    filter step, the estimate, the solve with its WHILE node, the
    broadcast), 5 events bit-equal to eager (estimates, ``u``, statuses,
    iterations); ``entry.dryrun_multichip(2)`` on this card (every
    leg of the reference's dry run, finite); and the float64 serial
    engine (``native/serial.py``, built by g++ from the checkout; a
    failed build raises) against the card's flat predict and update at
    ``rig.SERIAL_N`` = 2^16 particles fed the same float32 noise, within
    ``rig.SERIAL_RTOL`` and ``rig.SERIAL_ATOL``;
16. (i) the experiments layer (``gpu_se_tpu_torch/results``), through the
    entry points the campaign calls, with the jar under a temporary
    directory: first each graphed op (``_filter_bench.build``'s four at
    2^20 particles, the GSF's predict, update and resample and the
    sigma-point op at 2^18 Gaussians, ``breakdown_ops``' five at 2^18)
    over 5 chained calls bit-equal to the same op under
    ``graphs.disabled``, then 20 chained calls timed both ways by CUDA
    events; then the PF run sequences (predict, update, resample, step) on
    the card at 2^1, 2^12, 2^20 and 2^23.5 (the top of the reference's
    grid, an odd n) and on the CPU at 2^1 and 2^10, the GSF's (predict,
    update, resample, sigma points) at 2^0, 2^10 and 2^18.5 and the
    timer control, 10 runs each, every time finite and positive, and
    ``compact`` and ``expand`` launched once a call of every op that
    resamples at n >= 2^12 and never otherwise, the warm-up calls
    (``_filter_bench.warm``: a graphed op's captures) included;
    ``breakdown_pf`` at 2^18;
    ``pacf_series`` (8 steps, 20 reps, one CUDA graph replay a rep:
    ``compact`` and ``expand`` 8 times at the warm-up and 8 at each of
    the 21 replays) with its host-ms and device-ms series
    and the graph's own device ms (events captured in the graph),
    beside the chunked step sequence's max |pacf|; ``pf_power.step_energy`` over 2 s at 2^20 (the card's J
    finite, positive and under 105% of the power limit over the window);
    ``get_sim_summary`` and ``get_sim_summary_device`` of the PF at 2^20
    and of the GSF at 2^14 to t = 2 (``compact`` and ``expand`` once a
    control event); ``mpc_run_seq(n_runs=20)`` and ``device_solve_ms()`` (each
    chain one graph replay, and as a Python loop of solves)
    at dt_control = 0.1 and ``get_simulation_performance(30.0, 0)``.

Each path runs with every launch count set to 0 just before it and read
just after; a kernel's ``launches`` is the sum over the paths, a graph's
kernels counted at each of its replays, and a kernel inside a
conditional node's body each time the card ran the body
(``graphs.settle_counts``). Every kernel's line carries its
bound: the bytes it must move (each input read once, each output
written once, counting only the survivors this run's weights leave
where the kernel reads no other entry, and of a search's keys only
those a search of every slot must read: ``searched_keys``) over 3.35
TB/s, or its compare and add operations over 67 T/s (the H100's float32
rate outside the tensor cores; the table has no int32 row), whichever is
larger; a kernel timed under its bound fails the run. ``library_ms`` is ``counter_draw``'s ``torch.randn`` plus
``torch.rand`` of the same shape, ``mixture_pdf``'s the einsum path the
port called before (``einsum_pdf``), and null for the resample kernels, whose
functions no single PyTorch call computes, and for ``graph_cond``, whose
loop no PyTorch call runs on the card. ``graph_cond``'s launches are the
WHILE iterations of (a) and (c), counted on the card, its time one
iteration of the timed loop, its plain time one iteration of that loop
driven from the host, and its max_abs_err 0: every device-loop solve
and record must equal the host-driven loop's. Kernels are timed by their
device time under ``torch.profiler``;
a kernel that updates its state in place gets a fresh state per call,
made before the timed calls.

Output: one line per phase, the total time, then a ``{"kernels": [...]}``
JSON line, the ``nvidia-smi`` line, the ten metric JSON lines (tiled PF,
GSUKF, graphed steps, MPC, closed loop, scenario MPC, instrumentation,
multi-device, sharded control, experiments) and, last, ``{"ok": true,
"device": {...}}``. Run from the
repository root::

    python3 chip_smoke.py [--seed 0]
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import scipy.linalg
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from gpu_se_tpu_torch import convert, graphs, rig  # noqa: E402
from gpu_se_tpu_torch.distributions import GaussianSum  # noqa: E402
from gpu_se_tpu_torch.filters import gs_ukf as gsf  # noqa: E402
from gpu_se_tpu_torch.filters import particle as pf  # noqa: E402
from gpu_se_tpu_torch.filters import particle_tiled as pft  # noqa: E402
from gpu_se_tpu_torch.filters import resampling as rs  # noqa: E402
from gpu_se_tpu_torch.models import bioreactor as bio  # noqa: E402
from gpu_se_tpu_torch.ops import _build  # noqa: E402
from gpu_se_tpu_torch.ops import counter_draw as cdraw  # noqa: E402
from gpu_se_tpu_torch.ops import graph_cond  # noqa: E402
from gpu_se_tpu_torch.ops import mixture_pdf as mpdf  # noqa: E402
from gpu_se_tpu_torch.ops import resample_coarse as rc  # noqa: E402
from gpu_se_tpu_torch.ops import resample_pallas2 as rp2  # noqa: E402
from gpu_se_tpu_torch.ops import resample_pallas3 as rp3  # noqa: E402
from gpu_se_tpu_torch.ops import resample_pallas4 as rp4  # noqa: E402
from gpu_se_tpu_torch.ops import resample_pallas_block as rpb  # noqa: E402
from gpu_se_tpu_torch.ops.resample_coarse import ends_from_weights  # noqa: E402
from gpu_se_tpu_torch.pytree import tree_flatten  # noqa: E402
from gpu_se_tpu_torch.control import qp as cqp  # noqa: E402
from gpu_se_tpu_torch.models import Bioreactor  # noqa: E402
from gpu_se_tpu_torch.sim import harness  # noqa: E402
from gpu_se_tpu_torch.sim import loop as sim_loop  # noqa: E402
from gpu_se_tpu_torch.control import MPC, ScenarioMPC  # noqa: E402
from gpu_se_tpu_torch.control import consensus_consts  # noqa: E402
from gpu_se_tpu_torch.control import scenario_mpc  # noqa: E402
from gpu_se_tpu_torch.control.mpc import make_device_step  # noqa: E402
from gpu_se_tpu_torch.models import LinearModel  # noqa: E402
from gpu_se_tpu_torch.parallel import make_consensus_scenario_step  # noqa: E402
from gpu_se_tpu_torch.parallel import make_scenario_solver  # noqa: E402
from gpu_se_tpu_torch import parallel as par  # noqa: E402
from gpu_se_tpu_torch.parallel import sharded  # noqa: E402
from gpu_se_tpu_torch.parallel.control import (  # noqa: E402
    make_sharded_control_step,
)
from gpu_se_tpu_torch import entry  # noqa: E402
from gpu_se_tpu_torch.native import serial as native_serial  # noqa: E402
from gpu_se_tpu_torch.parallel.launch import free_port, run_group  # noqa: E402
from gpu_se_tpu_torch.utils import PowerMeasurement, RunSequences  # noqa: E402
from gpu_se_tpu_torch.utils import StateCheckpointer, max_abs_pacf  # noqa: E402
from gpu_se_tpu_torch.utils import cache as jar_cache  # noqa: E402
from gpu_se_tpu_torch.results import _filter_bench as exp_fb  # noqa: E402
from gpu_se_tpu_torch.results import pacf_series as exp_pacf  # noqa: E402
from gpu_se_tpu_torch.results import sharded_steps  # noqa: E402
from gpu_se_tpu_torch.results.sharded_steps import counted_draws  # noqa: E402
from gpu_se_tpu_torch.results.bioreactor_closedloop import (  # noqa: E402
    mpc_run_seq as exp_mpc,
    performance_vs_control_period as exp_pvcp,
)
from gpu_se_tpu_torch.results.gsf_closedloop import (  # noqa: E402
    bioreactor_performance_gsf as exp_gsf_cl,
)
from gpu_se_tpu_torch.results.gsf_openloop import gsf_run_seq as exp_gsf  # noqa: E402
from gpu_se_tpu_torch.results.pf_closedloop import (  # noqa: E402
    bioreactor_performance_pf as exp_pf_cl,
)
from gpu_se_tpu_torch.results.pf_openloop import pf_power as exp_power  # noqa: E402
from gpu_se_tpu_torch.results.pf_openloop import pf_run_seq as exp_pf  # noqa: E402

N = 2**20
N_BANK = 2**18
DT_CONTROL = 0.1          # the closed loop's canonical rig (P=2999, M=1999)
LOOP_END = 5              # the closed-loop phases' horizon
GSUKF_LOOP_END = 2
# steps of (a)'s loop on which the reference's own float32 ADMM raises
# ValueError on the CPU (scripts/mpc_loop_status.py --package jax: 8 of 49)
REF_RAISED = 8
# rows of (f)'s 16 independent solves on which the reference's float32
# ADMM stops at max_iter on the CPU (scripts/scenario_status.py --package
# jax: row 3)
REF_UNSOLVED = 1
STEPS = 50
ROUTE_STEPS = 10
GRAPH_WARM = 2            # warm-up steps of a graphed path: its captures
GRAPH_STEPS = 10          # (k): chained steps held bit-equal to eager
GRAPH_TIMED = 50          # (k): chained calls timed, graphed and eager
GSUKF_STEPS = 30
REPS = 30
PROFILE_TRIES = 10
CALL_MARK = "device_ms call"   # the range of one timed call
COMPACT_REPEATS = 200
N_MANY_TILES = 2**24     # more tiles of `compact` than blocks the card holds
WATCHDOG_S = 300
TIMED_CALLS = 10          # calls of each scenario-MPC entry timed in (f)
RUN_SEQ_NS = (2**16, 2**18, 2**20)   # (g)'s run sequences
RUN_SEQ_RUNS = 50
RUN_SEQ_CHUNK = 5
POWER_T_RUN = 5.0         # seconds of steps under PowerMeasurement in (g)
SHARD_STEPS = 10          # chained sharded steps timed a route in (h)
SHARD_WARM = 2            # (h): untimed steps before them (the captures)
# (i) the experiments, at the top of the reference's grids
EXP_PF_LOG2 = (1.0, 12.0, 20.0, 23.5)
EXP_PF_CPU_LOG2 = (1.0, 10.0)
EXP_GSF_LOG2 = (0.0, 10.0, 18.5)
EXP_RUNS = 10
EXP_GRAPH_STEPS = 5       # (i): chained calls held bit-equal, graphed-eager
EXP_GRAPH_TIMED = 20      # (i): chained calls timed, graphed and eager
EXP_BREAKDOWN_N = 2**18
EXP_PACF_K, EXP_PACF_REPS = 8, 20
EXP_POWER_T_RUN = 2.0
EXP_LOOP_END = 2
EXP_GSF_LOOP_N = 2**14
EXP_MPC_RUNS = 20
N_W2 = 2**21              # (h)'s global particles at W = 2 (2^20 a rank)
W2_TIMEOUT_S = 300
# (h): the kernels each sharded route launches once a step at W = 1
SHARD_FLAT = {"xla": (), "kernel": ("ends_merge_round",),
              "a2a": ("compact", "expand"), "a2a_xla": (), "a2a_ring": (),
              "a2a_ring_v4": ("compact", "expand")}
SHARD_GSUKF = {"xla": (), "kernel": ("ends_merge_round",), "a2a": ()}
SHARD_TILED = ("ragged", "ring")
REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(REPO, "tests", "data", "torch_parity_step.npz")
GSUKF_FIXTURE = os.path.join(REPO, "tests", "data",
                             "torch_parity_gsukf.npz")
# bench_v2.py's (window, block) geometries
V2_GEOMETRIES = ((1024, 1024), (2048, 2048), (512, 512), (2048, 1024),
                 (4096, 2048))
# the published peaks of one H100 SXM (bytes/s, float32 operations/s)
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
# device ms of the one-thread-per-slot first designs of the merge and
# coarse kernels, at the flat path's input (this script's profiler reading
# on an NVIDIA H100 80GB HBM3 at 700.00 W)
ONE_THREAD_PER_SLOT_MS = {"ends_merge_round": 0.0665, "cumsum_merge": 0.0372,
                          "coarse_gather": 0.0227}
# and of the one-thread-per-sample first design of counter_draw, at a
# rank's 2^20 samples, rows, and at the GSUKF's 2^18 x 11, lanes-last
ONE_THREAD_PER_SAMPLE_MS = {"rows": 0.0353, "lanes-last": 0.0599}
# rows of a 4096-particle step that may differ from the reference's: one
# per `ends` entry a cumsum tie moves (tests/test_torch_kernels.py)
STEP_TIE_ROWS = 8
# rows of a merge-route resample (float compare cs_k < (i + r) / n) that
# may differ from the plain route (integer ends) at any n: 0 read on the
# card at 2^20 and on the CPU (tests/test_torch_resample_router.py
# test_cross_route_tie_count); this is the margin over that reading
MERGE_TIE_ROWS = 2
W_RTOL = 1e-5        # measurement pdf: exp differs by ulps across libraries
X_SS = rig.X_SS
FAMILIES = ("uniform", "near_uniform", "heavy")
# name: (source, the TPU kernels it replaces, its wrapper)
KERNELS = {
    "compact": ("gpu_se_tpu_torch/csrc/resample.cu",
                "gpu_se_tpu/ops/resample_pallas4.py:266, "
                "gpu_se_tpu/ops/resample_pallas2.py:69", rp4.compact),
    "ends_merge_round": ("gpu_se_tpu_torch/csrc/resample_block.cu",
                         "gpu_se_tpu/ops/resample_pallas_block.py:42, "
                         "gpu_se_tpu/ops/resample_pallas_block.py:231",
                         rpb.ends_merge_round),
    "cumsum_merge": ("gpu_se_tpu_torch/csrc/resample_merge.cu",
                     "gpu_se_tpu/ops/resample_pallas3.py:43, "
                     "gpu_se_tpu/ops/resample_pallas.py:35",
                     rp3.cumsum_merge),
    "coarse_gather": ("gpu_se_tpu_torch/csrc/resample_coarse.cu",
                      "gpu_se_tpu/ops/resample_coarse.py:117",
                      rc.coarse_gather),
    "expand": ("gpu_se_tpu_torch/csrc/resample_expand.cu",
               "gpu_se_tpu/ops/resample_pallas4.py:76, "
               "gpu_se_tpu/ops/resample_pallas2.py:178", rp4.expand),
    # port-only: no Pallas kernel; the reference draws with partitionable
    # threefry outside its shard_map
    "counter_draw": ("gpu_se_tpu_torch/csrc/counter_draw.cu",
                     "none (port-only): the partitionable threefry draw of "
                     "gpu_se_tpu/parallel/sharded.py:1015 and :1133",
                     cdraw.counter_draw),
    # port-only: the reference's density is an XLA einsum
    "mixture_pdf": ("gpu_se_tpu_torch/csrc/mixture_pdf.cu",
                    "none (port-only): the einsum of GaussianSum.pdf, "
                    "gpu_se_tpu/distributions/gaussian_sum.py:156",
                    mpdf.mixture_pdf),
}
COUNTER_KEY = (0x1234ABCD, 0x0F0E0D0C)
# the kernel each flat-filter route must launch once per step
ROUTE_KERNELS = {"auto": ("compact", "expand"),
                 "ends": ("ends_merge_round",), "v3": ("cumsum_merge",),
                 "pallas": ("cumsum_merge",), "coarse": ("coarse_gather",)}
# routes whose result must equal the plain route's bit for bit; the
# merge routes may part from it at float ties (MERGE_TIE_ROWS)
EXACT_ROUTES = ("auto", "ends", "coarse")
# launches of each kernel summed over the paths (expect_counts)
TALLY = {name: 0 for name in KERNELS}
# graph_cond's WHILE iterations counted on the card in each QP path
TALLY_COND: list = []


def zero_counts() -> None:
    graphs.settle_counts()
    for _, _, wrapper in KERNELS.values():
        wrapper.launches = 0


def read_counts() -> dict[str, int]:
    """Each kernel's launches, those counted on the card (a conditional
    node's body, ``graphs.count_on_card``) folded in first."""
    graphs.settle_counts()
    return {name: k[2].launches for name, k in KERNELS.items()}


def expect_counts(path: str, counts: dict[str, int],
                  want: dict[str, int], tally: bool = True) -> None:
    """Fail unless ``counts`` equals ``want`` (0 for every kernel not
    named); add a path's counts to ``TALLY``."""
    full = {name: want.get(name, 0) for name in KERNELS}
    if counts != full:
        raise AssertionError(f"{path}: launch counts {counts} != {full}")
    if tally:
        for name, c in counts.items():
            TALLY[name] += c


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = REPS) -> float:
    """Median time of ``fn`` over ``reps`` synchronised calls, by CUDA
    events around each call: the host's launch latency is in it."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def least_time(nbytes: float, ops: float) -> tuple[float, str]:
    """``(ms, "bytes" or "operations")``: the least time the card could
    take, the larger of the bytes over the memory rate and the operations
    over the float32 rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_OPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def search_ops(n: int, length: int) -> float:
    """Compares of ``n`` binary searches over ``length`` entries."""
    return n * max(1, math.ceil(math.log2(max(length, 2))))


def gather_bound(n: int, m: int, rows: int, ops: float, extra_in: int = 0,
                 compacted: bool = True):
    """Bound of a search + gather: read the ``rows`` payload columns of
    the ``m`` survivors (from compacted input also their key and original
    index) and ``extra_in`` more bytes, write ``rows`` payload rows and
    the ancestor of every slot; ``ops`` compares."""
    per_survivor = 4 * rows + (8 if compacted else 0)
    return least_time(m * per_survivor + extra_in + n * (4 * rows + 4), ops)


def searched_keys(ends: torch.Tensor) -> int:
    """Keys of the non-decreasing ``ends`` that a search of every slot
    must read: the slots fall in chunks of ``rc.BLOCK`` whose ancestors
    lie in the window ``[o_c, o_{c+1})`` of ``rc.chunk_boundaries``; a
    chunk reads its window whole, or a binary search a slot where that
    reads fewer (one survivor: one window of about n keys). Keys outside
    every window (before the first survivor) are read by none."""
    w = torch.diff(rc.chunk_boundaries(ends, ends.shape[0])).double()
    return int(torch.minimum(
        w, rc.BLOCK * torch.ceil(torch.log2(w + 1))).sum())


def expand_bound(n: int, m: int, rows: int, block: int):
    """Bound of :func:`~gpu_se_tpu_torch.ops.resample_pallas4.expand`: one
    search of ``n`` keys per chunk, one of the ``block + 1`` staged keys
    per slot."""
    ops = search_ops(n, block + 1) + search_ops(-(-n // block), n)
    return gather_bound(n, m, rows, ops)


def device_ms(fn, reps: int = REPS, setup=None) -> float:
    """Device time of one call of ``fn``: the union of the intervals of
    the device ops the call launched, by ``torch.profiler``, averaged
    over the whole calls among ``reps`` synchronised ones (``call_busy``).
    The profiler now and then drops a device event (on one card, one in
    every session of a host-syncing plain version): the calls that show
    the number of device ops most calls show are whole, the others are
    left out, and a session with fewer than half its calls whole is
    profiled again, ``PROFILE_TRIES`` times at most. Unlike :func:`time_ms` it
    leaves out the host's launch latency, which on this path is of the
    kernels' own size. With ``setup``, each call is ``fn(*setup())`` on
    arguments all made before the first call, so that their making is
    not timed."""
    from torch.profiler import ProfilerActivity, profile, record_function

    for attempt in range(PROFILE_TRIES):
        args = [setup() if setup else () for _ in range(reps + 3)]
        for a in args[:3]:
            fn(*a)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for a in args[3:]:
                with record_function(CALL_MARK):
                    fn(*a)
                    torch.cuda.synchronize()
        calls = call_busy(prof.events())
        usual = collections.Counter(ops for ops, _ in calls).most_common(1)
        usual = usual[0][0] if usual else 0
        whole = [busy for ops, busy in calls if ops == usual]
        if usual > 0 and 2 * len(whole) >= reps:
            return float(np.mean(whole))
        log(f"device_ms: {len(whole)} of {len(calls)} calls show {usual} "
            f"device ops, profiling again ({attempt + 1} of "
            f"{PROFILE_TRIES})")
    raise AssertionError("the profiler saw too few whole calls")


def union_ms(spans) -> float:
    """The length of the union of ``(start, end)`` intervals in us, in
    ms."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3


def call_busy(events) -> list[tuple[int, float]]:
    """``(device ops, busy ms)`` of each call that ``device_ms`` marked:
    the device ops whose start lies in the call's ``CALL_MARK`` range on
    the device, which the profiler draws from the first to the last op
    launched under the mark. The mark's range on the host is not used:
    the profiler maps device times onto the host's clock, and on the H100
    the two drift apart by milliseconds within one session
    (``python -m gpu_se_tpu_torch.results.profiler_clock``), so that a
    call's ops fall into another call's host range or into none."""
    cuda = torch.autograd.DeviceType.CUDA
    marks = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == CALL_MARK and e.device_type == cuda)
    dev = [(e.time_range.start, e.time_range.end) for e in events
           if e.device_type == cuda and e.name != CALL_MARK]
    calls = []
    for s, e in marks:
        spans = [d for d in dev if s <= d[0] <= e]
        calls.append((len(spans), union_ms(spans)))
    return calls


def max_abs_err(got, want) -> float:
    return max(float((g.double() - w.double()).abs().max())
               for g, w in zip(got, want))


def assert_equal(name: str, got, want) -> None:
    for k, (g, w) in enumerate(zip(got, want)):
        if not torch.equal(g, w):
            raise AssertionError(f"{name}: output {k} differs from the "
                                 f"plain version")


def family_weights(family: str, n: int, rng, dev) -> torch.Tensor:
    if family == "uniform":
        w = np.ones(n)
    elif family == "near_uniform":
        w = 1.0 + 0.1 * rng.random(n)
    else:       # lognormal with sigma 4
        w = np.exp(4.0 * rng.standard_normal(n))
    return torch.from_numpy(w.astype(np.float32)).to(dev)


def randn(rng, shape, dev) -> torch.Tensor:
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dev)


def rows_differ(got, want) -> int:
    return int(torch.count_nonzero(torch.any(
        (got != want).reshape(got.shape[0], -1), dim=1)))


def bench_rig(dev):
    """``bench.py``'s ``(x0, state_pdf, meas_pdf)`` on ``dev``."""
    return tuple(GaussianSum.create(*args, device=dev)
                 for args in rig.bench_rig())


# ----------------------------------------------------------------------
def phase_card() -> tuple[str, torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: the port's smoke run needs one")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    return card, torch.device("cuda", 0)


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = _build.load_library()
    # the constants the CPU tests' models of the kernels are written for
    assert lib.gst_compact_tile() == rig.COMPACT_TILE
    assert lib.gst_expand_max_stage() == rig.EXPAND_MAX_STAGE
    assert lib.gst_merge_threads() == rig.MERGE_THREADS
    assert lib.gst_ends_merge_thread_items() == rig.ENDS_MERGE_ITEMS
    assert lib.gst_cumsum_merge_thread_items() == rig.CUMSUM_MERGE_ITEMS
    assert lib.gst_coarse_chunks() == rig.COARSE_CHUNKS
    assert lib.gst_coarse_stage() == rig.COARSE_STAGE
    assert rc.BLOCK == rig.COARSE_CHUNK
    log(f"build: {time.perf_counter() - t0:.2f} s -> "
        f"{os.path.relpath(_build.library_path())}")


def harness_rig(dev):
    """The closed loop's filter configuration: ``sim/harness.get_noise``'s
    state and measurement mixtures (``gpu_se_tpu/sim/harness.py:94-110``)
    and ``x0``, the state mixture moved to the steady state (``:72-75``).
    Returns ``(x0, state_pdf, meas_pdf)``."""
    state = (np.zeros((2, 5)),
             np.stack([np.diag([1e-4, 1e-7, 1e-3, 1e-3, 1e-7]),
                       np.diag([1e-3, 1e-6, 1e-2, 1e-2, 1e-6])]),
             np.array([0.75, 0.25]))
    meas = (np.array([[1e-1, 0], [0, -1e-1]]),
            np.array([[[6e-2, 0], [0, 8e-2]], [[500, 100], [100, 700]]]),
            np.array([0.85, 0.15]))
    return (GaussianSum.create(state[0] + X_SS, *state[1:], device=dev),
            GaussianSum.create(*state, device=dev),
            GaussianSum.create(*meas, device=dev))


@contextlib.contextmanager
def watchdog(seconds: float, what: str):
    """End the process (exit code 3) if the body runs longer than
    ``seconds``: a kernel that waits for ever blocks every synchronise,
    so nothing in this thread could raise."""
    def bark():
        print(f"watchdog: {what} still running after {seconds} s",
              flush=True)
        os._exit(3)

    timer = threading.Timer(seconds, bark)
    timer.daemon = True
    timer.start()
    try:
        yield
    finally:
        timer.cancel()


def edge_inputs(case, dev, seed: int):
    """``(ends, payload)`` of one of ``rig.edge_cases()`` on ``dev``."""
    family, n, rows = case
    exact = rig.edge_exact_ends(family, n)
    if exact is not None:
        ends = torch.from_numpy(exact).to(dev)
    else:
        w, r = rig.edge_weights(family, n, seed)
        ends = ends_from_weights(torch.from_numpy(w).to(dev),
                                 torch.tensor(r, device=dev))
    return ends, torch.from_numpy(rig.edge_payload(rows, n, seed)).to(dev)


def phase_edge_cases(dev, seed: int) -> None:
    """``compact`` and ``expand`` against their plain versions on every
    shared edge case; ``expand`` at every chunk size, on the compacted
    keys (with their indices) and on the raw ``ends`` (repeated keys, no
    indices)."""
    for case in rig.edge_cases():
        ends, x = edge_inputs(case, dev, seed)
        got = rp4.compact(ends, x)
        assert_equal(f"compact {rig.edge_id(case)}", got,
                     rp4.compact_plain(ends, x))
        for route, args in (("compacted", got[:3]), ("repeated", (ends, x))):
            want = rp4.expand_plain(*args)
            for block in rig.EXPAND_BLOCKS:
                assert_equal(f"expand {rig.edge_id(case)} {route} "
                             f"block={block}",
                             rp4.expand(*args, block=block), want)
        torch.cuda.synchronize()
        log(f"edge case {rig.edge_id(case)}: compact == plain (survivors "
            f"{int(got[3].item())}), expand == plain on compacted and "
            f"repeated keys at blocks {list(rig.EXPAND_BLOCKS)}")


def phase_merge_edge_cases(dev, seed: int) -> dict[str, float]:
    """``ends_merge_round``, ``cumsum_merge`` and ``coarse_gather`` against
    their plain versions on their shared edge cases, and
    ``ends_merge_round`` on the ring feeds: every shard fed every source
    block in ascending order, each round against the plain round on the
    same state, the shards together against one round over the whole
    pool."""
    errs = {"ends_merge_round": 0.0, "cumsum_merge": 0.0,
            "coarse_gather": 0.0}
    for family, n, nx in rig.ends_merge_cases():
        ends, x = edge_inputs((family, n, nx), dev, seed)
        parts = x.T.contiguous()
        got = rpb.ends_merge_round(ends, parts, 0,
                                   *rpb.block_resample_state(n, nx, dev))
        want = rpb.ends_merge_round_plain(
            ends, parts, 0, *rpb.block_resample_state(n, nx, dev))
        name = f"ends_merge_round {rig.edge_id((family, n, nx))}"
        assert_equal(name, got, want)
        errs["ends_merge_round"] = max(errs["ends_merge_round"],
                                       max_abs_err(got, want))
        del got, want, parts, x
        torch.cuda.synchronize()
        log(f"edge case {name} == plain")
    for family, n, rows in rig.cumsum_merge_cases():
        w, r = rig.edge_weights(family, n, seed)
        r = torch.tensor(r, device=dev)
        cs = rp3.normalized_cumsum(torch.from_numpy(w).to(dev), r)
        payload = torch.from_numpy(rig.edge_payload(rows, n, seed)).to(dev)
        got = rp3.cumsum_merge(cs, payload, r)
        want = rp3.cumsum_merge_plain(cs, payload, r)
        name = f"cumsum_merge {rig.edge_id((family, n, rows))}"
        assert_equal(name, got, want)
        errs["cumsum_merge"] = max(errs["cumsum_merge"],
                                   max_abs_err(got, want))
        del got, want, payload
        torch.cuda.synchronize()
        log(f"edge case {name} == plain")
    for case in rig.coarse_cases():
        ends, payload = edge_inputs(case, dev, seed)
        o = rc.chunk_boundaries(ends, case[1])
        got = rc.coarse_gather(ends, o, payload)
        want = rc.coarse_gather_plain(ends, o, payload)
        name = f"coarse_gather {rig.edge_id(case)}"
        assert_equal(name, got, want)
        errs["coarse_gather"] = max(errs["coarse_gather"],
                                    max_abs_err(got, want))
        longest = int(torch.diff(o).max())
        del got, want, payload
        torch.cuda.synchronize()
        log(f"edge case {name} == plain (longest chunk window {longest} "
            f"keys)")
    for family, n, blocks, shards in rig.RING_FEEDS:
        ends, x = edge_inputs((family, n, 5), dev, seed)
        parts = x.T.contiguous()
        whole = rpb.ends_merge_round_plain(
            ends, parts, 0, *rpb.block_resample_state(n, 5, dev))
        src, dst = rig.ring_bounds(n, blocks), rig.ring_bounds(n, shards)
        kinds = {"below": 0, "above": 0, "across": 0}
        for s0, s1 in zip(dst, dst[1:]):
            state = rpb.block_resample_state(s1 - s0, 5, dev)
            for b0, b1 in zip(src, src[1:]):
                kind = ("below" if int(ends[b1 - 1]) < s0 else "above"
                        if int(ends[b0]) >= s1 else "across")
                kinds[kind] += 1
                want = rpb.ends_merge_round_plain(
                    ends[b0:b1], parts[b0:b1], s0,
                    *[t.clone() for t in state])
                state = rpb.ends_merge_round(ends[b0:b1], parts[b0:b1], s0,
                                             *state)
                assert_equal(f"ends_merge_round ring {family} n={n} shard "
                             f"[{s0}, {s1}) block [{b0}, {b1})", state, want)
            assert_equal(f"ends_merge_round ring {family} n={n} shard "
                         f"[{s0}, {s1}) vs one round", state,
                         [t[s0:s1] for t in whole])
        torch.cuda.synchronize()
        log(f"ends_merge_round ring feed {family} n={n}: {blocks} blocks "
            f"into {shards} shards, every round == plain, shards == one "
            f"round (rounds below/above/across a shard: {kinds})")
    return errs


def phase_compact_repeats(dev, seed: int, card: str) -> None:
    """``compact`` ``COMPACT_REPEATS`` times on one heavy-tailed input at
    2^20 and at 2^24: the same bits as the plain version every time, then
    its device time beside its bound."""
    for n in (N, N_MANY_TILES):
        ends, x = edge_inputs(("heavy", n, 5), dev, seed)
        want = rp4.compact_plain(ends, x)
        for rep in range(COMPACT_REPEATS):
            assert_equal(f"compact n={n}, repeat {rep}",
                         rp4.compact(ends, x), want)
        m = int(want[3].item())
        del want
        k1, k2 = (device_ms(lambda: rp4.compact(ends, x), reps=10)
                  for _ in range(2))
        bound = least_time(4 * n + 20 * m + (8 + 20) * n, 2 * n)
        log(f"compact n={n}: {COMPACT_REPEATS} repeats == plain; kernel "
            f"{k1:.4f}/{k2:.4f} ms (device time, mean of 10, {card}); "
            f"bound {bound[0]:.4f} ms ({bound[1]}; {m} survivors)")


def phase_kernels_vs_plain(dev, seed: int) -> dict[str, float]:
    errs = {name: 0.0 for name in ("expand", "compact")}
    rng = np.random.default_rng(seed)
    for n in (4096, 5001, N):
        for family in FAMILIES:
            x = torch.from_numpy(
                rng.standard_normal((5, n)).astype(np.float32)).to(dev)
            w = family_weights(family, n, rng, dev)
            r = torch.tensor(np.float32(rng.random()), device=dev)
            ends = ends_from_weights(w, r)
            got = rp4.compact(ends, x)
            want = rp4.compact_plain(ends, x)
            assert_equal(f"compact n={n} {family}", got, want)
            errs["compact"] = max(errs["compact"], max_abs_err(got, want))
            for route, args in (("compacted", got[:3]), ("direct", (ends, x))):
                g = rp4.expand(*args)
                p = rp4.expand_plain(*args)
                assert_equal(f"expand n={n} {family} {route}", g, p)
                errs["expand"] = max(errs["expand"], max_abs_err(g, p))
            torch.cuda.synchronize()
            log(f"kernels == plain: n={n} {family} "
                f"(survivors {int(got[3].item())})")
    return errs


def phase_counter_draw(dev, card: str):
    """``counter_draw`` against its plain version on ``rig.COUNTER_CASES``:
    the production kernel's uniforms bit-equal and its normals within
    ``counter_draw.NORMAL_ATOL``, the verification hook's Philox words
    bit-equal; slices that concatenate bit-equal to the whole draw, in
    both layouts; then timed at the sharded flat step's draw (a rank's
    2^20 samples, nx = 5, rows) and the GSUKF step's (2^18 x 11,
    lanes-last), each beside its bound, the first design's time and
    ``torch.randn`` plus ``torch.rand`` of the same shape. Returns
    ``(max |error|, (ms, plain ms), bound, library ms)`` of the flat
    step's draw; its launches here are not counted."""
    key = torch.tensor(COUNTER_KEY, dtype=torch.int64, device=dev)
    err = 0.0
    for start, count, nx, lanes in rig.COUNTER_CASES:
        eps, u = cdraw.counter_draw(key, start, count, nx, lanes)
        w = cdraw.counter_words(key, start, count, nx)
        p_eps, p_u, p_w = cdraw.counter_draw_plain(key, start, count, nx,
                                                   lanes, words=True)
        if not torch.equal(w.to(torch.int64) & cdraw.MASK32, p_w):
            raise AssertionError(f"counter_draw {start}+{count}: words differ")
        if not torch.equal(u, p_u):
            raise AssertionError(f"counter_draw {start}+{count}: uniforms "
                                 f"differ")
        e = float((eps - p_eps).abs().max())
        if not e <= cdraw.NORMAL_ATOL:
            raise AssertionError(f"counter_draw {start}+{count}: normals "
                                 f"{e} apart (tolerance "
                                 f"{cdraw.NORMAL_ATOL})")
        err = max(err, e)
        log(f"counter_draw == plain: samples [{start}, {start + count}), "
            f"nx={nx} (kernel NX={cdraw.kernel_nx(nx)}), "
            f"{'lanes-last' if lanes else 'rows'}: words and uniforms "
            f"bit-equal, normals within {e:.3g}")
    cuts = (0, 1, 4097, N_W2 // 2 + 7, N_W2 - 3, N_W2)
    for lanes in (False, True):
        whole = cdraw.counter_draw(key, 0, N_W2, 5, lanes)
        parts = [cdraw.counter_draw(key, a, b - a, 5, lanes)
                 for a, b in zip(cuts[:-1], cuts[1:])]
        joined = (torch.cat([p[0] for p in parts], dim=int(lanes)),
                  torch.cat([p[1] for p in parts]))
        assert_equal(f"counter_draw slices {cuts}", joined, whole)
    log(f"counter_draw: slices {cuts} of {N_W2} samples == the whole draw "
        f"bit for bit, rows and lanes-last")
    out = {}
    for layout, count, lanes in (("rows", N, False),
                                 ("lanes-last", N_BANK * 11, True)):
        shape = (5, count) if lanes else (count, 5)
        bound = least_time(cdraw.draw_bytes(count, 5),
                           cdraw.draw_ops(count, 5))
        args = (key, 0, count, 5, lanes)
        times = time_pair(
            f"counter_draw {layout} {count}",
            lambda a=args: cdraw.counter_draw(*a),
            lambda a=args: cdraw.counter_draw_plain(*a),
            card, bound, before=ONE_THREAD_PER_SAMPLE_MS[layout])
        library_ms = device_ms(lambda a=(shape, count): (
            torch.randn(a[0], device=dev), torch.rand((a[1],), device=dev)))
        log(f"time counter_draw {layout} {count}: torch.randn + torch.rand "
            f"of the same shape {library_ms:.4f} ms ({card})")
        out[layout] = times, bound, library_ms
    zero_counts()
    return (err, *out["rows"])


def einsum_pdf(meas: GaussianSum, x, scale):
    """The update's density as the port computed it before
    ``ops/mixture_pdf``: the einsum (cuBLAS's batched gemv on the card)
    and its elementwise tail, times the prior weights; timed as
    ``mixture_pdf``'s ``library_ms``, never called by the port."""
    es = x[..., None, :] - meas.means
    quad = torch.einsum("...di,dij,...dj->...d", es, meas.inv_cov, es)
    comp = torch.exp(meas.log_const - 0.5 * quad)
    return scale * torch.sum(meas.weights * comp, dim=-1)


def phase_mixture_pdf(dev, card: str):
    """``mixture_pdf`` against ``GaussianSum.pdf_t`` on the card, bit for
    bit, at the filters' inputs on the bench rig's measurement mixture:
    the residual ``z - g(x.T).T`` (a column-major view) of 2^20 particles
    (the flat PF's) and of 2^18 (the GSUKF's Gaussians), bare and scaled
    by prior weights; a mixture of 3 components over 5 outputs on rows;
    the log mode against the plain version on the CPU within
    ``LOG_ATOL``/``LOG_RTOL``, out to far points where ``pdf`` underflows
    to 0 (some must).
    Then timed at both inputs, fresh ones each call (out of the L2),
    beside the bound, the plain version and the einsum the port called
    before (``einsum_pdf``). Returns ``(max |error| of the log mode, (ms,
    plain ms), bound, library ms)`` at 2^20; its launches here are not
    counted."""
    x0, _, meas = harness_rig(dev)
    params = (meas.means, meas.inv_cov, meas.log_const, meas.weights)
    z = bio.static_outputs(torch.from_numpy(X_SS)).to(torch.float32).to(dev)
    gen = torch.Generator(device=dev).manual_seed(31)
    err = 0.0

    def residual(n):
        parts = x0.draw(gen, (n,))
        return z - bio.static_outputs(parts.T).T

    for n in (N, N_BANK):
        resid = residual(n)
        if resid.is_contiguous():
            raise AssertionError("mixture_pdf: the residual is contiguous")
        w = torch.rand((n,), generator=gen, device=dev)
        assert_equal(f"mixture_pdf n={n} vs pdf_t", (meas.pdf(resid),),
                     (meas.pdf_t(resid.T),))
        assert_equal(f"mixture_pdf n={n} scaled vs pdf_t",
                     (meas.pdf(resid, scale=w),),
                     (w * meas.pdf_t(resid.T),))
        far = 40.0 * resid
        log_got = meas.logpdf(far).cpu()
        log_want = mpdf.mixture_pdf_plain(
            far.cpu(), *(p.cpu() for p in params), log=True)
        if not torch.isfinite(log_got).all():
            raise AssertionError(f"mixture_pdf n={n}: a non-finite log")
        torch.testing.assert_close(log_got, log_want, rtol=mpdf.LOG_RTOL,
                                   atol=mpdf.LOG_ATOL)
        err = max(err, float((log_got - log_want).abs().max()))
        zeros = int((meas.pdf(far) == 0).sum())
        if zeros == 0:
            raise AssertionError(f"mixture_pdf n={n}: no far row underflows "
                                 "pdf to 0, so the log mode's finite "
                                 "far values went unchecked")
        log(f"mixture_pdf == pdf_t bit for bit at n={n} (column-major "
            f"residual, bare and scaled); log mode within {err:.3g} of the "
            f"plain version on the CPU, {zeros} far rows where pdf is 0")
    rng = np.random.default_rng(3)
    a = rng.standard_normal((3, 5, 5))
    wide = GaussianSum.create(rng.standard_normal((3, 5)),
                              a @ a.transpose(0, 2, 1) + 5 * np.eye(5),
                              rng.random(3) + 0.1, device=dev)
    rows = torch.randn((5, 1000003), generator=gen, device=dev).T
    assert_equal("mixture_pdf run-time size (3 x 5) vs pdf_t",
                 (wide.pdf(rows),), (wide.pdf_t(rows.T),))
    log("mixture_pdf == pdf_t bit for bit on 3 components over 5 outputs, "
        "1000003 rows")
    out = {}
    for n in (N, N_BANK):
        def setup(n=n):
            return residual(n), torch.rand((n,), generator=gen, device=dev)

        bound = least_time(mpdf.pdf_bytes(n, 2), mpdf.pdf_ops(n, 2, 2))
        times = time_pair(
            f"mixture_pdf {n}", lambda x, w: meas.pdf(x, scale=w),
            lambda x, w: mpdf.mixture_pdf_plain(x, *params, scale=w),
            card, bound, setup=setup)
        library_ms = device_ms(lambda x, w: einsum_pdf(meas, x, w),
                               setup=setup)
        log(f"time mixture_pdf {n}: the einsum path the port called before "
            f"{library_ms:.4f} ms ({card})")
        out[n] = times, bound, library_ms
    zero_counts()
    return (err, *out[N])


def phase_merge_kernels_vs_plain(dev, seed: int) -> dict[str, float]:
    """``ends_merge_round`` at 5 and 30 payload columns, ``cumsum_merge``
    at 5 and 8 rows, ``coarse_gather`` at 5 and 6 rows, against their
    plain versions; then four ascending source blocks into four shards
    (``slot0`` offsets) against one round over the whole pool."""
    errs = {"ends_merge_round": 0.0, "cumsum_merge": 0.0,
            "coarse_gather": 0.0}
    rng = np.random.default_rng(seed + 1)
    for n in (4096, 5120, N):
        for family in FAMILIES:
            w = family_weights(family, n, rng, dev)
            r = torch.tensor(np.float32(rng.random()), device=dev)
            ends = ends_from_weights(w, r)
            cs = rp3.normalized_cumsum(w, r)
            for nx in (5, 30):
                parts = randn(rng, (n, nx), dev)
                got = rpb.ends_merge_round(
                    ends, parts, 0, *rpb.block_resample_state(n, nx, dev))
                want = rpb.ends_merge_round_plain(
                    ends, parts, 0, *rpb.block_resample_state(n, nx, dev))
                assert_equal(f"ends_merge_round n={n} {family} nx={nx}",
                             got, want)
                errs["ends_merge_round"] = max(errs["ends_merge_round"],
                                               max_abs_err(got, want))
            for rows in (5, 8):
                payload = randn(rng, (rows, n), dev)
                got = rp3.cumsum_merge(cs, payload, r)
                want = rp3.cumsum_merge_plain(cs, payload, r)
                assert_equal(f"cumsum_merge n={n} {family} rows={rows}",
                             got, want)
                errs["cumsum_merge"] = max(errs["cumsum_merge"],
                                           max_abs_err(got, want))
            o = rc.chunk_boundaries(ends, n)
            for rows in (5, 6):
                payload = randn(rng, (rows, n), dev)
                got = rc.coarse_gather(ends, o, payload)
                want = rc.coarse_gather_plain(ends, o, payload)
                assert_equal(f"coarse_gather n={n} {family} rows={rows}",
                             got, want)
                errs["coarse_gather"] = max(errs["coarse_gather"],
                                            max_abs_err(got, want))
            torch.cuda.synchronize()
            log(f"merge kernels == plain: n={n} {family} (ends_merge_round "
                f"at 5 and 30 columns, cumsum_merge at 5 and 8 rows, "
                f"coarse_gather at 5 and 6 rows)")
    w = family_weights("heavy", N, rng, dev)
    ends = ends_from_weights(w, torch.tensor(np.float32(0.37), device=dev))
    parts = randn(rng, (N, 5), dev)
    whole = rpb.ends_merge_round(ends, parts, 0,
                                 *rpb.block_resample_state(N, 5, dev))
    q = 4
    n_blk = n_local = N // q
    for shard in range(q):
        state = rpb.block_resample_state(n_local, 5, dev)
        for b in range(q):
            sl = slice(b * n_blk, (b + 1) * n_blk)
            state = rpb.ends_merge_round(ends[sl], parts[sl],
                                         shard * n_local, *state)
        rows = slice(shard * n_local, (shard + 1) * n_local)
        assert_equal(f"ends_merge_round four-block feed, shard {shard}",
                     state, [t[rows] for t in whole])
    torch.cuda.synchronize()
    log(f"ends_merge_round: four ascending blocks into four shards == one "
        f"round over n={N} (bit-equal)")
    return errs


def phase_fixture(dev) -> None:
    d = np.load(FIXTURE)
    meas = convert.gaussian_sum_from_numpy(
        *(d[f"meas_{f}"] for f in ("means", "covariances", "weights", "chol",
                                   "inv_cov", "log_const")), device=dev)

    def t(name):
        return torch.from_numpy(d[name]).to(dev)

    for regime in ("heavy", "near_uniform"):
        args = (t("x_in"), t("u"), t(f"{regime}_z"), t("dt"),
                bio.homeostatic_des, bio.static_outputs, meas)
        xn, w = pft.predict_update_local(*args, t("noise"))
        want_w = d[f"{regime}_w"]
        w_rel = float(np.max(np.abs(w.cpu().numpy() - want_w) / want_w))
        if not w_rel <= W_RTOL:
            raise AssertionError(f"fixture {regime}: weights off by {w_rel}")
        want = d[f"{regime}_x_out"]
        out, _ = rp4.resample_core(xn, t(f"{regime}_ends"))
        if not np.array_equal(out.cpu().numpy(), want):
            raise AssertionError(
                f"fixture {regime}: resample given the reference's ends "
                f"differs from the reference")
        got = pft.step_from_noise(*args, t("noise"), t("r")).cpu().numpy()
        rows = int(np.count_nonzero(np.any(got != want, axis=0)))
        if rows > STEP_TIE_ROWS:
            raise AssertionError(f"fixture {regime}: {rows} rows differ")
        log(f"fixture {regime}: weights rel err {w_rel:.3g} "
            f"(<= {W_RTOL}); resample given reference ends bit-equal; "
            f"step rows differing {rows} (<= {STEP_TIE_ROWS})")
        # the flat filter's step on the same inputs: uniform incoming
        # weights (exact at a power-of-two n), (n, nx) layout
        x, noise = t("x_in").T.contiguous(), t("noise").T.contiguous()
        n = x.shape[0]
        w_in = torch.full((n,), 1.0 / n, device=dev)
        # the coarse gate takes n >= 2^13 only: at 4096 it is the plain route
        for route in (r for r in ROUTE_KERNELS if r != "coarse"):
            with rs.impl(route):
                got, _ = pf.step_from_noise(
                    x, w_in, t("u"), t(f"{regime}_z"), t("dt"),
                    bio.homeostatic_des, bio.static_outputs, meas, noise,
                    t("r"))
            rows = int(np.count_nonzero(np.any(
                got.cpu().numpy() != want.T, axis=1)))
            if rows > STEP_TIE_ROWS:
                raise AssertionError(
                    f"fixture {regime}: flat step, route {route}: {rows} "
                    f"rows differ")
            log(f"fixture {regime}: flat step through route {route}: rows "
                f"differing {rows} (<= {STEP_TIE_ROWS})")


def phase_fixture_gsukf(dev) -> dict[str, float]:
    """The CUDA GSUKF step and the CUDA v2 entry against the committed
    reference (``tests/data/torch_parity_gsukf.npz``): means bit-equal,
    weights within ``W_RTOL``, covariances exactly symmetric; the bank
    resample given the reference's ``ends`` bit-equal; the whole step, on
    the card's own ``ends``, within ``STEP_TIE_ROWS`` rows; the v2 entry
    bit-equal on integer weights."""
    d = np.load(GSUKF_FIXTURE)
    meas = convert.gaussian_sum_from_numpy(
        *(d[f"meas_{f}"] for f in ("means", "covariances", "weights", "chol",
                                   "inv_cov", "log_const")), device=dev)

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(dev)

    n = d["means_in"].shape[0]
    noise = t(rig.gsukf_noise(d["noise_sd"], n, int(d["noise_seed"])))
    f, g = bio.homeostatic_des, bio.static_outputs
    means, covs = gsf.predict_core(t(d["means_in"]), t(d["covs_in"]),
                                   t(d["u"]), t(d["dt"]), noise, f,
                                   noise_is_lanes=True)
    means, covs, w = gsf.update_core(means, covs, t(d["w_in"]), t(d["u"]),
                                     t(d["z"]), g, meas)
    if not torch.equal(covs, covs.mT):
        raise AssertionError("GSUKF fixture: covariances not symmetric")
    m_off = int(np.count_nonzero(means.cpu().numpy() != d["upd_means"]))
    if m_off:
        raise AssertionError(f"GSUKF fixture: {m_off} updated means differ")
    w_rel = float(np.max(np.abs(w.cpu().numpy() - d["upd_w"]) / d["upd_w"]))
    if not w_rel <= W_RTOL:
        raise AssertionError(f"GSUKF fixture: weights off by {w_rel}")
    ti, tj = torch.triu_indices(5, 5, device=dev)
    payload = torch.cat([means.T, covs[:, ti, tj].T]).contiguous()
    out, _ = rp4.resample_core(payload, t(d["ends"]))
    if not np.array_equal(out[:5].T.cpu().numpy(), d["out_means"]):
        raise AssertionError("GSUKF fixture: bank resample given the "
                             "reference's ends differs")
    (m2, c2), _ = gsf.step_from_noise(
        t(d["means_in"]), t(d["covs_in"]), t(d["w_in"]), t(d["u"]),
        t(d["z"]), t(d["dt"]), f, g, meas, noise, t(d["r"]),
        noise_is_lanes=True)
    rows = int(np.count_nonzero(
        np.any(m2.cpu().numpy() != d["out_means"], axis=1)
        | np.any(c2.cpu().numpy() != d["out_covs"], axis=(1, 2))))
    if rows > STEP_TIE_ROWS:
        raise AssertionError(f"GSUKF fixture: step, {rows} rows differ")
    parts, w2, r2 = rig.v2_case(n, int(d["v2_seed"]))
    zero_counts()
    got = rp2.fused_systematic_resample_v2(
        t(parts), t(w2), torch.tensor(r2, device=dev),
        window=int(d["v2_window"]), block=int(d["v2_block"]))
    torch.cuda.synchronize()
    expect_counts("v2 fixture", read_counts(), {"compact": 1, "expand": 1},
                  tally=False)
    if not np.array_equal(got.cpu().numpy(), d["v2_out"]):
        raise AssertionError("v2 fixture: the CUDA entry differs from the "
                             "reference")
    log(f"fixture GSUKF: updated means bit-equal, weights rel err "
        f"{w_rel:.3g} (<= {W_RTOL}), covariances symmetric; bank resample "
        f"given reference ends bit-equal; step rows differing {rows} (<= "
        f"{STEP_TIE_ROWS}); v2 entry bit-equal to the reference")


def phase_main_path(dev, seed: int, card: str):
    x0, state_pdf, meas_pdf = bench_rig(dev)
    u = torch.tensor([0.06, 0.2], dtype=torch.float32, device=dev)
    z = bio.static_outputs(torch.from_numpy(X_SS)).to(torch.float32).to(dev)
    dt = 0.1
    f, g = bio.homeostatic_des, bio.static_outputs
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = pft.init(gen, N, x0)
    # the counterpart of bench.py's jax.jit(step): one graph replay a step
    step_g = pft.graphed_step()

    def step(s):
        return step_g(s, u, z, dt, f, g, state_pdf, meas_pdf)

    zero_counts()
    state = step(state)                       # warm-up and capture
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(STEPS):
        state = step(state)
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    expect_counts("tiled main path", launches,
                  {"compact": STEPS + 1, "expand": STEPS + 1})
    est = pft.point_estimate(state)
    if not (torch.isfinite(state.x).all() and torch.isfinite(est).all()):
        raise AssertionError("non-finite state or point estimate")
    if state.x.shape != (5, N):
        raise AssertionError(f"state shape {tuple(state.x.shape)}")
    ms_per_step = start.elapsed_time(end) / STEPS
    log(f"main path: {STEPS} chained graphed steps at n={N}: "
        f"{ms_per_step:.4f} ms/step (CUDA events), host wall "
        f"{wall_s / STEPS * 1e3:.4f} ms/step; launches {launches} (the "
        f"warm-up's, then {step_g.replays} replays'); point estimate "
        f"{[round(v, 5) for v in est.tolist()]}")

    # one step through the kernels vs the same step through the plain
    # resample, same noise and r
    x = state.x
    noise = state_pdf.draw_t(gen, N)
    r = torch.rand((), generator=gen, device=dev)
    got = pft.step_from_noise(x, u, z, dt, f, g, meas_pdf, noise, r)
    xn, w = pft.predict_update_local(x, u, z, dt, f, g, meas_pdf, noise)
    ends = ends_from_weights(w, r)
    want, _ = rp4.resample_core_plain(xn, ends)
    if not torch.equal(got, want):
        raise AssertionError("kernel step != plain-resample step")
    c_keys, c_payload, c_idx, count = rp4.compact(ends, xn)
    log(f"main path: kernel step == plain-resample step (bit-equal); "
        f"survivors {int(count.item())} of {N}")

    # per-stage and per-kernel times at the main path's inputs
    stage = {
        "noise draw": lambda: state_pdf.draw_t(gen, N),
        "predict+update": lambda: pft.predict_update_local(
            x, u, z, dt, f, g, meas_pdf, noise),
        "ends": lambda: ends_from_weights(w, r),
        "compact": lambda: rp4.compact(ends, xn),
        "expand": lambda: rp4.expand(c_keys, c_payload, c_idx),
    }
    for name, fn in stage.items():
        log(f"stage {name}: {time_ms(fn):.4f} ms (median of {REPS}, "
            f"synchronised, {card})")
    errs = {
        "compact": max_abs_err(rp4.compact(ends, xn),
                               rp4.compact_plain(ends, xn)),
        "expand": max_abs_err(rp4.expand(c_keys, c_payload, c_idx),
                              rp4.expand_plain(c_keys, c_payload, c_idx)),
    }
    pairs = {
        "compact": (lambda: rp4.compact(ends, xn),
                    lambda: rp4.compact_plain(ends, xn)),
        "expand": (lambda: rp4.expand(c_keys, c_payload, c_idx),
                   lambda: rp4.expand_plain(c_keys, c_payload, c_idx)),
        "expand direct route": (lambda: rp4.expand(ends, xn),
                                lambda: rp4.expand_plain(ends, xn)),
    }
    times = {}
    for name, (kern, plain) in pairs.items():
        # plain, kernel, kernel, plain
        p1, k1, k2, p2 = (device_ms(plain), device_ms(kern), device_ms(kern),
                          device_ms(plain))
        times[name] = (min(k1, k2), min(p1, p2))
        log(f"time {name}: kernel {k1:.4f}/{k2:.4f} ms, plain "
            f"{p1:.4f}/{p2:.4f} ms (device time, mean of {REPS}, {card})")
    log(f"resample routes: compacted (compact + expand) "
        f"{times['compact'][0] + times['expand'][0]:.4f} ms, direct "
        f"(expand on ends) {times['expand direct route'][0]:.4f} ms "
        f"({card})")
    m = int(count.item())
    # compact reads ends and the survivors' payload columns, writes keys,
    # indices and payload of every entry; the memset of its look-back
    # words (8 bytes per 2048 entries) is left out as negligible
    bounds = {"compact": least_time(4 * N + 20 * m + (8 + 20) * N, 2 * N),
              "expand": expand_bound(N, m, 5, rp4.EXPAND_BLOCK)}
    log(f"bounds: compact {bounds['compact'][0]:.4f} ms, expand "
        f"{bounds['expand'][0]:.4f} ms ({bounds['expand'][1]}; {m} "
        f"survivors of {N}, {card})")

    metric = {
        "metric": "pf_full_step_throughput_2^20_particles",
        "value": 1e3 / ms_per_step, "unit": "steps/s",
        "ms_per_step": ms_per_step, "steps": STEPS, "seed": seed,
        "card": card,
    }
    return errs, times, metric, bounds


def phase_flat_pf(dev, seed: int, card: str):
    """The flat ``ParticleFilter`` at 2^20 particles on the closed loop's
    configuration, through the entry points a user calls. Returns a
    predicted-and-updated state and ``r`` for the kernel timings."""
    x0, state_pdf, meas_pdf = harness_rig(dev)
    f, g = bio.homeostatic_des, bio.static_outputs
    u = torch.tensor([0.06, 0.2], dtype=torch.float32, device=dev)
    z = bio.static_outputs(torch.from_numpy(X_SS)).to(torch.float32).to(dev)
    dt = 0.1
    filt = pf.ParticleFilter(f, g, N, x0, state_pdf, meas_pdf, seed=seed)
    if filt.particles.shape != (N, 5) or filt.particles.device != dev:
        raise AssertionError(f"particles {tuple(filt.particles.shape)} on "
                             f"{filt.particles.device}")

    def run(route: str, steps: int, warm: int = 0):
        zero_counts()
        with rs.impl(route):
            for _ in range(warm):
                filt.step(u, z, dt)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(steps):
                filt.step(u, z, dt)
            end.record()
            torch.cuda.synchronize()
        counts = read_counts()
        expect_counts(f"flat filter, route {route}", counts,
                      {k: warm + steps
                       for k in ROUTE_KERNELS[route] + ("mixture_pdf",)})
        est, cov = filt.moments()
        if not (torch.isfinite(filt.particles).all()
                and torch.isfinite(est).all() and torch.isfinite(cov)):
            raise AssertionError(f"flat filter, route {route}: non-finite "
                                 f"state or moments")
        ms = start.elapsed_time(end) / steps
        log(f"flat main path, route {route}: {steps} chained steps at n={N}:"
            f" {ms:.4f} ms/step (CUDA events, {card}); launches "
            f"{ {k: v for k, v in counts.items() if v} }; point estimate "
            f"{[round(v, 5) for v in est.tolist()]}, covariance "
            f"{float(cov):.6g}")

    # two warm-up steps a route: a graph's capture, and another where the
    # first step's output is laid out anew (the ends route's strided rows)
    run("auto", STEPS, warm=GRAPH_WARM)
    for route in ("ends", "v3", "pallas", "coarse"):
        run(route, ROUTE_STEPS, warm=GRAPH_WARM)

    # one step per route against the same step through the plain route
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    x, w = filt.particles, filt.weights
    noise = state_pdf.draw(gen, (N,))
    r = torch.rand((), generator=gen, device=dev)

    def one_step():
        return pf.step_from_noise(x, w, u, z, dt, f, g, meas_pdf, noise, r)[0]

    with rs.impl("xla"):
        want = one_step()
    for route in ROUTE_KERNELS:
        with rs.impl(route):
            got = one_step()
        rows = rows_differ(got, want)
        bound = 0 if route in EXACT_ROUTES else MERGE_TIE_ROWS
        if rows > bound:
            raise AssertionError(f"flat step, route {route}: {rows} rows "
                                 f"differ from the plain route")
        log(f"flat step, route {route} vs plain route: {rows} of {N} rows "
            f"differ (at most {bound})")

    state = pf.update(pf.predict(filt.state, u, torch.tensor(dt, device=dev),
                                 f, state_pdf), u, z, g, meas_pdf)
    return state, r


def phase_router_routes(dev, seed: int) -> None:
    """The router's other auto routes at full width, through
    ``systematic_resample`` and ``systematic_resample_bank``; each
    against the plain route with the same generator seed."""
    rng = np.random.default_rng(seed + 2)

    def check(name, kernels, entry, exact):
        zero_counts()
        got = entry(torch.Generator(device=dev).manual_seed(seed))
        torch.cuda.synchronize()
        expect_counts(name, read_counts(), {k: 1 for k in kernels})
        with rs.impl("xla"):
            want = entry(torch.Generator(device=dev).manual_seed(seed))
        got_l, want_l = tree_flatten(got)[0], tree_flatten(want)[0]
        rows = max(rows_differ(a, b) for a, b in zip(got_l, want_l))
        n = got_l[0].shape[0]
        if rows > (0 if exact else MERGE_TIE_ROWS):
            raise AssertionError(f"{name}: {rows} rows differ from the "
                                 f"plain route")
        log(f"router {name}: launches {kernels}; {rows} of {n} rows differ "
            f"from the plain route")

    w = family_weights("heavy", N, rng, dev)
    x8 = randn(rng, (N, 8), dev)
    check("auto (2^20, 8) payload", ("cumsum_merge",),
          lambda gen: rs.systematic_resample(x8, w, gen), exact=False)
    wb = family_weights("heavy", N_BANK, rng, dev)
    means = randn(rng, (N_BANK, 5), dev)
    a = randn(rng, (N_BANK, 5, 5), dev)
    covs = a + a.transpose(1, 2)                 # exactly symmetric
    check("auto (2^18) bank pytree", ("ends_merge_round",),
          lambda gen: rs.systematic_resample((means, covs), wb, gen),
          exact=True)
    check("systematic_resample_bank (2^18)", ("compact", "expand"),
          lambda gen: rs.systematic_resample_bank(means, covs, wb, gen),
          exact=True)

    # weights without a finite positive sum: the cumsum-merge routes on
    # the card give what they give on the CPU, one particle in every slot
    # (the CPU tests hold that to the reference's XLA route)
    x = randn(rng, (N, 5), dev)
    r = torch.tensor(np.float32(0.37), device=dev)
    for kind in rig.NO_SUM_KINDS:
        w = torch.from_numpy(rig.no_sum_weights(kind, N))
        for route in ("v3", "pallas"):
            with rs.impl(route):
                want = rs.systematic_resample_from_r(x.cpu(), w, r.cpu())[0]
                zero_counts()
                got = rs.systematic_resample_from_r(x, w.to(dev), r)[0]
                torch.cuda.synchronize()
            expect_counts(f"route {route}, {kind} weights", read_counts(),
                          {"cumsum_merge": 1})
            if not (torch.equal(got.cpu(), want)
                    and torch.equal(want, want[:1].expand(N, 5))):
                raise AssertionError(f"route {route} on {kind} weights: "
                                     f"the card differs from the CPU")
        log(f"router v3, pallas on {kind} weights at n={N}: every slot "
            f"particle {int(torch.nonzero((x.cpu() == want[0]).all(1))[0])},"
            f" the CPU's")


def ends_round_bound(n: int, m: int, nx: int):
    """Bound of one ``ends_merge_round`` over the whole pool: ``ends`` and
    the survivors' ``nx`` columns read; counts and finalized read and
    written; the ``nx`` columns of ``acc`` written (every slot finalizes
    in one round over the whole pool)."""
    return least_time(4 * n + 4 * nx * m + 16 * n + 4 * nx * n,
                      search_ops(n, n))


def survivors(ends: torch.Tensor) -> int:
    return int(torch.count_nonzero(torch.diff(ends, prepend=ends.new_full(
        (1,), -1))))


def time_pair(name: str, kern, plain, card: str, bound, setup=None,
              before: float | None = None, reps: int = REPS):
    """Plain, kernel, kernel, plain device times; logs them beside the
    bound (and the earlier kernel's time where given); returns
    ``(kernel ms, plain ms)``, the better of each two."""
    p1, k1, k2, p2 = (device_ms(plain, reps, setup),
                      device_ms(kern, reps, setup),
                      device_ms(kern, reps, setup),
                      device_ms(plain, reps, setup))
    was = ("" if before is None else
           f"; the first design took {before:.4f} ms")
    log(f"time {name}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} "
        f"ms (device time, mean of {reps}, {card}); bound {bound[0]:.4f} ms "
        f"({bound[1]}){was}")
    if min(k1, k2) < bound[0]:
        raise AssertionError(f"time {name}: {min(k1, k2):.4f} ms is under "
                             f"the least time {bound[0]:.4f} ms: the bound "
                             f"counts work the kernel need not do")
    return min(k1, k2), min(p1, p2)


def phase_merge_times(dev, card: str, state, r, seed: int):
    """The merge and coarse kernels against their plain versions at the
    flat main path's inputs: the 2^20 predicted particles and their
    weights. ``ends_merge_round`` updates its carried state in place: each
    call gets a fresh zeroed state, as ``systematic_resample_ends`` makes
    one, all made before the timed calls. Then ``ends_merge_round`` at 8
    columns on the same ``ends``, at the router's 2^18 bank tree (30
    columns, heavy-tailed weights), all three kernels on the heavy edge
    case at 2^24 (5 columns or rows), and ``coarse_gather`` on the
    one-survivor and all-survive cases at 2^24."""
    parts = state.particles.contiguous()
    ends = ends_from_weights(state.weights, r)
    cs = rp3.normalized_cumsum(state.weights, r)
    payload = parts.T.contiguous()
    o = rc.chunk_boundaries(ends, N)

    def ends_round(fn, e, x):
        n, nx = x.shape
        return lambda *st: fn(e, x, 0, *(
            st or rpb.block_resample_state(n, nx, dev)))

    def fresh(n, nx):
        return lambda: rpb.block_resample_state(n, nx, dev)

    pairs = {
        "ends_merge_round": (ends_round(rpb.ends_merge_round, ends, parts),
                             ends_round(rpb.ends_merge_round_plain, ends,
                                        parts)),
        "cumsum_merge": (lambda: rp3.cumsum_merge(cs, payload, r),
                         lambda: rp3.cumsum_merge_plain(cs, payload, r)),
        "coarse_gather": (lambda: rc.coarse_gather(ends, o, payload),
                          lambda: rc.coarse_gather_plain(ends, o, payload)),
    }
    m = survivors(ends)
    keys = searched_keys(ends)
    bounds = {
        "ends_merge_round": ends_round_bound(N, m, 5),
        # the keys are cs / ends (extra_in: those a search must read), the
        # ancestor is computed
        "cumsum_merge": gather_bound(N, m, 5, search_ops(N, N),
                                     extra_in=4 * keys, compacted=False),
        "coarse_gather": gather_bound(N, m, 5, search_ops(N, rc.BLOCK),
                                      extra_in=4 * keys + 4 * o.shape[0],
                                      compacted=False),
    }
    setups = {"ends_merge_round": fresh(N, 5)}
    errs, times = {}, {}
    for name, (kern, plain) in pairs.items():
        got, want = kern(), plain()
        assert_equal(f"{name} at the main path's inputs", got, want)
        errs[name] = max_abs_err(got, want)
        times[name] = time_pair(name, kern, plain, card, bounds[name],
                                setup=setups.get(name),
                                before=ONE_THREAD_PER_SLOT_MS.get(name))

    # the same round at 8 columns: every 32-byte row of acc written whole,
    # where at 5 columns the memory system must complete each row's sector
    x8 = randn(np.random.default_rng(seed + 3), (N, 8), dev)
    time_pair("ends_merge_round at 8 columns (whole acc rows)",
              ends_round(rpb.ends_merge_round, ends, x8),
              ends_round(rpb.ends_merge_round_plain, ends, x8), card,
              ends_round_bound(N, m, 8), setup=fresh(N, 8))
    del x8

    # expand's bracket and window (a gallop in device memory where keys
    # repeat) on the same raw ends: cumsum_merge's function with integer
    # keys, the design the merge path was held against
    time_pair("expand on the raw ends (bracket and window)",
              lambda: rp4.expand(ends, payload),
              lambda: rp4.expand_plain(ends, payload), card,
              gather_bound(N, m, 5, search_ops(N, N), extra_in=4 * keys,
                           compacted=False))

    # the router's bank tree: 5 means and 25 covariance entries a row
    w, rb = rig.edge_weights("heavy", N_BANK, seed)
    e_bank = ends_from_weights(torch.from_numpy(w).to(dev),
                               torch.tensor(rb, device=dev))
    x_bank = torch.from_numpy(rig.edge_payload(30, N_BANK, seed)).to(dev).T
    x_bank = x_bank.contiguous()
    kern = ends_round(rpb.ends_merge_round, e_bank, x_bank)
    plain = ends_round(rpb.ends_merge_round_plain, e_bank, x_bank)
    assert_equal("ends_merge_round at the bank tree", kern(), plain())
    time_pair(f"ends_merge_round bank tree n={N_BANK} nx=30 "
              f"({survivors(e_bank)} survivors)", kern, plain, card,
              ends_round_bound(N_BANK, survivors(e_bank), 30),
              setup=fresh(N_BANK, 30))
    del e_bank, x_bank

    # the heavy edge case at 2^24
    n = N_MANY_TILES
    w, rh = rig.edge_weights("heavy", n, seed)
    w = torch.from_numpy(w).to(dev)
    rh = torch.tensor(rh, device=dev)
    e_big = ends_from_weights(w, rh)
    cs_big = rp3.normalized_cumsum(w, rh)
    p_big = torch.from_numpy(rig.edge_payload(5, n, seed)).to(dev)
    x_big = p_big.T.contiguous()
    m_big = survivors(e_big)
    kern = ends_round(rpb.ends_merge_round, e_big, x_big)
    plain = ends_round(rpb.ends_merge_round_plain, e_big, x_big)
    assert_equal("ends_merge_round at 2^24", kern(), plain())
    # 10 calls: each keeps a fresh 640 MB state
    time_pair(f"ends_merge_round heavy n={n} nx=5 ({m_big} survivors)",
              kern, plain, card, ends_round_bound(n, m_big, 5),
              setup=fresh(n, 5), reps=10)

    def kern_b():
        return rp3.cumsum_merge(cs_big, p_big, rh)

    def plain_b():
        return rp3.cumsum_merge_plain(cs_big, p_big, rh)

    assert_equal("cumsum_merge at 2^24", kern_b(), plain_b())
    time_pair(f"cumsum_merge heavy n={n} rows=5 ({m_big} survivors)",
              kern_b, plain_b, card,
              gather_bound(n, m_big, 5, search_ops(n, n),
                           extra_in=4 * searched_keys(e_big),
                           compacted=False), reps=10)
    del cs_big, x_big

    # coarse_gather at 2^24: heavy tails, then one survivor (the last
    # chunk's window holds every key from the survivor on) against every
    # entry surviving (exact ends, one key a slot)
    coarse_ms = {}
    for family in ("heavy", "one_survivor", "all_survive"):
        if family != "heavy":
            e_big, p_big = edge_inputs((family, n, 5), dev, seed)
        o_big = rc.chunk_boundaries(e_big, n)
        m_c = survivors(e_big)

        def kern_c(e=e_big, ob=o_big, p=p_big):
            return rc.coarse_gather(e, ob, p)

        def plain_c(e=e_big, ob=o_big, p=p_big):
            return rc.coarse_gather_plain(e, ob, p)

        assert_equal(f"coarse_gather {family} at 2^24", kern_c(), plain_c())
        coarse_ms[family] = time_pair(
            f"coarse_gather {family} n={n} rows=5 ({m_c} survivors, longest "
            f"chunk window {int(torch.diff(o_big).max())} keys)",
            kern_c, plain_c, card,
            gather_bound(n, m_c, 5, search_ops(n, rc.BLOCK),
                         extra_in=4 * searched_keys(e_big)
                         + 4 * o_big.shape[0],
                         compacted=False),
            reps=10)[0]
    log(f"coarse_gather at 2^24: one survivor / all survive "
        f"{coarse_ms['one_survivor'] / coarse_ms['all_survive']:.3f} "
        f"({card})")
    return errs, times, bounds


def busy_ms(prof) -> tuple[float, float, int, dict[str, float]]:
    """Device time seen by ``prof``: ``(busy, span, ops, per_name)``, with
    busy the union of the device ops' intervals, span from the first
    op's start to the last op's end (both ms), ops their count, and
    per_name each op name's summed duration (ms)."""
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not evs:
        return 0.0, 0.0, 0, {}
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs)
    per_name: dict[str, float] = {}
    for e in evs:
        per_name[e.name] = (per_name.get(e.name, 0.0)
                            + (e.time_range.end - e.time_range.start) / 1e3)
    return (union_ms(spans), (max(e for _, e in spans) - spans[0][0]) / 1e3,
            len(evs), per_name)


def phase_profile(dev, seed: int, card: str) -> None:
    """Where the flat step's time goes. Stage times at the flat main
    path's inputs (median of 30, each call synchronised, so host launch
    latency is in them), then ``torch.profiler`` over ``ROUTE_STEPS``
    chained steps per route: device ops per step, busy share (the union
    of device-op intervals over their span) and the five op names with
    most device time."""
    from torch.profiler import ProfilerActivity, profile

    x0, state_pdf, meas_pdf = harness_rig(dev)
    f, g = bio.homeostatic_des, bio.static_outputs
    u = torch.tensor([0.06, 0.2], dtype=torch.float32, device=dev)
    z = bio.static_outputs(torch.from_numpy(X_SS)).to(torch.float32).to(dev)
    dt = torch.tensor(0.1, device=dev)
    filt = pf.ParticleFilter(f, g, N, x0, state_pdf, meas_pdf, seed=seed)
    filt.step(u, z, dt)
    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    state = filt.state
    noise = state_pdf.draw(gen, (N,))
    pred = pf.predict(state, u, dt, f, state_pdf)
    upd = pf.update(pred, u, z, g, meas_pdf)
    r = torch.rand((), generator=gen, device=dev)

    def routed(route):
        def call():
            with rs.impl(route):
                rs.systematic_resample_from_r(upd.particles, upd.weights, r)
        return call

    stages = {
        "noise draw": lambda: state_pdf.draw(gen, (N,)),
        "predict": lambda: pf.predict_from_noise(state.particles, u, dt, f,
                                                 noise),
        "update": lambda: pf.update(pred, u, z, g, meas_pdf),
        "moments": lambda: (pf.point_estimate(upd),
                            pf.point_covariance(upd)),
    }
    for route in ("auto", "ends", "v3", "pallas", "coarse", "xla"):
        stages[f"resample {route}"] = routed(route)
    for name, fn in stages.items():
        log(f"profile stage {name}: {time_ms(fn):.4f} ms (median of {REPS}, "
            f"synchronised, {card})")

    for route in ("auto", "ends", "v3", "coarse"):
        with rs.impl(route):
            for _ in range(GRAPH_WARM):
                filt.step(u, z, dt)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(ROUTE_STEPS):
                    filt.step(u, z, dt)
                torch.cuda.synchronize()
        busy, span, ops, per_name = busy_ms(prof)
        if not ops:
            log(f"profile route {route}: the profiler saw no device time")
            continue
        top = sorted(per_name.items(), key=lambda kv: -kv[1])[:5]
        log(f"profile route {route}: {ops / ROUTE_STEPS:.1f} device ops/step,"
            f" busy {busy / ROUTE_STEPS:.4f} of span {span / ROUTE_STEPS:.4f}"
            f" ms/step (busy share {busy / span:.3f}; {card}); top: "
            + "; ".join(f"{name[:60]} {ms / ROUTE_STEPS:.4f} ms/step "
                        f"({ms / busy:.3f})" for name, ms in top))


def phase_v2_path(dev, seed: int, card: str):
    """The flat PF step of ``scripts/bench_v2.py`` through
    ``fused_systematic_resample_v2`` at 2^20 on the bench rig, in each of
    its geometries, eager; then, as ``bench_v2.py`` jits it, the step as
    one graph replay (``graphs.Graphed``) held bit-equal to the eager
    chain and timed against it. Returns ``expand``'s error against its
    plain version at each of the path's block sizes."""
    x0, state_pdf, meas_pdf = bench_rig(dev)
    f, g = bio.homeostatic_des, bio.static_outputs
    u = torch.tensor([0.06, 0.2], dtype=torch.float32, device=dev)
    z = bio.static_outputs(torch.from_numpy(X_SS)).to(torch.float32).to(dev)
    dt = torch.tensor(0.1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    state = pf.init(gen, N, x0)
    uniform = torch.full((N,), 1.0 / N, device=dev)

    def predict_update(s):
        return pf.update(pf.predict(s, u, dt, f, state_pdf), u, z, g,
                         meas_pdf)

    def step(s, window, block):
        s = predict_update(s)
        r = torch.rand((), generator=s.generator, device=dev)
        parts = rp2.fused_systematic_resample_v2(s.particles, s.weights, r,
                                                 window=window, block=block)
        return pf.PFState(parts, uniform, s.generator)

    for window, block in V2_GEOMETRIES:
        zero_counts()
        state = step(state, window, block)            # warm-up
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ROUTE_STEPS):
            state = step(state, window, block)
        end.record()
        torch.cuda.synchronize()
        counts = read_counts()
        expect_counts(f"v2 path W={window} B={block}", counts,
                      {"compact": ROUTE_STEPS + 1, "expand": ROUTE_STEPS + 1,
                       "mixture_pdf": ROUTE_STEPS + 1})
        est = pf.point_estimate(state)
        if not (torch.isfinite(state.particles).all()
                and torch.isfinite(est).all()):
            raise AssertionError(f"v2 path W={window} B={block}: non-finite")
        if state.particles.shape != (N, 5):
            raise AssertionError(f"v2 path: particles "
                                 f"{tuple(state.particles.shape)}")
        log(f"v2 path W={window} B={block}: {ROUTE_STEPS} chained steps at "
            f"n={N}: {start.elapsed_time(end) / ROUTE_STEPS:.4f} ms/step "
            f"(CUDA events, {card}); launches "
            f"{ {k: v for k, v in counts.items() if v} }; point estimate "
            f"{[round(v, 5) for v in est.tolist()]}")

    # the step graphed, as bench_v2.py jits it: each geometry's graph
    # against the eager chain from the same state and generator state
    step_g = graphs.Graphed(step)
    v2_times = {}
    for window, block in V2_GEOMETRIES:
        path = f"step W={window} B={block}"
        zero_counts()
        a, b = chained_pair(path, lambda s: step_g(s, window, block), state,
                            ROUTE_STEPS, "v2", step_g)
        expect_counts(f"{path}, graphed and eager", read_counts(),
                      {"compact": 2 * ROUTE_STEPS, "expand": 2 * ROUTE_STEPS,
                       "mixture_pdf": 2 * ROUTE_STEPS})
        v2_times[path] = timed_pair(path,
                                    lambda s: step_g(s, window, block), a, b,
                                    card, GRAPH_TIMED, "v2", step_g)
        state = a
    if step_g.captures != len(V2_GEOMETRIES):
        raise AssertionError(f"v2: {step_g.captures} captures")
    log(f"v2 path: the step graphed bit-equal to eager over {ROUTE_STEPS} "
        f"chained steps in each geometry, one capture each; pool "
        f"{step_g.pool_bytes() / 2**20:.1f} MiB ({card})")
    step_g.clear()

    # one step against the plain route: the same r, the same ends
    upd = predict_update(state)
    r = torch.rand((), generator=gen, device=dev)
    ends = ends_from_weights(upd.weights, r)
    payload = upd.particles.T.contiguous()
    c_plain = rp4.compact_plain(ends, payload)
    want = rp2.expand_plain(*c_plain[:3])[0].T
    for window, block in V2_GEOMETRIES:
        got = rp2.fused_systematic_resample_v2(upd.particles, upd.weights, r,
                                               window=window, block=block)
        if not torch.equal(got, want):
            raise AssertionError(f"v2 step W={window} B={block} != the "
                                 f"plain route")
    log(f"v2 step == plain route (bit-equal) in all "
        f"{len(V2_GEOMETRIES)} geometries")

    c_keys, c_payload, c_idx, count = rp4.compact(ends, payload)
    m = int(count.item())
    err = 0.0
    for block in sorted({b for _, b in V2_GEOMETRIES}):
        got = rp2.expand(c_keys, c_payload, c_idx, block)
        want = rp2.expand_plain(c_keys, c_payload, c_idx, block)
        assert_equal(f"expand B={block} at the v2 path's inputs", got, want)
        err = max(err, max_abs_err(got, want))

        def kern(b=block):
            return rp2.expand(c_keys, c_payload, c_idx, b)

        def plain(b=block):
            return rp2.expand_plain(c_keys, c_payload, c_idx, b)

        p1, k1, k2, p2 = (device_ms(plain), device_ms(kern), device_ms(kern),
                          device_ms(plain))
        log(f"time expand B={block}: kernel {k1:.4f}/{k2:.4f} ms, plain "
            f"{p1:.4f}/{p2:.4f} ms (device time, mean of {REPS}, {card}); "
            f"bound {expand_bound(N, m, 5, block)[0]:.4f} ms ({m} "
            f"survivors of {N})")
    return err, v2_times


def phase_gsukf(dev, seed: int, card: str):
    """``GaussianSumUnscentedKalmanFilter`` at 2^18 Gaussians on the bench
    rig (``scripts/gsf_bench.py``): chained steps through the entry point
    a user calls, then one step against the plain resample, stage times
    and a profile. Returns the metric."""
    from torch.profiler import ProfilerActivity, profile

    x0, state_pdf, meas_pdf = bench_rig(dev)
    f, g = bio.homeostatic_des, bio.static_outputs
    u = torch.tensor([0.06, 0.2], dtype=torch.float32, device=dev)
    z = bio.static_outputs(torch.from_numpy(X_SS)).to(torch.float32).to(dev)
    dt = torch.tensor(0.1, device=dev)
    filt = gsf.GaussianSumUnscentedKalmanFilter(f, g, N_BANK, x0, state_pdf,
                                                meas_pdf, seed=seed)
    if filt.means.device != dev:
        raise AssertionError(f"GSUKF bank on {filt.means.device}")
    zero_counts()
    for _ in range(GRAPH_WARM):                       # warm-up, captures
        filt.step(u, z, dt)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(GSUKF_STEPS):
        filt.step(u, z, dt)
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counts()
    expect_counts("GSUKF path", counts,
                  {"compact": GSUKF_STEPS + GRAPH_WARM,
                   "expand": GSUKF_STEPS + GRAPH_WARM,
                   "mixture_pdf": GSUKF_STEPS + GRAPH_WARM})
    if not torch.equal(filt.covariances, filt.covariances.mT):
        raise AssertionError("GSUKF path: covariances not exactly symmetric")
    est, cov = filt.moments()
    if not (torch.isfinite(filt.means).all()
            and torch.isfinite(filt.covariances).all()
            and torch.isfinite(est).all() and torch.isfinite(cov)):
        raise AssertionError("GSUKF path: non-finite bank or moments")
    if filt.covariances.shape != (N_BANK, 5, 5):
        raise AssertionError(f"GSUKF covariances "
                             f"{tuple(filt.covariances.shape)}")
    ms_per_step = start.elapsed_time(end) / GSUKF_STEPS
    log(f"GSUKF path: {GSUKF_STEPS} chained steps at N={N_BANK}: "
        f"{ms_per_step:.4f} ms/step (CUDA events, {card}), host wall "
        f"{wall_s / GSUKF_STEPS * 1e3:.4f} ms/step; launches "
        f"{ {k: v for k, v in counts.items() if v} }; covariances exactly "
        f"symmetric; point estimate {[round(v, 5) for v in est.tolist()]}, "
        f"covariance {float(cov):.6g}")

    # one step through the kernels vs the plain resample: same noise, r
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    st = filt.state
    s_sig = 11
    noise = state_pdf.draw_t(gen, N_BANK * s_sig).reshape(
        5, s_sig, N_BANK).transpose(0, 1)
    r = torch.rand((), generator=gen, device=dev)

    def one_step():
        return gsf.step_from_noise(st.means, st.covariances, st.weights, u,
                                   z, dt, f, g, meas_pdf, noise, r,
                                   noise_is_lanes=True)[0]

    got = one_step()
    with rs.impl("xla"):
        want = one_step()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("GSUKF kernel step != plain-resample step")
    if not torch.equal(got[1], got[1].mT):
        raise AssertionError("GSUKF step: covariances not symmetric")
    log("GSUKF path: kernel step == plain-resample step (bit-equal), "
        "covariances exactly symmetric")

    pm, pc = gsf.predict_core(st.means, st.covariances, u, dt, noise, f,
                              noise_is_lanes=True)
    um, uc, uw = gsf.update_core(pm, pc, st.weights, u, z, g, meas_pdf)
    upd = gsf.GSUKFState(um, uc, uw, gen)
    stages = {
        "noise draw": lambda: state_pdf.draw_t(gen, N_BANK * s_sig),
        "predict": lambda: gsf.predict_core(st.means, st.covariances, u, dt,
                                            noise, f, noise_is_lanes=True),
        "update": lambda: gsf.update_core(pm, pc, st.weights, u, z, g,
                                          meas_pdf),
        "resample": lambda: rs.systematic_resample_bank_from_r(um, uc, uw,
                                                               r),
        "moments": lambda: (gsf.point_estimate(upd),
                            gsf.point_covariance(upd)),
    }
    for name, fn in stages.items():
        log(f"GSUKF stage {name}: {time_ms(fn):.4f} ms (median of {REPS}, "
            f"synchronised, {card})")
    for _ in range(GRAPH_WARM):
        filt.step(u, z, dt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ROUTE_STEPS):
            filt.step(u, z, dt)
        torch.cuda.synchronize()
    busy, span, ops, per_name = busy_ms(prof)
    if ops:
        top = sorted(per_name.items(), key=lambda kv: -kv[1])[:5]
        log(f"GSUKF profile: {ops / ROUTE_STEPS:.1f} device ops/step, busy "
            f"{busy / ROUTE_STEPS:.4f} of span {span / ROUTE_STEPS:.4f} "
            f"ms/step (busy share {busy / span:.3f}; {card}); top: "
            + "; ".join(f"{name[:60]} {ms / ROUTE_STEPS:.4f} ms/step "
                        f"({ms / busy:.3f})" for name, ms in top))
    else:
        log("GSUKF profile: the profiler saw no device time")
    metric = {
        "metric": "gsukf_full_step_throughput_2^18_gaussians",
        "value": 1e3 / ms_per_step, "unit": "steps/s",
        "ms_per_step": ms_per_step, "steps": GSUKF_STEPS, "seed": seed,
        "card": card,
    }
    return metric


# ----------------------------------------------------------------------
# (k) graphed steps: each step captured once as a CUDA graph, replayed
# ----------------------------------------------------------------------
def tensors_of(tree) -> list:
    """The tensors of a state, a tuple or a tensor, in field order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree)
                for t in tensors_of(getattr(tree, f.name))]
    if isinstance(tree, (tuple, list)):
        return [t for c in tree for t in tensors_of(c)]
    return []


def same(path: str, got, want, phase: str = "(k)") -> None:
    """Raise unless ``got`` and ``want`` hold bit-equal tensors and, for
    states, generators in the same position."""
    g, w = tensors_of(got), tensors_of(want)
    if len(g) != len(w) or not all(torch.equal(a, b) for a, b in zip(g, w)):
        raise AssertionError(f"{phase} {path}: graphed differs from eager")
    gens = [getattr(x, "generator", None) for x in (got, want)]
    if None not in gens and not torch.equal(gens[0].get_state(),
                                            gens[1].get_state()):
        raise AssertionError(f"{phase} {path}: the generators part")


def graphed_vs_eager(path: str, graphed, eager, card: str,
                     calls: int = GRAPH_TIMED, phase: str = "(k)") -> dict:
    """ms a call by CUDA events over ``calls`` chained calls after one
    warm-up call, and host ms a call (the calls' enqueue, before the
    synchronise): eager, graphed, graphed, eager; the better of each
    two."""
    def timed(fn):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        end.record()
        torch.cuda.synchronize()
        return (start.elapsed_time(end) / calls, (t1 - t0) * 1e3 / calls)

    e1, g1, g2, e2 = timed(eager), timed(graphed), timed(graphed), \
        timed(eager)
    out = {"eager_ms": min(e1[0], e2[0]), "graphed_ms": min(g1[0], g2[0]),
           "eager_host_ms": min(e1[1], e2[1]),
           "graphed_host_ms": min(g1[1], g2[1])}
    log(f"{phase} {path}: {calls} chained calls, eager {e1[0]:.4f}/"
        f"{e2[0]:.4f} ms a call (host {e1[1]:.4f}/{e2[1]:.4f}), graphed "
        f"{g1[0]:.4f}/{g2[0]:.4f} ms (host {g1[1]:.4f}/{g2[1]:.4f}) (CUDA "
        f"events, {card})")
    return out


def chained_pair(path: str, step, state, steps: int, phase: str,
                 graphed=None):
    """``steps`` chained calls of ``step`` (a function of the state) from
    ``state``, and of the same step from a fork of it under
    ``graphs.disabled`` of its graphed function ``graphed`` (default:
    ``step``), bit-equal after each (states and generators). Returns the
    two last states."""
    a, b = state, graphs.fork(state)
    for i in range(steps):
        a = step(a)
        with graphs.disabled(graphed or step):
            b = step(b)
        same(f"{path}, call {i}", a, b, phase)
    return a, b


def timed_pair(path: str, step, a, b, card: str, calls: int, phase: str,
               graphed=None) -> dict:
    """:func:`graphed_vs_eager` of ``step`` chained from ``a`` (graphed)
    and ``b`` (under ``graphs.disabled`` of ``graphed``, default
    ``step``)."""
    hold = {"g": a, "e": b}

    def graphed_call():
        hold["g"] = step(hold["g"])

    def eager_call():
        with graphs.disabled(graphed or step):
            hold["e"] = step(hold["e"])

    return graphed_vs_eager(path, graphed_call, eager_call, card, calls,
                            phase)


def unchanged(path: str, held: list, calls) -> None:
    """Tensors handed out before ``calls`` keep their values after it."""
    snaps = [t.clone() for t in held]
    calls()
    torch.cuda.synchronize()
    if not all(torch.equal(t, c) for t, c in zip(held, snaps)):
        raise AssertionError(f"(k) {path}: a tensor handed out before "
                             f"later calls changed")


def phase_graphed_tiled(dev, seed: int, card: str, new_meas) -> dict:
    """(k) the tiled step at 2^20 on ``bench.py``'s rig,
    ``pft.graphed_step`` against ``pft.step``; ``new_meas`` a measurement
    mixture of the rig's shapes."""
    x0, state_pdf, meas_pdf = bench_rig(dev)
    f, g = bio.homeostatic_des, bio.static_outputs
    u = torch.tensor([0.06, 0.2], dtype=torch.float32, device=dev)
    z = bio.static_outputs(torch.from_numpy(X_SS)).to(torch.float32).to(dev)
    dt = 0.1

    def start():
        return pft.init(torch.Generator(device=dev).manual_seed(seed + 21),
                        N, x0)

    step_g = pft.graphed_step()
    eager, graphed = start(), start()
    zero_counts()
    for i in range(GRAPH_STEPS):
        eager = pft.step(eager, u, z, dt, f, g, state_pdf, meas_pdf)
        graphed = step_g(graphed, u, z, dt, f, g, state_pdf, meas_pdf)
        same(f"tiled step {i}", graphed, eager)
    # the eager steps, the warm-up, then one replay a step
    expect_counts("(k) tiled step", read_counts(),
                  {"compact": 2 * GRAPH_STEPS, "expand": 2 * GRAPH_STEPS})
    if (step_g.captures, step_g.replays) != (1, GRAPH_STEPS - 1):
        raise AssertionError(f"(k) tiled step: {step_g.captures} captures, "
                             f"{step_g.replays} replays")
    held = [graphed.x]

    def three():
        nonlocal graphed
        for _ in range(3):
            graphed = step_g(graphed, u, z, dt, f, g, state_pdf, meas_pdf)

    unchanged("tiled step", held, three)
    # the noise fed: two calls, the second a replay of other inputs
    sfn = pft.graphed_step_from_noise()
    gen = torch.Generator(device=dev).manual_seed(seed + 22)
    for i in range(2):
        noise = state_pdf.draw_t(gen, N)
        r = torch.rand((), generator=gen, device=dev)
        args = (graphed.x, u, z, dt, f, g, meas_pdf, noise, r)
        same(f"tiled step_from_noise {i}", sfn(*args),
             pft.step_from_noise(*args))
    # another measurement mixture of the same shapes: captured anew, and
    # computed with, as eager computes
    gen_e = torch.Generator(device=dev)
    gen_e.set_state(graphed.generator.get_state())
    want = pft.step(pft.TiledPFState(graphed.x, gen_e), u, z, dt, f, g,
                    state_pdf, new_meas)
    graphed = step_g(graphed, u, z, dt, f, g, state_pdf, new_meas)
    same("tiled step with a new measurement pdf", graphed, want)
    if step_g.captures != 2:
        raise AssertionError("(k) tiled step: a new dist did not capture")
    # launches: the graph's two kernels at every replay
    zero_counts()
    for _ in range(5):
        graphed = step_g(graphed, u, z, dt, f, g, state_pdf, meas_pdf)
    expect_counts("(k) tiled replays", read_counts(),
                  {"compact": 5, "expand": 5})
    holder = {"e": eager, "g": graphed}

    def eager_call():
        holder["e"] = pft.step(holder["e"], u, z, dt, f, g, state_pdf,
                               meas_pdf)

    def graphed_call():
        holder["g"] = step_g(holder["g"], u, z, dt, f, g, state_pdf,
                             meas_pdf)

    zero_counts()
    times = graphed_vs_eager("tiled step n=2^20", graphed_call, eager_call,
                             card)
    expect_counts("(k) tiled timed", read_counts(),
                  {k: 4 * (GRAPH_TIMED + 1) for k in ("compact", "expand")})
    times["pool_mib"] = step_g.pool_bytes() / 2**20
    log(f"(k) tiled step: graphed bit-equal to eager over {GRAPH_STEPS} "
        f"steps (generators too), outputs kept after later calls, a new "
        f"dist captured anew; pool {times['pool_mib']:.1f} MiB ({card})")
    return times


def phase_graphed_shell(name: str, make, new_meas, dev, card: str,
                        ends: bool = False) -> dict:
    """(k) a filter shell's graphed methods against the same shell's
    eager ones (``graphs.disabled``), two shells from one seed: predict,
    update and resample, then step, each followed by moments; a forced
    ``impl("ends")`` capture (``ends``); tensors handed out kept; dists
    and state reassigned; replays and launches; times."""
    f_e, f_g = make(), make()
    u = torch.tensor([0.06, 0.2], dtype=torch.float32, device=dev)
    z = bio.static_outputs(torch.from_numpy(X_SS)).to(torch.float32).to(dev)
    dt = 0.1

    def both(method, *args, path=""):
        with graphs.disabled():
            getattr(f_e, method)(*args)
        getattr(f_g, method)(*args)
        same(f"{name} {method}{path}", f_g.state, f_e.state)
        with graphs.disabled():
            want = f_e.moments()
        same(f"{name} moments after {method}{path}", f_g.moments(), want)

    zero_counts()
    for i in range(GRAPH_STEPS):
        if i < GRAPH_STEPS // 2:
            both("predict", u, dt, path=f" {i}")
            both("update", u, z, path=f" {i}")
            both("resample", path=f" {i}")
        else:
            both("step", u, z, dt, path=f" {i}")
    expect_counts(f"(k) {name}", read_counts(),
                  {"compact": 2 * GRAPH_STEPS, "expand": 2 * GRAPH_STEPS,
                   "mixture_pdf": 2 * GRAPH_STEPS})
    # every call a capture (a key's first: its warm-up) or a replay; a
    # key is also the inputs' strides, which some outputs change
    half = GRAPH_STEPS // 2
    calls = {"predict": half, "update": half, "resample": half,
             "step": half, "moments": 4 * half}
    got = {k: (v.captures, v.replays) for k, v in f_g.graphs.items()}
    if any(c + r != calls[k] or r < 1 for k, (c, r) in got.items()):
        raise AssertionError(f"(k) {name}: captures, replays {got} for "
                             f"calls {calls}")
    if ends:
        zero_counts()
        before = f_g.graphs["step"].captures
        # the route keys the graph; the ends route's rows come back as
        # a strided view of its packed payload, which keys one more
        # graph, replayed by the third step
        with rs.impl("ends"):
            both("step", u, z, dt, path=" under impl('ends')")
            if f_g.graphs["step"].captures != before + 1:
                raise AssertionError(f"(k) {name}: the route did not key "
                                     f"the step's graph")
            for _ in range(2):
                both("step", u, z, dt, path=" under impl('ends')")
        for _ in range(2):
            both("step", u, z, dt, path=" back on auto")
        expect_counts(f"(k) {name} under impl('ends')", read_counts(),
                      {"ends_merge_round": 6, "compact": 4, "expand": 4,
                       "mixture_pdf": 10})
    # tensors handed out, then three more calls
    est, cov = f_g.moments()
    held = tensors_of(f_g.state) + [est, cov]

    def three():
        for _ in range(3):
            f_g.step(u, z, dt)
        f_g.moments()

    unchanged(name, held, three)
    for _ in range(3):
        with graphs.disabled():
            f_e.step(u, z, dt)
    same(f"{name} after the three calls", f_g.state, f_e.state)
    # dists assigned anew
    f_g.step(u, z, dt)                   # a replay: the key is warm
    with graphs.disabled():
        f_e.step(u, z, dt)
    before = f_g.graphs["step"].captures
    for filt in (f_e, f_g):
        filt.measurement_pdf = new_meas
    both("step", u, z, dt, path=" with a new measurement pdf")
    if f_g.graphs["step"].captures != before + 1:
        raise AssertionError(f"(k) {name}: a new dist did not capture")
    # a state assigned from outside (a checkpoint's), its own generator;
    # then that generator set back to a saved state
    gens = []
    for filt in (f_e, f_g):
        st = filt.state
        gen = torch.Generator(device=dev).manual_seed(5)
        gens.append(gen)
        filt.state = dataclasses.replace(
            st, generator=gen, **{k.name: getattr(st, k.name).clone()
                                  for k in dataclasses.fields(st)
                                  if k.name != "generator"})
    saved = gens[0].get_state()
    both("step", u, z, dt, path=" from an assigned state")
    for gen in gens:
        gen.set_state(saved)
    both("step", u, z, dt, path=" after set_state")
    # launches: the graph's kernels at every replay
    zero_counts()
    before = f_g.graphs["step"].replays
    for _ in range(5):
        f_g.step(u, z, dt)
    expect_counts(f"(k) {name} replays", read_counts(),
                  {"compact": 5, "expand": 5, "mixture_pdf": 5})
    if f_g.graphs["step"].replays != before + 5:
        raise AssertionError(f"(k) {name}: replays not counted")

    def eager_call():
        with graphs.disabled():
            f_e.step(u, z, dt)

    times = graphed_vs_eager(f"{name} step", lambda: f_g.step(u, z, dt),
                             eager_call, card)
    # a graphed call waits for nothing: inputs from the host, as the
    # harness passes them, go through pinned memory (graphs.as_input)
    u_h, z_h = u.cpu().numpy().astype(np.float64), z.cpu().numpy()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            f_g.step(u_h, z_h, dt)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if times["graphed_host_ms"] >= times["graphed_ms"]:
        raise AssertionError(
            f"(k) {name}: host {times['graphed_host_ms']:.4f} ms a graphed "
            f"call, not below device {times['graphed_ms']:.4f} ms")
    log(f"(k) {name}: 3 graphed steps from host u, z and dt under "
        f"set_sync_debug_mode('error'), no synchronise; host "
        f"{times['graphed_host_ms']:.4f} ms against device "
        f"{times['graphed_ms']:.4f} ms a graphed call ({card})")
    times["pool_mib"] = {k: v.pool_bytes() / 2**20
                         for k, v in f_g.graphs.items()}
    log(f"(k) {name}: predict, update, resample, step and moments graphed "
        f"bit-equal to eager (states, moments, generators), outputs kept "
        f"after later calls, new dists and an assigned state honoured, "
        f"set_state resumed; pools MiB "
        f"{ {k: round(v, 1) for k, v in times['pool_mib'].items()} } "
        f"({card})")
    return times


def phase_graphs(dev, seed: int, card: str) -> dict:
    """(k) graphed steps: the tiled step at 2^20, the flat
    ``ParticleFilter`` (auto, and one forced ``impl("ends")`` capture) at
    2^20 and the GSUKF at 2^18, each graphed against eager. Returns the
    times."""
    t0 = time.perf_counter()
    f, g = bio.homeostatic_des, bio.static_outputs
    x0h, spdf, mpdf = harness_rig(dev)
    x0b, spdf_b, mpdf_b = bench_rig(dev)
    # a measurement mixture of the same shapes with wider components
    meas2 = GaussianSum.create(mpdf.means.cpu().numpy(),
                               4 * mpdf.covariances.cpu().double().numpy(),
                               mpdf.weights.cpu().numpy(), device=dev)
    meas2_b = GaussianSum.create(mpdf_b.means.cpu().numpy(),
                                 4 * mpdf_b.covariances.cpu().double().numpy(),
                                 mpdf_b.weights.cpu().numpy(), device=dev)
    metric = {"metric": "graphed_vs_eager_ms_per_step", "card": card,
              "tiled_2^20": phase_graphed_tiled(dev, seed, card, meas2_b)}
    metric["flat_2^20"] = phase_graphed_shell(
        "flat ParticleFilter n=2^20",
        lambda: pf.ParticleFilter(f, g, N, x0h, spdf, mpdf, seed=seed),
        meas2, dev, card, ends=True)
    metric["gsukf_2^18"] = phase_graphed_shell(
        "GSUKF N=2^18",
        lambda: gsf.GaussianSumUnscentedKalmanFilter(
            f, g, N_BANK, x0b, spdf_b, mpdf_b, seed=seed, device=dev),
        meas2_b, dev, card)
    metric["phase_s"] = time.perf_counter() - t0
    log(f"(k) graphed steps: {metric['phase_s']:.1f} s ({card})")
    return metric


# ----------------------------------------------------------------------
# the control slice: the MPC, the closed loop and the on-device loop
# ----------------------------------------------------------------------
def control_setup(dev, seed: int, card: str):
    """The canonical rig at dt_control = 0.1 as ``Simulation`` builds it
    for phase (b), with the PF at 2^20 on ``dev``: its plant, linear
    model and MPC (float64 host setup, device constants on ``dev``) serve
    phases (a) to (c). Also the same MPC with its constants on the CPU,
    for the first step's comparison in (a): its ``get_parts`` time is the
    host setup alone."""
    t0 = time.perf_counter()
    s = harness.Simulation(N_particles=N, dt_control=DT_CONTROL,
                           dt_predict=DT_CONTROL, end_time=LOOP_END, pf=True,
                           seed=seed, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    K_cpu = harness.get_parts(dt_control=DT_CONTROL, device="cpu")[2]
    setup_s = time.perf_counter() - t0
    K = s.K
    log(f"control setup: MPC P={K.P}, M={K.M} (QP n={K.qp.n}, m={K.qp.m}); "
        f"Simulation with the PF at n={N} built in {build_s:.2f} s (device "
        f"constants on {K.qp.device}); the host setup alone (get_parts, "
        f"device constants on the CPU) {setup_s:.2f} s ({card})")
    # the reference's horizons, int(300 // dt_control) and
    # int(200 // dt_control): at 0.1, 2999 and 1999 (float floor division)
    P, M = int(300 // DT_CONTROL), max(int(200 // DT_CONTROL), 1)
    if (K.P, K.M, K.qp.n, K.qp.m) != (P, M, 2 * (M + 1), 2):
        raise AssertionError("the canonical rig's MPC has the wrong shape")
    return s, K_cpu, setup_s


QP_FIELDS = [f.name for f in dataclasses.fields(cqp.QPSolution)]


def same_solution(path: str, got, want) -> None:
    """Fail unless two ``QPSolution``s are equal bit for bit."""
    for name in QP_FIELDS:
        if not torch.equal(getattr(got, name), getattr(want, name)):
            raise AssertionError(f"{path}: {name} of the device loop differs "
                                 f"from the host-driven loop's")


def cond_count() -> int:
    """``graph_cond``'s launches since the last zeroing: the WHILE
    iterations, counted on the card by the kernel that sets the loop's
    handle (reading or zeroing the count waits for the card)."""
    return graph_cond.iterations(torch.device("cuda"))


def zero_cond_count() -> None:
    graph_cond.reset_iterations(torch.device("cuda"))


def timed_mpc_step(K, args, host: bool):
    """``K.step(*args)`` through the device loop, or the host-driven loop
    where ``host``: ``(u or None where it raised, CUDA-event ms)``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    with cqp.host_driven() if host else contextlib.nullcontext():
        try:
            u = K.step(*args)
        except ValueError:
            u = None
    end.record()
    end.synchronize()
    return u, start.elapsed_time(end)


def phase_mpc(s, K_cpu, card: str) -> dict:
    """(a) The no-noise closed loop of
    ``results/bioreactor_closedloop/no_noise.py`` on the canonical MPC
    (P=2999, M=1999) for ``LOOP_END`` time units: ``K.step`` latency,
    solves per second, CUDA-event ms per solve and per stall, iterations
    per solve, near-solved acceptances, and the first step against the
    same MPC's solve on the CPU.

    Each solve is one graph whose ADMM loop is a conditional WHILE node
    (``control/qp.py``); each is solved again from the same state under
    ``qp.host_driven()`` (the same parts, the loop driven by one read a
    chunk) and must equal it bit for bit (statuses, iterations, x, y, z,
    residuals, rho and refactorizations); the WHILE iterations counted
    on the card must be the solves' chunks. Host reads a solve are
    counted by the profiler both ways. Then ``rig.QP_CASES`` (a general
    Hessian refactorizing its n x n K, a stall at a max_iter between
    checks, the Woodbury path's stall) the same way, batched.

    At these tolerances (1e-6) the float32 ADMM stalls at max_iter on
    some steps of this loop, the reference's as well: a step that raises
    falls back to the nominal input, as
    ``results/bioreactor_closedloop/mpc_run_seq.py`` does at this
    dt_control, and is counted. The phase fails if the first step raises
    (the reference solves it) or more steps raise than the reference's
    ``REF_RAISED``."""
    from torch.profiler import ProfilerActivity, profile

    lin, K = s.lin_model, s.K
    K.reset()
    ts = np.linspace(0, LOOP_END, int(LOOP_END * 10))
    dt = ts[1]
    plant = Bioreactor(s.bioreactor.X.copy(), high_N=False)
    us, xs, ys = [np.array([0.06, 0.2])], [plant.X.copy()], [plant.outputs(None)]
    lat, ev_ms, host_ms, iters, status, raised = [], [], [], [], [], []
    refactors, chunks = 0, 0
    t_next = 0.0
    steps = []              # each solve's arguments and the MPC's state
    ce = K.qp.settings.check_every

    def state():
        return K.y_predicted, K._warm_v, K._warm_y

    def set_state(st):
        K.y_predicted, K._warm_v, K._warm_y = st

    zero_counts()
    zero_cond_count()
    for t in ts[1:]:
        if t > t_next:
            args = (lin.xn2d(xs[-1]), lin.un2d(us[-1]), lin.yn2d(ys[-1]))
            i = len(iters)
            before = state()
            steps.append((args, before))
            t0 = time.perf_counter()
            u, ms = timed_mpc_step(K, args, host=False)
            step_s = time.perf_counter() - t0
            dev_sol, after = K.last_solution, state()
            loop = cqp._card_loop(K.qp.consts, 1, K.qp.settings,
                                  K.qp.settings.dtype, K.qp.device)
            rho, refac = loop.rho.clone(), loop.refactors.clone()
            # the same solve with its loop driven from the host
            set_state(before)
            u_host, ms_host = timed_mpc_step(K, args, host=True)
            same_solution(f"MPC (a) step {i}", dev_sol, K.last_solution)
            if not (torch.equal(rho, loop.rho)
                    and torch.equal(refac, loop.refactors)):
                raise AssertionError(f"MPC (a) step {i}: rho schedule differs")
            if (u is None) != (u_host is None) or (
                    u is not None and not np.array_equal(u, u_host)):
                raise AssertionError(f"MPC (a) step {i}: control differs")
            set_state(after)
            K.last_solution = dev_sol
            if u is None:
                if i == 0:
                    raise AssertionError("MPC (a): the first step raised")
                u = np.array([0.06, 0.2]) - lin.u_bar
                raised.append(i)
            lat.append(step_s)
            ev_ms.append(ms)
            host_ms.append(ms_host)
            iters.append(int(dev_sol.iterations))
            status.append(int(dev_sol.status))
            refactors += int(refac)
            chunks += iters[-1] // ce
            u_temp = us[-1].copy()
            u_temp[lin.inputs] = lin.ud2n(u)
            us.append(u_temp)
            t_next += DT_CONTROL
        else:
            us.append(us[-1])
        plant.step(dt, us[-1])
        ys.append(plant.outputs(us[-1]))
        xs.append(plant.X.copy())
    torch.cuda.synchronize()
    whiles = cond_count()
    if whiles != chunks:
        raise AssertionError(f"MPC (a): {whiles} WHILE iterations counted on "
                             f"the card, the solves ran {chunks} chunks")
    expect_counts("MPC (a)", read_counts(), {})
    TALLY_COND.append(whiles)
    us, ys = np.array(us), np.array(ys)
    if not (np.isfinite(us).all() and np.isfinite(ys).all()):
        raise AssertionError("MPC loop: non-finite inputs or outputs")
    perf = harness.performance(ys[:, lin.outputs], lin.yd2n(K.ysp), ts)
    lat_ms = np.array(lat) * 1e3
    near = sum(st == cqp.MAX_ITER_REACHED for i, st in enumerate(status)
               if i not in raised)
    if len(raised) > REF_RAISED:
        raise AssertionError(f"MPC loop: {len(raised)} of {len(status)} "
                             f"steps raised ValueError, the reference's "
                             f"{REF_RAISED}")
    stall = [j for j, it in enumerate(iters) if it >= K.qp.settings.max_iter]
    ev, hv = np.array(ev_ms), np.array(host_ms)

    # host reads of one solve each way, and five solves under the profiler
    first_args, first_state = steps[0]
    reads = {}
    for host in (False, True):
        set_state(first_state)
        reads[host] = host_reads(
            lambda: timed_mpc_step(K, first_args, host))[0]
    if reads[False] != 1:
        raise AssertionError(f"MPC (a): {reads[False]} reads to the host in "
                             f"a device-loop MPC.step, not 1")
    first = min(10, len(steps) // 2)
    profiled = steps[first:first + 5]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for args, st in profiled:
            set_state(st)
            timed_mpc_step(K, args, host=False)
        torch.cuda.synchronize()

    # the first step on the card against the same MPC on the CPU
    K.reset()
    got = K.step(*first_args)
    want = K_cpu.step(*first_args)
    K.reset()
    err = float(np.abs(got - want).max() / np.abs(want).max())
    if err > 1e-4:
        raise AssertionError(f"MPC first step: card {got} vs CPU {want}")
    cases = qp_cases(K.qp.device, card)

    busy, span, ops, _ = busy_ms(prof)
    n_prof = len(profiled)
    metric = {
        "metric": "mpc_solves_per_s_P3000_M2000", "unit": "solves/s",
        "value": 1e3 / float(np.median(lat_ms)), "solves": len(lat),
        "step_ms_median": float(np.median(lat_ms)),
        "step_ms_p10": float(np.percentile(lat_ms, 10)),
        "step_ms_p90": float(np.percentile(lat_ms, 90)),
        "step_ms_max": float(lat_ms.max()),
        "event_ms_per_solve": float(np.median(ev)),
        "host_driven_event_ms_per_solve": float(np.median(hv)),
        "event_ms_per_stall": float(ev[stall].mean()) if stall else None,
        "host_driven_event_ms_per_stall": (float(hv[stall].mean())
                                           if stall else None),
        "stalls": len(stall), "while_iterations": whiles,
        "refactorizations": refactors,
        "host_reads_per_solve": reads[False],
        "host_driven_host_reads_per_solve": reads[True],
        "iterations_median": float(np.median(iters)),
        "iterations_max": int(max(iters)), "near_solved": int(near),
        "raised": len(raised),
        "profiled_busy_ms_per_solve": busy / n_prof,
        "profiled_ops_per_solve": ops / n_prof,
        "qp_cases": cases, "card": card,
    }
    log(f"MPC (a): no-noise loop to t={LOOP_END}, {len(lat)} solves, each a "
        f"graph with a WHILE node, bit-equal to the host-driven loop (rho "
        f"too; {refactors} refactorizations, {whiles} WHILE iterations = "
        f"chunks); K.step {metric['step_ms_median']:.3f} ms median (p10 "
        f"{metric['step_ms_p10']:.3f}, p90 {metric['step_ms_p90']:.3f}, max "
        f"{metric['step_ms_max']:.3f}), {metric['value']:.1f} solves/s; "
        f"CUDA events {metric['event_ms_per_solve']:.3f} ms/solve (host-"
        f"driven {metric['host_driven_event_ms_per_solve']:.3f}), "
        f"{len(stall)} stalls {metric['event_ms_per_stall']} ms each "
        f"(host-driven {metric['host_driven_event_ms_per_stall']}); host "
        f"reads a solve {reads[False]} (host-driven {reads[True]}); "
        f"iterations median {metric['iterations_median']:.0f}, max "
        f"{metric['iterations_max']}; near-solved {near}, raised "
        f"ValueError {len(raised)} (steps {raised}) of {len(status)}, the "
        f"reference {REF_RAISED}; performance {perf:.6g} ({card})")
    log(f"MPC (a): solves {first}-{first + n_prof - 1} of the loop again "
        f"under the profiler: {ops / n_prof:.1f} device ops, busy "
        f"{busy / n_prof:.4f} of span {span / n_prof:.4f} ms per step; first "
        f"step card {got.tolist()} vs CPU {want.tolist()} (rel err "
        f"{err:.2e})")
    return metric


COND_ITERS = 1000          # WHILE iterations of the timed loop
COND_SOURCE = "gpu_se_tpu_torch/csrc/graph_cond.cu"
COND_REPLACES = ("none (port-only): the lax.while_loop and lax.cond of the "
                 "QP solve, gpu_se_tpu/control/qp.py:404-489")


def kept_graph(fn, dev):
    """``fn`` run once, then captured as a graph kept for a conditional
    node's body."""
    graphs.warm_up(fn, (), {}, dev)
    return graphs.capture(fn, (), {}, [], dev, keep_graph=True)[0]


def phase_graph_cond(dev, card: str):
    """``graph_cond`` alone: a WHILE node of ``COND_ITERS`` iterations
    whose body is a kept graph of two one-element kernels (count, compare)
    and an IF never taken, timed by CUDA events against the same body
    replayed from the host with a read of the flag each iteration (the
    host-driven loop) and against the body's kernels captured ``COND_ITERS``
    times in one graph with no node (what the nodes add). Each loop must
    count to ``COND_ITERS`` and the card's count add its iterations.
    Returns ``(ms, plain_ms, (bound ms, by), metric)``, each a WHILE
    iteration."""
    graph_cond.prepare(dev)
    n, sink = (torch.zeros((), dtype=torch.int32, device=dev)
               for _ in range(2))
    go, never = (torch.zeros((), dtype=torch.bool, device=dev)
                 for _ in range(2))

    def body():
        n.add_(1)
        go.copy_(n < COND_ITERS)

    parts = [kept_graph(body, dev), kept_graph(lambda: sink.add_(1), dev)]
    sink.zero_()                   # the IF's part ran once, eagerly

    def looped():
        n.zero_()
        graph_cond.while_loop(go, [parts[0], graph_cond.If(never,
                                                           (parts[1],))])

    def unrolled():
        n.zero_()
        for _ in range(COND_ITERS):
            body()

    g_loop = graphs.capture(looped, (), {}, [], dev)[0]
    g_flat = graphs.capture(unrolled, (), {}, [], dev)[0]

    def host_loop():
        n.zero_()
        parts[0].replay()
        while go.item():
            parts[0].replay()

    zero_cond_count()
    loop_ms = time_ms(g_loop.replay, reps=10)
    counted = cond_count()
    if counted != 13 * COND_ITERS or int(n) != COND_ITERS or int(sink) != 0:
        raise AssertionError(f"graph_cond: {counted} iterations "
                             f"counted, n {int(n)}, the IF taken "
                             f"{int(sink)} times")
    flat_ms = time_ms(g_flat.replay, reps=10)
    host_ms = time_ms(host_loop, reps=3)
    if int(n) != COND_ITERS:
        raise AssertionError("graph_cond: the host-driven loop miscounted")
    per = {k: v / COND_ITERS for k, v in (("while", loop_ms),
                                          ("unrolled", flat_ms),
                                          ("host", host_ms))}
    # a WHILE iteration reads its flag (1 byte) and adds to the count
    # (8 bytes read and written); the IF's set kernel reads its flag
    bound = least_time(1 + 16 + 1, 0)
    metric = {"iterations": COND_ITERS,
              "ms_per_iteration": per["while"],
              "unrolled_ms_per_iteration": per["unrolled"],
              "host_driven_ms_per_iteration": per["host"],
              "node_overhead_ms_per_iteration":
                  per["while"] - per["unrolled"], "card": card}
    log(f"graph_cond: a WHILE of {COND_ITERS} iterations (body: a kept "
        f"graph of 2 kernels, an IF not taken) {per['while'] * 1e3:.3f} us "
        f"an iteration; the body's kernels unrolled in one graph "
        f"{per['unrolled'] * 1e3:.3f} us, so the nodes add "
        f"{metric['node_overhead_ms_per_iteration'] * 1e3:.3f} us; the "
        f"host-driven loop (replay, read) {per['host'] * 1e3:.3f} us; "
        f"bound {bound[0] * 1e3:.6f} us ({bound[1]}) ({card})")
    return per["while"], per["host"], bound, metric


def qp_cases(dev, card: str) -> dict:
    """``rig.QP_CASES`` on the card, three members each: the device loop
    against the host-driven loop bit for bit, rho and refactorizations
    too; the general Hessian refactorizes its n x n K, the Woodbury path
    its m x m factor."""
    out = {}
    for name, (make, settings, status, at_least) in rig.QP_CASES.items():
        P, A, q, l, u = make()
        port = cqp.DenseQP(P, A, l, u, q, settings=cqp.QPSettings(**settings),
                           device=dev)
        qs = np.stack([q, 0.5 * q, -q])
        ls, us = np.stack([l] * 3), np.stack([u] * 3)
        port.solve_batch(qs, ls, us)               # builds the loop
        loop = cqp._card_loop(port.consts, 3, port.settings, torch.float32,
                              dev)
        got = []
        for host in (False, True):
            with cqp.host_driven() if host else contextlib.nullcontext():
                sol = port.solve_batch(qs, ls, us)
            got.append((sol, loop.rho.clone(), loop.refactors.clone()))
        (sol, rho, ref), (h_sol, h_rho, h_ref) = got
        same_solution(f"QP case {name}", sol, h_sol)
        if not (torch.equal(rho, h_rho) and torch.equal(ref, h_ref)):
            raise AssertionError(f"QP case {name}: rho schedule differs")
        if int(ref.max()) < at_least:
            raise AssertionError(f"QP case {name}: no refactorization")
        out[name] = {"status": sol.status.tolist(),
                     "iterations": sol.iterations.tolist(),
                     "refactorizations": ref.tolist(),
                     "identity_hessian": port.settings.identity_hessian}
        log(f"QP case {name} (n={port.n}, m={port.m}, identity Hessian "
            f"{port.settings.identity_hessian}): statuses "
            f"{sol.status.tolist()}, iterations {sol.iterations.tolist()}, "
            f"refactorizations {ref.tolist()}; device loop bit-equal to "
            f"the host-driven loop ({card})")
    return out


def loop_counts(path: str, events: int) -> None:
    """``mixture_pdf``, ``compact`` and ``expand`` once per control event:
    the update and the resample."""
    expect_counts(path, read_counts(), {"compact": events, "expand": events,
                                        "mixture_pdf": events})


def run_simulation(s, path: str, card: str) -> dict:
    """``s.simulate()`` with the launch counts zeroed before it and read
    after it; every output finite."""
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    s.simulate()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    loop_counts(path, s.update_count)
    for name in ("us", "xs", "ys", "ys_meas", "xs_f", "ys_f",
                 "covariance_point_size"):
        if not np.isfinite(getattr(s, name)).all():
            raise AssertionError(f"{path}: non-finite {name}")
    if not np.isfinite(s.performance):
        raise AssertionError(f"{path}: non-finite performance")
    ms = wall / s.update_count * 1e3
    log(f"{path}: n={s.f.N_particles}, MPC P={s.K.P}: {s.update_count} "
        f"control events, {s.predict_count} predicts in {wall:.3f} s, "
        f"{ms:.3f} ms per control event; mpc_frac {s.mpc_frac}; performance "
        f"{s.performance:.6g}; launches mixture_pdf, compact and expand "
        f"{s.update_count} each ({card})")
    return {"ms_per_control_event": ms, "mpc_frac": s.mpc_frac,
            "performance": float(s.performance), "events": s.update_count}


def phase_closed_loop(s, card: str):
    """(b) ``Simulation`` with the PF at 2^20 particles on the P=3000
    MPC, through the entry point a user calls. Returns its metrics and
    the filter's and the plant's initial state, for (c)."""
    s.K.reset()
    state = s.f.state
    state0 = dataclasses.replace(state, particles=state.particles.clone(),
                                 weights=state.weights.clone())
    x0 = s.bioreactor.X.copy()
    return run_simulation(s, "closed loop (b), Simulation, PF", card), \
        state0, x0


def phase_scan_loop(dev, s, state0, x0, card: str, seed: int) -> dict:
    """(c) ``make_scan_loop`` at 2^20 particles on the P=3000 MPC, from
    (b)'s initial filter and plant state: the filter, plant, input and
    warm start on the card, each time step one replay of a graph that
    holds the MPC's solve with its WHILE node.

    The first run captures the step's graphs (one a pair of event masks);
    the second runs its steps under ``torch.cuda.set_sync_debug_mode(
    "error")``, so any read to the host raises, and times the host's
    enqueue of the steps against the card's time for them (CUDA events).
    The host-driven loop (the step eager, ``graphs.disabled``, its QP
    under ``qp.host_driven()``) must give the same records bit for bit."""
    K, lin = s.K, s.lin_model
    state_pdf, meas_pdf = harness.get_noise(device=dev)
    run, ts = sim_loop.make_scan_loop(
        K, lin, state_pdf.dist, meas_pdf.dist, end_time=LOOP_END,
        dt_control=DT_CONTROL, dt_predict=DT_CONTROL)
    events = int(sim_loop.event_masks(ts, DT_CONTROL, DT_CONTROL)[1].sum())
    step_g = run.graphs["step"]

    def timed_run(path: str, host: bool = False, sync_error: bool = False):
        gen = torch.Generator(device=dev).manual_seed(seed + 7)
        torch.cuda.synchronize()
        zero_counts()
        zero_cond_count()
        t0 = time.perf_counter()
        carry, noise = run.start(state0, x0, gen)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t_steps = time.perf_counter()
        start.record()
        if host:
            with cqp.host_driven(), graphs.disabled(step_g):
                rec = run.steps(carry, noise)
        else:
            torch.cuda.set_sync_debug_mode("error" if sync_error else 0)
            try:
                rec = run.steps(carry, noise)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        end.record()
        enqueue_s = time.perf_counter() - t_steps
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        loop_counts(path, events)
        whiles = cond_count()
        if not host and whiles < events:
            raise AssertionError(f"{path}: {whiles} WHILE iterations for "
                                 f"{events} solves")
        return rec, wall, enqueue_s * 1e3, start.elapsed_time(end), whiles

    rec_c, wall_c, _, _, whiles_c = timed_run("scan loop (PF), captures")
    captures = step_g.captures
    rec, wall, enq_ms, dev_ms, whiles = timed_run("scan loop (PF)",
                                                  sync_error=True)
    if step_g.captures != captures or step_g.replays < len(ts) - 1:
        raise AssertionError("scan loop: the second run captured anew")
    TALLY_COND.append(whiles)
    rec_h, wall_h, _, dev_ms_h, _ = timed_run("scan loop (PF), host-driven",
                                              host=True)
    for name in rec._fields:
        for other, what in ((rec_h, "host-driven"), (rec_c, "capturing")):
            if not torch.equal(getattr(rec, name), getattr(other, name)):
                raise AssertionError(f"(c) scan loop: {name} differ from the "
                                     f"{what} loop's")
    for name in rec._fields:
        t_ = getattr(rec, name)
        if t_.device != dev or not torch.isfinite(t_.float()).all():
            raise AssertionError(f"scan loop: {name} non-finite or off card")
    if rec.us.shape != (len(ts) - 1, 2):
        raise AssertionError(f"scan loop: us {tuple(rec.us.shape)}")
    solved = float((rec.status == cqp.SOLVED).float().mean())
    us = rec.us.cpu().numpy()
    if np.abs(us - np.array([0.06, 0.2])).max() <= 1e-4:
        raise AssertionError("scan loop: the controller never moved u")
    ms = wall / events * 1e3
    metric = {
        "ms_per_control_event": ms,
        "ms_per_control_event_host_driven": wall_h / events * 1e3,
        "ms_per_control_event_capturing": wall_c / events * 1e3,
        "steps_device_ms": dev_ms, "steps_enqueue_ms": enq_ms,
        "steps_device_ms_host_driven": dev_ms_h,
        "step_graphs": captures, "while_iterations": whiles,
        "solved_share": solved, "events": events}
    log(f"scan loop (c): make_scan_loop, PF at n={N}, MPC P={K.P}: "
        f"{events} control events, {len(ts) - 1} steps, one replay each "
        f"({captures} step graphs, {whiles} WHILE iterations), no host sync "
        f"(sync debug mode error): {wall:.3f} s, {ms:.3f} ms per control "
        f"event; the steps' enqueue {enq_ms:.3f} ms against the card's "
        f"{dev_ms:.3f} ms; host-driven {wall_h / events * 1e3:.3f} ms per "
        f"event (card {dev_ms_h:.3f} ms), with the captures "
        f"{wall_c / events * 1e3:.3f}; records "
        f"bit-equal; solved share {solved:.3f}; final x "
        f"{[round(v, 4) for v in rec.xs[-1].tolist()]}, estimate "
        f"{[round(v, 4) for v in rec.xs_f[-1].tolist()]} ({card})")
    return metric


def phase_gsukf_loop(dev, card: str, seed: int) -> dict:
    """(d) ``Simulation`` with the GSUKF at 2^18 Gaussians on the P=3000
    MPC for ``GSUKF_LOOP_END`` time units (its own host setup)."""
    t0 = time.perf_counter()
    s = harness.Simulation(N_particles=N_BANK, dt_control=DT_CONTROL,
                           dt_predict=DT_CONTROL, end_time=GSUKF_LOOP_END,
                           pf=False, seed=seed, device=dev)
    torch.cuda.synchronize()
    log(f"closed loop (d): Simulation with the GSUKF at N={N_BANK} built "
        f"in {time.perf_counter() - t0:.2f} s ({card})")
    return run_simulation(s, "closed loop (d), Simulation, GSUKF", card)


def phase_first_qp(dev, card: str) -> None:
    """(e) The first step of the no-noise loop at P=300, M=200
    (dt_control = 1), the QP that stalls the reference's float32 ADMM on
    a TPU: ``MPC.step`` on the card and on the CPU, its status,
    iterations and residuals read from ``last_solution``. The CPU's
    control is held to ``u = [-0.028, -0.1]``, the card's to the CPU's."""
    out = {}
    for where, device in (("card", dev), ("cpu", "cpu")):
        plant, lin, K, _ = harness.get_parts(dt_control=1, device=device)
        args = (lin.xn2d(plant.X), lin.un2d(np.array([0.06, 0.2])),
                lin.yn2d(plant.outputs(None)))
        try:
            u = K.step(*args)
        except ValueError:
            u = None
        sol = K.last_solution
        out[where] = u
        if u is not None and not np.isfinite(u).all():
            raise AssertionError(f"first QP on the {where}: non-finite")
        log(f"first QP (e), P={K.P} M={K.M} on the {where}: status "
            f"{int(sol.status)}, iterations {int(sol.iterations)}, prim "
            f"{float(sol.prim_res):.3e}, dual {float(sol.dual_res):.3e}, u "
            f"{None if u is None else u.tolist()} (x2d {args[0].tolist()}, "
            f"um1 {args[1].tolist()}, y2d {args[2].tolist()}; {card})")
    if out["cpu"] is None or np.abs(
            out["cpu"] - np.array([-0.028, -0.1])).max() > 1e-3:
        raise AssertionError("first QP on the CPU: not u = [-0.028, -0.1]")
    if out["card"] is not None:
        err = float(np.abs(out["card"] - out["cpu"]).max()
                    / np.abs(out["cpu"]).max())
        if err > 1e-4:
            raise AssertionError(f"first QP: card {out['card']} vs CPU "
                                 f"{out['cpu']}")


# ----------------------------------------------------------------------
# the scenario MPC and the instrumentation
# ----------------------------------------------------------------------
def median_ms(fn, calls: int = TIMED_CALLS):
    """``(median ms, last result)`` of ``calls`` calls of ``fn`` on the
    host clock, each ended by a synchronise."""
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), out


def phase_scenario(dev, card: str):
    """(f) The scenario MPC at the canonical rig's full width (dt_control
    = 1: P = 300, M = 200, Ni = No = 2, u bounds only) over ``rig.
    SCENARIOS`` scenarios about (e)'s first-step ``x2d``, ``um1`` (e)'s,
    zero biases: the stacked ``ScenarioMPC`` on the card against a CPU
    copy, the consensus step against the stacked control, the independent
    solves against single solves, then the binding case of
    ``tests/test_scenario_mpc.py`` on the card against the CPU. Returns
    the metric and the rig (h) solves again through a mesh of one."""
    t_phase = time.perf_counter()
    zero_counts()
    plant, lin, K, _ = harness.get_parts(dt_control=1, device=dev)
    x2d = lin.xn2d(plant.X)
    um1 = lin.un2d(np.array([0.06, 0.2]))
    S = rig.SCENARIOS
    x0s = x2d[None, :] + rig.scenario_offsets(S, x2d.shape[0])
    biases = np.zeros((S, lin.No))
    u_bounds = [np.array([0, np.inf]) - lin.u_bar[i] for i in range(2)]
    args = (K.P, K.M, K.Q, K.R, lin, K.ysp)

    def t32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

    # the stacked problem, on the card and on a CPU copy
    smpc = {}
    for where, device in (("card", dev), ("cpu", "cpu")):
        t0 = time.perf_counter()
        smpc[where] = ScenarioMPC(*args, n_scenarios=S, u_bounds=u_bounds,
                                  device=device)
        setup_s = time.perf_counter() - t0
        ctrl = smpc[where].step(x0s, um1, biases)[0]
        sol = smpc[where].last_solution
        log(f"scenario (f), stacked on the {where}: S={S}, n_D="
            f"{smpc[where].n_D}, m={smpc[where].m}; host setup {setup_s:.2f}"
            f" s; status {int(sol.status)}, iterations "
            f"{int(sol.iterations)}, prim {float(sol.prim_res):.3e}, dual "
            f"{float(sol.dual_res):.3e}; u {ctrl.tolist()} ({card})")
    if smpc["card"].n_D != 2 + S * 400:
        raise AssertionError(f"stacked QP n_D={smpc['card'].n_D}")
    ctrl_cpu = smpc["cpu"].step(x0s, um1, biases)[0]
    stacked_ms, (ctrl, _) = median_ms(
        lambda: smpc["card"].step(x0s, um1, biases))
    err = float(np.abs(ctrl - ctrl_cpu).max() / np.abs(ctrl_cpu).max())
    if err > 1e-4:
        raise AssertionError(f"stacked: card {ctrl} vs CPU {ctrl_cpu}")
    # the host's part of a step: the two float64 products with the
    # whitening factor of the stacked Hessian, O(n_D^2) each
    q_D = np.ones(smpc["card"].n_D)
    tri_ms = median_ms(lambda: scipy.linalg.solve_triangular(
        smpc["card"]._L, q_D, lower=True))[0]
    back_ms = median_ms(lambda: smpc["card"]._L_invT @ q_D)[0]

    # the consensus problem. The default rho_consensus, the mean diagonal
    # of the condensed Hessian's du_0 block (2.1e10 here), holds the
    # scenarios together long before their first moves reach the stacked
    # optimum: after 40 outer iterations the reference's control is 0.2
    # from it (CPU, both packages alike). The curvature each scenario's
    # cost has in du_0 once its recourse moves are minimized out, the
    # mean diagonal of that block's Schur complement (1.9e6), converges.
    P_dd = scenario_mpc.condense(lin, K.P, K.M, K.Q, K.R, K.ysp,
                                 u_bounds=u_bounds).P_dd
    ni = lin.Ni
    schur = P_dd[:ni, :ni] - P_dd[:ni, ni:] @ np.linalg.solve(
        P_dd[ni:, ni:], P_dd[ni:, :ni])
    rho_c = float(np.trace(schur) / ni)
    consts, settings, dims = consensus_consts(
        lin, K.P, K.M, K.Q, K.R, K.ysp, u_bounds=u_bounds,
        rho_consensus=rho_c, device=dev)
    step = make_consensus_scenario_step(settings, dims, n_outer=40)
    cons_ms, (cons, gap, worst) = median_ms(
        lambda: step(consts, t32(x0s), t32(um1), t32(biases)))
    with cqp.host_driven():
        held = step(consts, t32(x0s), t32(um1), t32(biases))
    if not all(torch.equal(a, b) for a, b in zip((cons, gap, worst), held)):
        raise AssertionError("consensus: the device loop's batched solves "
                             "differ from the host-driven loop's")
    cons = cons.cpu().numpy().astype(float)
    cons_err = float(np.abs(cons - ctrl).max())
    if int(worst) != cqp.SOLVED or float(gap) >= 1e-3 or cons_err > 2e-3:
        raise AssertionError(f"consensus: worst {int(worst)}, gap "
                             f"{float(gap):.3e}, u {cons} vs stacked {ctrl}")

    # the independent solves against single solves of their rows. At
    # 1e-6 the MPC's float32 ADMM stops at max_iter on some rows, the
    # reference's too: the phase fails if more rows stop unsolved than
    # the reference's REF_UNSOLVED, or if any row is found infeasible
    solve = make_scenario_solver(K)
    um1s = np.tile(um1, (S, 1))
    solo_ms, (ctrls, preds, st) = median_ms(
        lambda: solve(t32(x0s), t32(um1s), t32(biases)))
    with cqp.host_driven():
        held = solve(t32(x0s), t32(um1s), t32(biases))
    if not all(torch.equal(a, b) for a, b in zip((ctrls, preds, st), held)):
        raise AssertionError("independent solves: the device loop differs "
                             "from the host-driven loop")
    unsolved = [i for i, v in enumerate(st.tolist()) if v != cqp.SOLVED]
    if len(unsolved) > REF_UNSOLVED or any(
            st[i] != cqp.MAX_ITER_REACHED for i in unsolved):
        raise AssertionError(f"independent solves: statuses {st.tolist()}, "
                             f"the reference {REF_UNSOLVED} unsolved")
    c_dev, step_fn = make_device_step(K)
    n_d, m = (K.M + 1) * K.Ni, K.qp.m
    solo_err = 0.0
    for i in range(S):
        one = step_fn(c_dev, t32(x0s[i]), t32(um1), t32(biases[i]),
                      torch.zeros(n_d, device=dev),
                      torch.zeros(m, device=dev))[0]
        solo_err = max(solo_err, float((one - ctrls[i]).abs().max()))
    if solo_err > 1e-4:
        raise AssertionError(f"independent solves: {solo_err:.3e} from the "
                             f"single solves")

    # the binding case: an outlier pressing its output bounds
    case = rig.binding_case()
    lin_b = LinearModel(*case["model"], 1.0, np.zeros(2), np.zeros(2),
                        np.zeros(2), np.zeros(2))
    args_b = (case["P"], case["M"], case["Q"], case["R"], lin_b, case["ysp"])
    sm = {where: ScenarioMPC(*args_b, n_scenarios=4,
                             y_bounds=case["y_bounds"], device=device)
          for where, device in (("card", dev), ("cpu", "cpu"))}
    scen = (case["x0s"], case["um1"], case["biases"])
    got = {where: s_mpc.step(*scen)[0] for where, s_mpc in sm.items()}
    du0, moves = sm["card"].last_moves()
    y_free = sm["card"]._y_free(*scen)
    slack = max(float(np.max(np.abs(y_free[s] + sm["card"]._cd.theta @ (
        np.concatenate([du0, moves[s].reshape(-1)]))) - 0.8))
        for s in range(4))
    binding_ms, _ = median_ms(lambda: sm["card"].step(*scen))
    K_b = MPC(*args_b, y_bounds=case["y_bounds"], device=dev)
    mean, _, st_b = make_scenario_solver(K_b)(
        t32(case["x0s"].mean(0)[None]), t32(case["um1"][None]),
        t32(case["biases"].mean(0)[None]))
    hedge = float(np.abs(got["card"] - mean[0].cpu().numpy()).max())
    bind_err = float(np.abs(got["card"] - got["cpu"]).max())
    if int(st_b[0]) != cqp.SOLVED or hedge <= 1e-3 or slack > 1e-3 \
            or bind_err > 1e-4:
        raise AssertionError(f"binding case: hedge {hedge:.3e}, bound "
                             f"overshoot {slack:.3e}, card vs CPU "
                             f"{bind_err:.3e}")
    expect_counts("scenario MPC (f)", read_counts(), {})
    metric = {
        "metric": "scenario_mpc_ms_S16_P300_M200", "unit": "ms",
        "stacked_step_ms": stacked_ms,
        "stacked_host_triangular_ms": tri_ms,
        "stacked_host_back_product_ms": back_ms,
        "consensus_step_ms": cons_ms, "independent_solves_ms": solo_ms,
        "binding_step_ms": binding_ms,
        "independent_unsolved": len(unsolved),
        "stacked_card_vs_cpu_rel": err, "consensus_vs_stacked": cons_err,
        "consensus_gap": float(gap), "rho_consensus": rho_c,
        "independent_vs_single": solo_err, "binding_hedge": hedge,
        "binding_card_vs_cpu": bind_err,
        "phase_s": time.perf_counter() - t_phase, "card": card,
    }
    log(f"scenario (f): stacked step {stacked_ms:.3f} ms median of "
        f"{TIMED_CALLS} (warm; its host products with the whitening "
        f"factor: triangular solve {tri_ms:.3f} ms, back-product "
        f"{back_ms:.3f} ms), card vs CPU rel {err:.2e}; consensus "
        f"(n_outer=40, rho_c {rho_c:.6g}) {cons_ms:.3f} ms, gap "
        f"{float(gap):.3e}, worst {int(worst)}, u {cons.tolist()} vs "
        f"stacked {ctrl.tolist()} ({cons_err:.2e}); independent solves of "
        f"{S} rows {solo_ms:.3f} ms, statuses {st.tolist()} (the reference "
        f"{REF_UNSOLVED} unsolved), {solo_err:.2e} from single solves; "
        f"binding case {binding_ms:.3f}"
        f" ms, hedge {hedge:.3e}, bound overshoot {slack:.2e}, card vs CPU "
        f"{bind_err:.2e}; phase {metric['phase_s']:.1f} s ({card})")
    scen = {"K": K, "x0s": t32(x0s), "um1": t32(um1), "um1s": t32(um1s),
            "biases": t32(biases), "consensus": (consts, settings, dims)}
    return metric, scen


def power_limit_w(card: str) -> float:
    """The watts of ``nvidia-smi``'s ``power.limit`` in the card line."""
    return float(card.rsplit(",", 1)[1].split()[0])


def phase_instrumentation(dev, seed: int, card: str) -> dict:
    """(g) The instrumentation on the flat ``ParticleFilter`` step under
    the auto route: ``RunSequences`` over 2^16, 2^18 and 2^20 particles
    (``RUN_SEQ_RUNS`` chained runs each, timed in chunks of 5 with one
    synchronise a chunk, as ``results/_filter_bench.time_op`` times
    them) with each sequence's ``max_abs_pacf``; ``PowerMeasurement``
    over ``POWER_T_RUN`` s of steps at 2^20; a ``StateCheckpointer``
    resume at 2^20 that must equal the unbroken run bit for bit."""
    t_phase = time.perf_counter()
    x0, state_pdf, meas_pdf = harness_rig(dev)
    f, g = bio.homeostatic_des, bio.static_outputs
    u = torch.tensor([0.06, 0.2], dtype=torch.float32, device=dev)
    z = bio.static_outputs(torch.from_numpy(X_SS)).to(torch.float32).to(dev)
    dt = 0.1
    kernels = ROUTE_KERNELS["auto"] + ("mixture_pdf",)

    def filt(n):
        return pf.ParticleFilter(f, g, n, x0, state_pdf, meas_pdf, seed=seed)

    @RunSequences.vectorize
    def run_seq(n, runs):
        fl = filt(n)
        zero_counts()
        for _ in range(GRAPH_WARM):
            fl.step(u, z, dt)
        torch.cuda.synchronize()
        out = np.empty(runs)
        done = 0
        while done < runs:
            c = min(RUN_SEQ_CHUNK, runs - done)
            t0 = time.perf_counter()
            for _ in range(c):
                fl.step(u, z, dt)
            torch.cuda.synchronize()
            out[done:done + c] = (time.perf_counter() - t0) / c * 1e3
            done += c
        expect_counts(f"run sequence, n={n}", read_counts(),
                      {k: runs + GRAPH_WARM for k in kernels})
        return out

    ns, seqs = run_seq(RUN_SEQ_NS, RUN_SEQ_RUNS)
    pacfs = [max_abs_pacf(sq, 10) for sq in seqs]
    for n, sq, p in zip(ns, seqs, pacfs):
        log(f"run sequence (g), n={n}: {RUN_SEQ_RUNS} chained flat steps "
            f"(auto), median {np.median(sq):.4f} ms/step, p10 "
            f"{np.percentile(sq, 10):.4f}, p90 {np.percentile(sq, 90):.4f};"
            f" max |pacf| over lags 1-10 {p:.3f} (gate 0.2: "
            f"{'passes' if p < 0.2 else 'fails'}; printed, not failed on) "
            f"({card})")

    fl = filt(N)
    for _ in range(GRAPH_WARM):
        fl.step(u, z, dt)
    torch.cuda.synchronize()

    def steps_for(n, t_run):
        t0, k = time.perf_counter(), 0
        while time.perf_counter() - t0 < t_run:
            for _ in range(10):
                fl.step(u, z, dt)
            torch.cuda.synchronize()
            k += 10
        return k

    zero_counts()
    measured = PowerMeasurement(steps_for)
    steps, (e_cpu, e_card) = measured(N, POWER_T_RUN)
    expect_counts("power, n=2^20", read_counts(), {k: steps for k in kernels})
    span = float(measured.last_samples[0, -1] - measured.last_samples[0, 0])
    watts = e_card / span
    limit = power_limit_w(card)
    if not (np.isfinite(e_card) and e_card > 0 and watts <= 1.05 * limit):
        raise AssertionError(f"power: card energy {e_card} J over {span:.2f}"
                             f" s against a limit of {limit} W")
    log(f"power (g), n={N}: {steps} flat steps in {span:.2f} s, "
        f"{measured.last_samples.shape[1]} samples; card {e_card:.2f} J "
        f"({e_card / steps:.4f} J/step, mean {watts:.1f} W of the "
        f"{limit:.0f} W limit); CPU {e_cpu:.2f} J ({e_cpu / steps:.4f} "
        f"J/step at the default 30 W; NaN where the host's CPU counters do "
        f"not advance) ({card})")

    # checkpoint, two steps, restore, the same two steps
    ckpt_dir = os.path.join(REPO, "chiprun_out", "smoke_checkpoint")
    zero_counts()
    ckpt = StateCheckpointer(ckpt_dir, max_to_keep=1)
    state = fl.state
    ckpt.save(0, state)

    def two_steps():
        for _ in range(2):
            fl.step(u, z, dt)
        return fl.state

    # the shell's graphed steps: the restore sets the state of the
    # generator its graphs registered
    first = two_steps()
    fl.state = ckpt.restore(state)
    again = two_steps()
    ckpt.close()
    shutil.rmtree(ckpt_dir)
    expect_counts("checkpoint resume", read_counts(), {k: 4 for k in kernels})
    if not (torch.equal(first.particles, again.particles)
            and torch.equal(first.weights, again.weights)):
        raise AssertionError("checkpoint: the resumed steps differ")
    metric = {
        "metric": "instrumentation_flat_pf", "unit": "ms/step",
        "run_seq_median_ms": {int(n): float(np.median(sq))
                              for n, sq in zip(ns, seqs)},
        "max_abs_pacf": {int(n): float(p) for n, p in zip(ns, pacfs)},
        "power_steps": steps, "power_span_s": span,
        "card_j_per_step": float(e_card / steps),
        # null where the host's CPU counters gave no reading (NaN)
        "cpu_j_per_step": float(e_cpu / steps) if np.isfinite(e_cpu)
        else None,
        "card_mean_w": float(watts),
        "phase_s": time.perf_counter() - t_phase, "card": card,
    }
    log(f"checkpoint (g), n={N}: saved, two steps, restored, the same two "
        f"steps: bit-equal; phase {metric['phase_s']:.1f} s ({card})")
    return metric


# ----------------------------------------------------------------------
# (h) the multi-device slice
# ----------------------------------------------------------------------
def chained_ms(step, state, steps: int = SHARD_STEPS):
    """``(ms per step by CUDA events, last state)`` of ``steps`` chained
    calls of ``step`` after ``SHARD_WARM`` untimed calls (a graphed
    step's captures: a state whose layout the step changes keys a second
    graph)."""
    for _ in range(SHARD_WARM):
        state = step(state)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        state = step(state)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps, state


def check_draws(path: str, draws, rank: int, n_local: int, s: int) -> None:
    """Fail unless every draw of ``draws`` was this rank's own samples,
    ``[rank n_local s, (rank + 1) n_local s)``."""
    want = (rank * n_local * s, n_local * s)
    if not draws or any(d[:2] != want for d in draws):
        raise AssertionError(f"{path}: rank {rank} drew {draws}, not "
                             f"{want}")


def host_reads(fn) -> tuple[int, int]:
    """``(device-to-host copies, device ops)`` of one call of ``fn`` under
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    ops = [e.name for e in prof.events() if e.device_type == cuda]
    return sum("DtoH" in n for n in ops), len(ops)


def w2_inputs(seed: int):
    """(h)'s global resample input at W = 2: ``(particles (N_W2, 5),
    lognormal weights of sigma 4, r)``, float32 from the seed."""
    rng = np.random.default_rng(seed + 21)
    return (rng.standard_normal((N_W2, 5)).astype(np.float32),
            np.exp(4.0 * rng.standard_normal(N_W2)).astype(np.float32),
            np.float32(0.417))


def shard_step_args(dev):
    """``(f, g, u, z, dt)`` of (h)'s sharded steps: the bench rig's model
    at the steady state's outputs."""
    u = torch.tensor([0.06, 0.2], dtype=torch.float32, device=dev)
    z = bio.static_outputs(torch.from_numpy(X_SS)).to(torch.float32).to(dev)
    return (bio.homeostatic_des, bio.static_outputs, u, z,
            torch.tensor(0.1, device=dev))


W2_ROUTES = ("kernel", "a2a", "tiled ragged")
# (h)'s entry points at W = 2 and the kernels each launches a step
W2_STEPS = {"flat kernel": ("ends_merge_round", "counter_draw",
                            "mixture_pdf"),
            "flat a2a": ("compact", "expand", "counter_draw", "mixture_pdf"),
            "gsukf kernel": ("ends_merge_round", "counter_draw",
                             "mixture_pdf"),
            "tiled ragged": ("compact", "expand")}
N_BANK_W2 = 2 * N_BANK    # (h)'s global Gaussians at W = 2
W2_TIMED = 5              # chained steps timed a W = 2 entry point


def w2_resample(mesh, name, parts, w, r):
    """This rank's rows (``(n_local, 5)``) of one of ``W2_ROUTES``."""
    if name == "tiled ragged":
        ends, prev = sharded._segmented_ends(w, r, mesh)
        return sharded._a2a_compact_exchange_merge(
            parts.T.contiguous(), ends, prev, mesh, "ragged").T
    return sharded._resample(parts, w, r, mesh,
                             sharded._FLAT_ROUTES[name])[0]


def shard_entry(mesh, name: str, seed: int, width=None):
    """``(state, fn, step)`` of the entry point ``name`` on this rank: its
    slice of one global state of 2^20 particles (2^18 Gaussians) for
    each of ``width`` ranks (default: the mesh's), from
    ``results/sharded_steps.entry_step``."""
    return sharded_steps.entry_step(mesh, name, seed + 22,
                                    bench_rig(mesh.device), width)


def w2_step(mesh, name, seed: int):
    """``(state, step)`` of one of ``W2_STEPS`` on this rank: its slice of
    W = 2's global state of N_W2 particles (N_BANK_W2 Gaussians)."""
    state, _, step = shard_entry(mesh, name, seed, 2)
    return state, step


def w2_fields(name: str, state):
    """The arrays of a W = 2 entry point's state that W = 1's must
    equal."""
    if name.startswith("tiled"):
        return (state.x,)
    if name.startswith("gsukf"):
        return (state.means, state.covariances, state.weights)
    return (state.particles, state.weights)


def w2_rank(seed: int):
    """One rank of (h)'s W = 2 run (a spawned process of a gloo group,
    both ranks on card 0): each route's resampled rows and launches, then
    each entry point's first step, its launches and its ms a step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = par.make_mesh()
    torch.cuda.set_device(mesh.device)
    p_np, w_np, r_np = w2_inputs(seed)
    parts = par.particle_sharding(mesh, p_np)
    w = par.particle_sharding(mesh, w_np)
    r = torch.tensor(r_np, device=mesh.device)
    rows = {}
    for name in W2_ROUTES:
        zero_counts()
        got = w2_resample(mesh, name, parts, w, r)
        torch.cuda.synchronize()
        rows[name] = (got.cpu().numpy(), read_counts())
    steps = {}
    for name in W2_STEPS:
        state, step = w2_step(mesh, name, seed)
        zero_counts()
        with counted_draws() as draws:
            first, peak, ms = sharded_steps.step_rows(step, state, W2_TIMED,
                                                      mesh.device)
        first = tuple(t.cpu().numpy() for t in w2_fields(name, first))
        steps[name] = (first, read_counts(), ms, draws, peak)
    return mesh.rank, str(mesh.device), rows, steps


def phase_multi_device(dev, seed: int, card: str, scen) -> dict:
    """(h) The multi-device slice: at W = 1 under NCCL in this process,
    every sharded route of the flat (2^20), tiled (2^20) and GSUKF (2^18)
    steps, the auto-sharded steps and (f)'s scenario solvers through a
    mesh of one; then W = 2 as two processes on this card over gloo."""
    t_phase = time.perf_counter()
    par.initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        one = torch.ones(1, device=dev)
        dist.all_reduce(one)
        mesh = par.make_mesh()
        if (mesh.size, mesh.device, mesh.backend) != (1, dev, "nccl"):
            raise AssertionError(f"mesh {mesh}")
        metric = {"metric": "multi_device_ms_per_step", "unit": "ms/step",
                  "w1": multi_w1(dev, seed, card, scen, mesh)}
    finally:
        dist.destroy_process_group()
    metric["w2"] = multi_w2(dev, seed, card)
    metric.update(phase_s=time.perf_counter() - t_phase, card=card)
    log(f"multi-device (h): phase {metric['phase_s']:.1f} s ({card})")
    return metric


def multi_w1(dev, seed: int, card: str, scen, mesh) -> dict:
    x0, state_pdf, meas_pdf = bench_rig(dev)
    f, g, u, z, dt = shard_step_args(dev)
    ms = {}

    def gen(k=0):
        return torch.Generator(device=dev).manual_seed(seed + k)

    # the flat step: every route on one input, then chained and timed
    start = pf.init(gen(), N, x0)
    noise = state_pdf.draw(start.generator, (N,))
    r = torch.rand((), generator=start.generator, device=dev)
    xn = pf.predict_from_noise(start.particles, u, dt, f, noise)
    wn = pf.update(pf.PFState(xn, start.weights, None), u, z, g,
                   meas_pdf).weights
    ends, _ = sharded._segmented_ends(wn, r, mesh)
    plain = xn[torch.clamp(rc.indices_from_ends(ends), max=N - 1).long()]
    for name, kernels in SHARD_FLAT.items():
        step = par.make_shard_map_step(mesh, f, g, resample_impl=name)
        zero_counts()
        got, _ = step.from_noise(start.particles, start.weights, u, z, dt,
                                 meas_pdf, noise, r)
        assert_equal(f"sharded flat {name} vs plain", (got,), (plain,))
        reads, ops = host_reads(lambda: step.from_noise(
            start.particles, start.weights, u, z, dt, meas_pdf, noise, r))
        with counted_draws() as draws:
            ms[f"flat {name}"], last = chained_ms(
                lambda s: step(s, u, z, dt, state_pdf, meas_pdf),
                pf.PFState(start.particles, start.weights, gen(1)))
        check_draws(f"sharded flat step, {name}", draws, 0, N, 1)
        # from_noise twice, then the chained steps and their warm-up
        expect_counts(f"sharded flat step, {name}", read_counts(),
                      {**{k: SHARD_STEPS + SHARD_WARM + 2
                          for k in kernels + ("mixture_pdf",)},
                       "counter_draw": SHARD_STEPS + SHARD_WARM})
        if not torch.isfinite(last.particles).all():
            raise AssertionError(f"sharded flat {name}: non-finite")
        log(f"multi-device (h), W=1 NCCL, flat step {name} at n={N}: "
            f"{ms[f'flat {name}']:.4f} ms/step ({SHARD_STEPS} chained, CUDA "
            f"events); == plain resample bit for bit; one step: {reads} "
            f"device-to-host copies, {ops} device ops; each step drew "
            f"samples [0, {N}) by counter_draw ({card})")

    # the tiled step: both exchanges from one state, then the resample
    # of one step against the ring route
    tiled0 = pft.init(gen(2), N, x0)
    outs = {}
    for exchange in SHARD_TILED:
        step = par.make_shard_map_tiled_step(mesh, f, g, exchange=exchange)
        zero_counts()
        ms[f"tiled {exchange}"], last = chained_ms(
            lambda s: step(s, u, z, dt, state_pdf, meas_pdf),
            par.shard_tiled_pf_state(tiled0, mesh))
        calls = SHARD_STEPS + SHARD_WARM
        expect_counts(f"sharded tiled step, {exchange}", read_counts(),
                      {"compact": calls, "expand": calls})
        outs[exchange] = last.x
        log(f"multi-device (h), W=1 NCCL, tiled step {exchange} at n={N}: "
            f"{ms[f'tiled {exchange}']:.4f} ms/step ({card})")
    assert_equal("sharded tiled ragged vs ring", (outs["ragged"],),
                 (outs["ring"],))
    x = outs["ragged"]
    w = torch.rand(N, generator=gen(3), device=dev)
    ends, prev = sharded._segmented_ends(w, r, mesh)
    got = sharded._a2a_compact_exchange_merge(x, ends, prev, mesh, "ragged")
    want, _ = sharded._distributed_systematic_resample(x.T, w, r, mesh)
    assert_equal("sharded tiled resample vs ring route", (got.T,), (want,))

    # the GSUKF step at 2^18: every route on one input, then timed
    n_b, nx = N_BANK, 5
    g0 = gsf.init(gen(4), n_b, x0, state_pdf)
    g_noise = state_pdf.draw_t(g0.generator, n_b * (2 * nx + 1)).reshape(
        nx, 2 * nx + 1, n_b).transpose(0, 1)
    g_r = torch.rand((), generator=g0.generator, device=dev)
    first = None
    for name, kernels in SHARD_GSUKF.items():
        step = par.make_shard_map_gsukf_step(mesh, f, g, resample_impl=name)
        zero_counts()
        (m, c), _ = step.from_noise(g0.means, g0.covariances, g0.weights, u,
                                    z, dt, meas_pdf, g_noise, g_r)
        first = first or (m, c)
        assert_equal(f"sharded GSUKF {name} vs xla", (m, c), first)
        with counted_draws() as draws:
            ms[f"gsukf {name}"], last = chained_ms(
                lambda s: step(s, u, z, dt, state_pdf, meas_pdf),
                gsf.GSUKFState(g0.means, g0.covariances, g0.weights, gen(5)),
                steps=3)
        check_draws(f"sharded GSUKF step, {name}", draws, 0, n_b,
                    2 * nx + 1)
        # from_noise, then 3 chained steps and their warm-up
        expect_counts(f"sharded GSUKF step, {name}", read_counts(),
                      {**{k: 4 + SHARD_WARM
                          for k in kernels + ("mixture_pdf",)},
                       "counter_draw": 3 + SHARD_WARM})
        if not torch.isfinite(last.covariances).all():
            raise AssertionError(f"sharded GSUKF {name}: non-finite")
        log(f"multi-device (h), W=1 NCCL, GSUKF step {name} at N={n_b}: "
            f"{ms[f'gsukf {name}']:.4f} ms/step; each step drew samples "
            f"[0, {n_b * (2 * nx + 1)}) by counter_draw ({card})")

    # the auto-sharded steps against the single-device steps
    zero_counts()
    got = par.make_auto_sharded_step(mesh, f, g)(
        par.shard_pf_state(pf.PFState(start.particles, start.weights,
                                      gen(6)), mesh),
        u, z, dt, state_pdf, meas_pdf)
    want = pf.step(pf.PFState(start.particles, start.weights, gen(6)), u, z,
                   dt, f, g, state_pdf, meas_pdf)
    assert_equal("auto-sharded flat step", (got.particles, got.weights),
                 (want.particles, want.weights))
    got = par.make_auto_sharded_gsukf_step(mesh, f, g)(
        par.shard_gsukf_state(gsf.GSUKFState(g0.means, g0.covariances,
                                             g0.weights, gen(7)), mesh),
        u, z, dt, state_pdf, meas_pdf)
    want = gsf.step(gsf.GSUKFState(g0.means, g0.covariances, g0.weights,
                                   gen(7)), u, z, dt, f, g, state_pdf,
                    meas_pdf)
    assert_equal("auto-sharded GSUKF step", (got.means, got.covariances),
                 (want.means, want.covariances))
    expect_counts("auto-sharded steps", read_counts(),
                  {"compact": 4, "expand": 4, "mixture_pdf": 4})
    log(f"multi-device (h), W=1 NCCL: auto-sharded flat (n={N}) and GSUKF "
        f"(N={n_b}) steps == single-device steps bit for bit ({card})")

    # (f)'s scenario rig through a mesh of one
    K = scen["K"]
    args = (scen["x0s"], scen["um1s"], scen["biases"])
    for a, b in zip(make_scenario_solver(K, mesh)(*args),
                    make_scenario_solver(K)(*args)):
        assert_equal("scenario solver, mesh of one", (a,), (b,))
    consts, settings, dims = scen["consensus"]
    cargs = (consts, scen["x0s"], scen["um1"], scen["biases"])
    for a, b in zip(
            make_consensus_scenario_step(settings, dims, mesh)(*cargs),
            make_consensus_scenario_step(settings, dims)(*cargs)):
        assert_equal("consensus step, mesh of one", (a,), (b,))
    log(f"multi-device (h), W=1 NCCL: (f)'s independent solves and "
        f"consensus step through a mesh of one == mesh=None bit for bit "
        f"({card})")
    return ms


def multi_w2(dev, seed: int, card: str) -> dict:
    """W = 2: two spawned processes on this card over gloo (NCCL refuses
    two ranks on one card), each with 2^20 of the 2^21 particles. Every
    route's rows, and the first step of the flat entry point, equal
    W = 1's on the same global input; the tiled entry point, whose noise
    depends on the width, steps to finite particles. Each launches its
    kernels on every rank."""
    p_np, w_np, r_np = w2_inputs(seed)
    one = par.make_mesh(1, device=dev)
    parts, w = torch.from_numpy(p_np).to(dev), torch.from_numpy(w_np).to(dev)
    r = torch.tensor(r_np, device=dev)
    want = {name: w2_resample(one, name, parts, w, r).cpu().numpy()
            for name in W2_ROUTES}
    want_step = {}
    for name in W2_STEPS:
        if not name.startswith("tiled"):
            state, step = w2_step(one, name, seed)
            want_step[name] = tuple(t.cpu().numpy()
                                    for t in w2_fields(name, step(state)))
    t0 = time.perf_counter()
    ranks = run_group(w2_rank, 2, seed, timeout_s=W2_TIMEOUT_S)
    wall = time.perf_counter() - t0

    def same(got, want_):
        return np.array_equal(got.view(np.int32), want_.view(np.int32))

    def check_counts(name, counts, kernels):
        for c in counts:
            if any(c[k] < 1 for k in kernels) or any(
                    v for k, v in c.items() if k not in kernels):
                raise AssertionError(f"W=2 {name}: launches {counts}")

    for name in W2_ROUTES:
        got = np.concatenate([rows[name][0] for _, _, rows, _ in ranks])
        if not same(got, want[name]):
            raise AssertionError(f"W=2 {name}: rows differ from W=1's")
        counts = [rows[name][1] for _, _, rows, _ in ranks]
        kernels = (("ends_merge_round",) if name == "kernel"
                   else ("compact", "expand"))
        check_counts(name, counts, kernels)
        log(f"multi-device (h), W=2 (two processes on card 0, gloo with "
            f"host copies), {name} resample at n={N_W2} (2^20 a rank, "
            f"lognormal weights): == W=1 bit for bit; launches "
            f"{[{k: c[k] for k in kernels} for c in counts]} ({card})")
    ms, peaks = {}, {}
    for name, kernels in W2_STEPS.items():
        firsts = [steps[name][0] for _, _, _, steps in ranks]
        counts = [steps[name][1] for _, _, _, steps in ranks]
        check_counts(name, counts, kernels)
        n_local, s = ((N_BANK_W2 // 2, 11) if name.startswith("gsukf")
                      else (N_W2 // 2, 1))
        for rank, (_, _, _, steps) in enumerate(ranks):
            if "counter_draw" in kernels:
                check_draws(f"W=2 {name} step", steps[name][3], rank,
                            n_local, s)
        peaks[name] = [steps[name][4] for _, _, _, steps in ranks]
        if name in want_step:
            for k, want_k in enumerate(want_step[name]):
                got = np.concatenate([f[k] for f in firsts])
                if not same(got, want_k):
                    raise AssertionError(
                        f"W=2 {name} step: field {k} differs from W=1's")
            verdict = ("== W=1 bit for bit; each rank drew its own "
                       f"{n_local * s} samples")
        else:
            if not all(np.isfinite(f[0]).all() for f in firsts):
                raise AssertionError(f"W=2 {name} step: non-finite")
            verdict = "finite (its noise depends on the width)"
        ms[name] = [steps[name][2] for _, _, _, steps in ranks]
        log(f"multi-device (h), W=2 (two processes on card 0, gloo with "
            f"host copies), {name} step at n={2 * n_local} ({n_local} a "
            f"rank): {ms[name][0]:.3f} / {ms[name][1]:.3f} ms/step (rank 0 "
            f"/ 1, {W2_TIMED} chained, CUDA events); first step {verdict}; "
            f"the next step's peak memory above its state {peaks[name][0] / 2**20:.1f} / "
            f"{peaks[name][1] / 2**20:.1f} MiB; launches "
            f"{[{k: c[k] for k in kernels} for c in counts]} ({card})")
    log(f"multi-device (h), W=2: devices {[d for _, d, _, _ in ranks]}, "
        f"{wall:.1f} s with the start-up ({card})")
    return {"ms_per_step": ms, "step_peak_bytes": peaks}


# ----------------------------------------------------------------------
# (j) the sharded closed-loop control step
# ----------------------------------------------------------------------
CTRL_EVENTS = 5           # control events a run
CTRL_DT = 0.1             # the filter's time step, dt_control
# the flat control step's routes at full width and the kernels each
# launches once a step a rank (ends_merge_round: once a block not skipped)
CTRL_ROUTES = {"a2a": ("compact", "expand", "counter_draw", "mixture_pdf"),
               "kernel": ("ends_merge_round", "counter_draw", "mixture_pdf")}
# the other filters: (filter, route, global count at W = 1, kernels)
CTRL_OTHERS = {"gsukf": ("gsukf", "kernel", N_BANK,
                         ("ends_merge_round", "counter_draw",
                          "mixture_pdf")),
               "tiled": ("tiled", "ragged", N, ("compact", "expand"))}
CTRL_TIMEOUT_S = 300
# (j): the sharded entry points at W = 1 whose factories graph them, and
# the kernels each launches a step; those that stay eager (the ragged
# exchange reads its sizes on the host)
SHARD_GRAPHED = {
    "flat xla": ("counter_draw", "mixture_pdf"),
    "flat kernel": ("ends_merge_round", "counter_draw", "mixture_pdf"),
    "flat a2a_ring_v4": ("compact", "expand", "counter_draw", "mixture_pdf"),
    "flat a2a_ring": ("counter_draw", "mixture_pdf"),
    "gsukf xla": ("counter_draw", "mixture_pdf"),
    "gsukf kernel": ("ends_merge_round", "counter_draw", "mixture_pdf"),
    "gsukf a2a_ring": ("counter_draw", "mixture_pdf"),
    "tiled ring": ("compact", "expand"),
}
SHARD_EAGER = ("flat a2a", "flat a2a_xla", "gsukf a2a", "tiled ragged")
SHARD_GRAPH_STEPS = 5     # (j): chained steps held bit-equal, graphed-eager


def ctrl_args(mpc, dev):
    """``(um1, z, bias, warm_v, warm_y)`` of a first control event: the
    bench rig's input and steady-state outputs, no bias, a cold start."""
    _, _, u, z, _ = shard_step_args(dev)
    n_d, m = (mpc.M + 1) * mpc.Ni, mpc.qp.m
    return (u, z, torch.zeros(mpc.No, device=dev),
            torch.zeros(n_d, device=dev), torch.zeros(m, device=dev))


def ctrl_state(kind: str, n: int, mesh, seed: int):
    """This rank's slice of a global filter state of ``n`` particles
    (Gaussians) on the bench rig, drawn from the seed on the mesh's
    device: the same global state at every width."""
    x0, state_pdf, _ = bench_rig(mesh.device)
    gen = torch.Generator(device=mesh.device).manual_seed(seed + 23)
    if kind == "gsukf":
        return par.shard_gsukf_state(gsf.init(gen, n, x0, state_pdf), mesh)
    if kind == "tiled":
        return par.shard_tiled_pf_state(pft.init(gen, n, x0), mesh)
    return par.shard_pf_state(pf.init(gen, n, x0), mesh)


def ctrl_events(mesh, step, state, mpc, events: int = CTRL_EVENTS):
    """``events`` chained control events of ``step`` from ``state``: each
    feeds the last control back as ``um1`` and the last solution as the
    warm start. Returns one record an event: the global estimate, the
    ``um1`` it was given, ``u``, the status, the iterations and its ms by
    CUDA events (the filter step, the estimate and the solve)."""
    dev = mesh.device
    _, state_pdf, meas_pdf = bench_rig(dev)
    um1, z, bias, warm_v, warm_y = ctrl_args(mpc, dev)
    recs = []
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for _ in range(events):
        start.record()
        state, u, _, sol = step(state, um1, z, bias, warm_v, warm_y,
                                state_pdf, meas_pdf)
        end.record()
        torch.cuda.synchronize(dev)
        recs.append(dict(
            est=sharded.point_estimate(state, mesh).cpu().numpy(),
            um1=um1.cpu().numpy(), u=u.cpu().numpy(),
            status=int(sol.status), iterations=int(sol.iterations),
            ms=start.elapsed_time(end)))
        # the solution's tensors are the QP graph's own, rewritten by the
        # next solve
        um1, warm_v, warm_y = u.clone(), sol.x.clone(), sol.y.clone()
    return recs


def replicated_control_step(mesh, mpc, lin, route: str):
    """The other way to end the control step, timed beside the port's
    (rank 0's solve, broadcast): the same sharded filter step and global
    estimate, then the QP solved on every rank, as the reference solves
    it on every device. Returns a step of
    :func:`make_sharded_control_step`'s signature."""
    dev = mesh.device
    fstep = par.make_shard_map_step(mesh, bio.homeostatic_des,
                                    bio.static_outputs, resample_impl=route)
    consts, solve = make_device_step(mpc)
    states, inputs = list(lin.states), list(lin.inputs)
    x_bar = torch.tensor(lin.x_bar, dtype=torch.float32, device=dev)
    u_bar = torch.tensor(lin.u_bar, dtype=torch.float32, device=dev)
    dt = torch.tensor(CTRL_DT, device=dev)

    def step(state, um1, z, bias, warm_v, warm_y, state_pdf, meas_pdf):
        state = fstep(state, um1, z, dt, state_pdf, meas_pdf)
        x_hat = sharded.point_estimate(state, mesh)
        ctrl, y_pred, sol = solve(consts, x_hat[states] - x_bar,
                                  um1[inputs] - u_bar, bias, warm_v, warm_y)
        return state, ctrl + u_bar, y_pred, sol

    return step


def ctrl_rank(seed: int, mpc_cpu, lin):
    """One rank of (j)'s W = 2 run (a spawned process of a gloo group,
    both ranks on card 0): the flat control step at N_W2 particles
    through each of ``CTRL_ROUTES``, its records and launches; the
    port's rank-0 solve and the replicated solve timed in turns; one
    event of each of ``CTRL_OTHERS``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = par.make_mesh()
    torch.cuda.set_device(mesh.device)
    mpc = mpc_cpu.to(mesh.device)
    f, g = bio.homeostatic_des, bio.static_outputs
    out = {}
    for route in CTRL_ROUTES:
        step = make_sharded_control_step(mesh, mpc, lin, f, g, dt=CTRL_DT,
                                         resample_impl=route)
        state = ctrl_state("pf", N_W2, mesh, seed)
        zero_counts()
        recs = ctrl_events(mesh, step, state, mpc)
        out[route] = (recs, read_counts())
    solves = {"rank 0": make_sharded_control_step(
        mesh, mpc, lin, f, g, dt=CTRL_DT, resample_impl="a2a"),
              "replicated": replicated_control_step(mesh, mpc, lin, "a2a")}
    out["solve_ms"] = {k: [] for k in solves}
    for name in ("replicated", "rank 0", "replicated", "rank 0"):
        dist.barrier()
        recs = ctrl_events(mesh, solves[name],
                           ctrl_state("pf", N_W2, mesh, seed), mpc)
        out["solve_ms"][name] += [r["ms"] for r in recs]
        out.setdefault("solve_u", {})[name] = [r["u"] for r in recs]
    for name, (kind, route, n, _) in CTRL_OTHERS.items():
        step = make_sharded_control_step(mesh, mpc, lin, f, g, dt=CTRL_DT,
                                         filter=kind, resample_impl=route)
        zero_counts()
        recs = ctrl_events(mesh, step, ctrl_state(kind, 2 * n, mesh, seed),
                           mpc, events=1)
        out[name] = (recs, read_counts())
    return mesh.rank, out


def ctrl_check_solves(path: str, recs, mpc, lin, dev) -> None:
    """Fail unless each event's ``u`` equals, bit for bit, one solve of
    ``make_device_step`` on this process fed the event's estimate and
    ``um1``, warm-started by the previous such solve, as the event was."""
    consts, solve = make_device_step(mpc)
    states, inputs = list(lin.states), list(lin.inputs)
    x_bar = torch.tensor(lin.x_bar, dtype=torch.float32, device=dev)
    u_bar = torch.tensor(lin.u_bar, dtype=torch.float32, device=dev)
    _, _, bias, warm_v, warm_y = ctrl_args(mpc, dev)
    for k, rec in enumerate(recs):
        est = torch.from_numpy(rec["est"]).to(dev)
        um1 = torch.from_numpy(rec["um1"]).to(dev)
        ctrl, _, sol = solve(consts, est[states] - x_bar,
                             um1[inputs] - u_bar, bias, warm_v, warm_y)
        want = (ctrl + u_bar).cpu().numpy()
        if not np.array_equal(want.view(np.int32), rec["u"].view(np.int32)):
            raise AssertionError(f"(j) {path}, event {k}: u {rec['u']} != "
                                 f"a single-rank solve's {want}")
        warm_v, warm_y = sol.x.clone(), sol.y.clone()


def ctrl_same(path: str, got, want) -> None:
    """Fail unless the records' estimates and controls are bit-equal."""
    for k, (a, b) in enumerate(zip(got, want)):
        for key in ("est", "u"):
            if not np.array_equal(a[key].view(np.int32),
                                  b[key].view(np.int32)):
                raise AssertionError(f"(j) {path}, event {k}: {key} "
                                     f"{a[key]} != {b[key]}")


def ctrl_counts(path: str, counts, kernels, events: int) -> None:
    """Fail unless each of ``kernels`` launched once an event on this
    rank (``ends_merge_round`` once a block not skipped: 1 or 2 at W = 2)
    and no other kernel launched."""
    for k, c in counts.items():
        lo = events if k in kernels else 0
        hi = lo * (2 if k == "ends_merge_round" else 1)
        if not lo <= c <= hi:
            raise AssertionError(f"(j) {path}: launches {counts}")


def ctrl_line(recs) -> str:
    ms = [r["ms"] for r in recs]
    median = (f" (median of events 2-{len(ms)} {np.median(ms[1:]):.3f})"
              if len(ms) > 1 else "")
    return (f"{' '.join(f'{t:.3f}' for t in ms)} ms per control event"
            f"{median}; QP statuses {[r['status'] for r in recs]}, "
            f"iterations {[r['iterations'] for r in recs]}")


def phase_control(dev, seed: int, card: str, s, mpc_cpu) -> dict:
    """(j) The sharded closed-loop control step on the canonical MPC
    (P = 2999, M = 1999, built once by ``control_setup``): at W = 1 in a
    one-rank NCCL group, the flat step at 2^20 through ``a2a`` and
    ``kernel``, 5 events each, and at 2^21 (W = 2's global state); the
    GSUKF at 2^18 and 2^19 and the tiled step at 2^20, one event each;
    then W = 2 over gloo on this card; ``dryrun_multichip(2)``; the
    serial engine as the oracle of the flat predict and update."""
    t_phase = time.perf_counter()
    mpc, lin = s.K, s.lin_model
    f, g = bio.homeostatic_des, bio.static_outputs
    metric = {"metric": "sharded_control_ms_per_event", "unit": "ms/event",
              "card": card}
    par.initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        mesh = par.make_mesh()
        w1 = {}
        for n, routes in ((N, CTRL_ROUTES), (N_W2, ("a2a",))):
            for route in routes:
                step = make_sharded_control_step(
                    mesh, mpc, lin, f, g, dt=CTRL_DT, resample_impl=route)
                zero_counts()
                recs = ctrl_events(mesh, step, ctrl_state("pf", n, mesh, seed),
                                   mpc)
                expect_counts(f"(j) W=1 flat {route} at n={n}", read_counts(),
                              {k: CTRL_EVENTS for k in CTRL_ROUTES[route]})
                ctrl_check_solves(f"W=1 flat {route} at n={n}", recs, mpc,
                                  lin, dev)
                w1[f"flat {route} {n}"] = recs
                log(f"sharded control (j), W=1 NCCL, flat {route} at n={n}: "
                    f"{ctrl_line(recs)}; each u == a single-rank "
                    f"make_device_step fed the same estimate ({card})")
        for name, (kind, route, n, kernels) in CTRL_OTHERS.items():
            # the GSUKF also at W = 2's global count: W = 2 must equal it
            for n_glob in (n, 2 * n) if kind == "gsukf" else (n,):
                step = make_sharded_control_step(
                    mesh, mpc, lin, f, g, dt=CTRL_DT, filter=kind,
                    resample_impl=route)
                zero_counts()
                recs = ctrl_events(mesh, step,
                                   ctrl_state(kind, n_glob, mesh, seed), mpc,
                                   events=1)
                expect_counts(f"(j) W=1 {name} at n={n_glob}", read_counts(),
                              {k: 1 for k in kernels})
                if not np.isfinite(recs[0]["u"]).all():
                    raise AssertionError(f"(j) W=1 {name}: non-finite u")
                w1[f"{name} {n_glob}"] = recs
                log(f"sharded control (j), W=1 NCCL, {name} ({route}) at "
                    f"n={n_glob}: {ctrl_line(recs)} ({card})")
        metric["w1_graphed_vs_eager"] = ctrl_graphed(mesh, mpc, lin, seed,
                                                     card)
    finally:
        dist.destroy_process_group()
    metric["w1_ms"] = {k: [r["ms"] for r in v] for k, v in w1.items()}
    metric["w1_status"] = {k: [r["status"] for r in v]
                           for k, v in w1.items()}

    t0 = time.perf_counter()
    ranks = run_group(ctrl_rank, 2, seed, mpc_cpu, lin,
                      timeout_s=CTRL_TIMEOUT_S)
    wall = time.perf_counter() - t0
    outs = [out for _, out in sorted(ranks, key=lambda r: r[0])]
    want = w1[f"flat a2a {N_W2}"]
    metric["w2_ms"] = {}
    for route, kernels in CTRL_ROUTES.items():
        for rank, out in enumerate(outs):
            recs, counts = out[route]
            ctrl_same(f"W=2 flat {route}, rank {rank} vs W=1", recs, want)
            ctrl_counts(f"W=2 flat {route}, rank {rank}", counts, kernels,
                        CTRL_EVENTS)
        metric["w2_ms"][f"flat {route}"] = [[r["ms"] for r in out[route][0]]
                                            for out in outs]
        log(f"sharded control (j), W=2 (two processes on card 0, gloo), "
            f"flat {route} at n={N_W2} ({N} a rank): rank 0 "
            f"{ctrl_line(outs[0][route][0])}; rank 1 "
            f"{ctrl_line(outs[1][route][0])}; estimates and u == W=1's bit "
            f"for bit on both ranks; launches "
            f"{[out[route][1] for out in outs]} ({card})")
    for name in ("replicated", "rank 0"):
        us = [out["solve_u"][name] for out in outs]
        for a, b in zip(*us):
            if not np.array_equal(a.view(np.int32), b.view(np.int32)):
                raise AssertionError(f"(j) W=2 {name} solve: u differs "
                                     f"between the ranks")
    metric["w2_solve_ms"] = {k: [out["solve_ms"][k] for out in outs]
                             for k in outs[0]["solve_ms"]}
    log("sharded control (j), W=2, the port's solve on rank 0 and "
        "broadcast against the solve replicated on both ranks (a2a, in "
        "turns replicated, rank 0, replicated, rank 0, 5 events each), "
        "median ms per event rank 0 / 1: " + "; ".join(
            f"{k} {np.median(v[0]):.3f} / {np.median(v[1]):.3f}"
            for k, v in metric["w2_solve_ms"].items()) + f" ({card})")
    for name, (kind, route, n, kernels) in CTRL_OTHERS.items():
        recs = [out[name][0][0] for out in outs]
        if not np.array_equal(recs[0]["u"].view(np.int32),
                              recs[1]["u"].view(np.int32)):
            raise AssertionError(f"(j) W=2 {name}: u differs between ranks")
        if kind == "gsukf":
            ctrl_same(f"W=2 {name} vs W=1", recs, w1[f"{name} {2 * n}"])
        elif not np.isfinite(recs[0]["u"]).all():
            raise AssertionError(f"(j) W=2 {name}: non-finite u")
        for rank, out in enumerate(outs):
            ctrl_counts(f"W=2 {name}, rank {rank}", out[name][1], kernels, 1)
        metric["w2_ms"][name] = [out[name][0][0]["ms"] for out in outs]
        log(f"sharded control (j), W=2, {name} ({route}) at n={2 * n}: "
            f"{metric['w2_ms'][name][0]:.3f} / {metric['w2_ms'][name][1]:.3f}"
            f" ms (rank 0 / 1), QP status {recs[0]['status']}; u bit-equal "
            f"on both ranks"
            + (", estimate and u == W=1's" if kind == "gsukf" else "")
            + f"; launches {[out[name][1] for out in outs]} ({card})")
    log(f"sharded control (j), W=2: {wall:.1f} s with the start-up ({card})")

    t0 = time.perf_counter()
    entry.dryrun_multichip(2)
    metric["dryrun_s"] = time.perf_counter() - t0
    metric["serial_max_err"] = phase_serial_oracle(dev, card)
    metric["phase_s"] = time.perf_counter() - t_phase
    log(f"sharded control (j): phase {metric['phase_s']:.1f} s ({card})")
    return metric


def ctrl_graphed(mesh, mpc, lin, seed: int, card: str) -> dict:
    """(j) at W = 1 (NCCL, one rank): every sharded entry point whose
    factory graphs it (``step.graphed``; the ragged routes must say
    False) over ``SHARD_GRAPH_STEPS`` chained steps at 2^20 particles a
    rank (2^18 Gaussians), bit-equal to the same step under
    ``graphs.disabled``, its kernels counted at each replay (the kernel
    route's ``ends_merge_round`` by the card, inside its IF node), then
    ms a step both ways; and the control step of the ``kernel`` route,
    one replay an event, against the same step eager over
    ``CTRL_EVENTS`` events. Returns the times."""
    out = {}
    for name in SHARD_EAGER:
        _, fn, _ = shard_entry(mesh, name, seed)
        if fn.graphed:
            raise AssertionError(f"(j) {name}: graphed at W=1, but its "
                                 f"exchange reads the host")
    for name, kernels in SHARD_GRAPHED.items():
        state, fn, step = shard_entry(mesh, name, seed)
        if not fn.graphed:
            raise AssertionError(f"(j) {name}: not graphed at W=1 (NCCL)")
        zero_counts()
        a, b = chained_pair(f"W=1 {name}", step, state, SHARD_GRAPH_STEPS,
                            "(j)", fn)
        expect_counts(f"(j) W=1 {name}, graphed and eager", read_counts(),
                      {k: 2 * SHARD_GRAPH_STEPS for k in kernels})
        # every call a capture (a key's first: its warm-up) or a replay;
        # a key is also the inputs' strides, which the kernel route's
        # output (a view of its merge state) changes once
        if (fn.captures + fn.replays != SHARD_GRAPH_STEPS
                or fn.replays < SHARD_GRAPH_STEPS - 2):
            raise AssertionError(f"(j) {name}: {fn.captures} captures, "
                                 f"{fn.replays} replays")
        out[name] = timed_pair(f"W=1 {name}", step, a, b, card,
                               SHARD_STEPS, "(j)", fn)
    log(f"sharded control (j), W=1 NCCL: {len(SHARD_GRAPHED)} sharded "
        f"steps one graph replay a step, bit-equal to eager over "
        f"{SHARD_GRAPH_STEPS} chained steps; the kernel route's skips IF "
        f"nodes (ends_merge_round counted on the card); counter_draw "
        f"inside the graphs; {list(SHARD_EAGER)} eager by design ({card})")

    f, g = bio.homeostatic_des, bio.static_outputs
    if make_sharded_control_step(mesh, mpc, lin, f, g, dt=CTRL_DT,
                                 resample_impl="a2a").graphed:
        raise AssertionError("(j) the a2a control step is graphed")
    step = make_sharded_control_step(mesh, mpc, lin, f, g, dt=CTRL_DT,
                                     resample_impl="kernel")
    if not step.graphed:
        raise AssertionError("(j) the kernel control step is not graphed")

    def eager(*args):
        with graphs.disabled(step):
            return step(*args)

    zero_counts()
    recs = {"graphed": ctrl_events(mesh, step, ctrl_state("pf", N, mesh, seed),
                                   mpc),
            "eager": ctrl_events(mesh, eager, ctrl_state("pf", N, mesh, seed),
                                 mpc)}
    expect_counts("(j) W=1 control step, graphed and eager", read_counts(),
                  {"ends_merge_round": 2 * CTRL_EVENTS,
                   "counter_draw": 2 * CTRL_EVENTS,
                   "mixture_pdf": 2 * CTRL_EVENTS})
    ctrl_same("W=1 control step graphed vs eager", recs["graphed"],
              recs["eager"])
    for a, b in zip(recs["graphed"], recs["eager"]):
        if (a["status"], a["iterations"]) != (b["status"], b["iterations"]):
            raise AssertionError(f"(j) control step graphed vs eager: {a} "
                                 f"!= {b}")
    if (step.captures + step.replays != CTRL_EVENTS
            or step.replays < CTRL_EVENTS - 2):
        raise AssertionError(f"(j) control step: {step.captures} captures, "
                             f"{step.replays} replays")
    out["control kernel"] = {k: [r["ms"] for r in v] for k, v in recs.items()}
    log(f"sharded control (j), W=1 NCCL, control step (kernel) at n={N}, "
        f"one graph replay an event (filter step, estimate, solve with its "
        f"WHILE node, broadcast), bit-equal to eager: graphed "
        f"{ctrl_line(recs['graphed'])}; eager {ctrl_line(recs['eager'])} "
        f"({card})")
    return out


def phase_serial_oracle(dev, card: str) -> dict:
    """The card's flat ``predict_from_noise`` and ``update`` at
    ``rig.SERIAL_N`` particles, fed float32 noise drawn on the host,
    against the float64 serial engine built from the checkout (which
    raises if it cannot build), at ``tests/test_torch_native_serial.py``'s
    tolerance: the particles, and the weights normalized to mean 1."""
    particles, noise = rig.serial_case()
    n = len(particles)
    eng = native_serial.SerialParticleFilter(particles, *rig.SERIAL_MEAS)
    eng.predict(rig.SERIAL_U, rig.SERIAL_DT, noise)
    eng.update(rig.SERIAL_Z)
    meas = GaussianSum.create(*rig.SERIAL_MEAS, device=dev)
    u = torch.tensor(rig.SERIAL_U, dtype=torch.float32, device=dev)
    z = torch.tensor(rig.SERIAL_Z, dtype=torch.float32, device=dev)
    x = pf.predict_from_noise(torch.from_numpy(particles).to(dev), u,
                              torch.tensor(rig.SERIAL_DT, device=dev),
                              bio.homeostatic_des,
                              torch.from_numpy(noise).to(dev))
    w = pf.update(pf.PFState(x, torch.full((n,), 1.0 / n, device=dev), None),
                  u, z, bio.static_outputs, meas).weights
    x, w = x.cpu().numpy(), w.cpu().numpy()
    w, w_eng = w / w.mean(), eng.weights / eng.weights.mean()
    np.testing.assert_allclose(x, eng.particles, rtol=rig.SERIAL_RTOL,
                               atol=rig.SERIAL_ATOL)
    np.testing.assert_allclose(w, w_eng, rtol=rig.SERIAL_RTOL,
                               atol=rig.SERIAL_ATOL)
    err = {"particles": float(np.abs(x - eng.particles).max()),
           "weights": float(np.abs(w - w_eng).max())}
    log(f"sharded control (j), the serial engine (float64, g++ from "
        f"{os.path.relpath(native_serial.library_path())}) against the "
        f"card's flat predict and update at n={n}: max |diff| particles "
        f"{err['particles']:.3e}, weights (mean 1) {err['weights']:.3e}, "
        f"within rtol {rig.SERIAL_RTOL}, atol {rig.SERIAL_ATOL} ({card})")
    return err


# ----------------------------------------------------------------------
# (i) the experiments layer
# ----------------------------------------------------------------------
def exp_counts(path: str, n: int, calls: int, resamples: bool,
               updates: bool) -> None:
    """``compact`` and ``expand`` once a call of an op that resamples at
    a size the router sends to them (n >= 2^12 on the card), else none;
    ``mixture_pdf`` once a call of an op that updates."""
    k = calls if resamples and n >= 2**12 else 0
    expect_counts(path, read_counts(), {"compact": k, "expand": k,
                                        "mixture_pdf": calls * updates})


def exp_run_seqs(name: str, entries, log2s, gpu: bool, card: str) -> dict:
    """Each entry's run sequence at each size with the counts zeroed
    before it and read after it; every time finite and positive. Returns
    the medians in ms."""
    medians = {}
    for op, fn, resamples, updates in entries:
        for log2 in log2s:
            n = int(2.0 ** log2)
            zero_counts()
            with exp_fb.warm_calls() as warms:
                _, (seq,) = fn(np.array([n]), EXP_RUNS, gpu)
            # the warm-up calls (a graphed op's captures) and the runs
            exp_counts(f"(i) {name} {op}, n={n}, gpu={gpu}", n,
                       EXP_RUNS + sum(warms) if gpu else 0, resamples,
                       updates)
            if seq.shape != (EXP_RUNS,) or not (np.isfinite(seq).all()
                                                and (seq > 0).all()):
                raise AssertionError(f"(i) {name} {op} n={n}: {seq}")
            medians[f"{op}@2^{log2:g}"] = float(np.median(seq)) * 1e3
    leg = card if gpu else "CPU"
    log(f"experiments (i), {name} run sequences on {leg}, {EXP_RUNS} runs, "
        f"median ms: " + ", ".join(f"{k} {v:.4f}" for k, v in medians.items())
        + f" ({card})")
    return medians


def exp_summary(path: str, fn, n: int, events: int, card: str) -> dict:
    """One closed-loop summary at ``EXP_LOOP_END`` with ``mixture_pdf``,
    ``compact`` and ``expand`` launched ``events`` times."""
    zero_counts()
    s = fn(n, DT_CONTROL, DT_CONTROL, 0, end_time=EXP_LOOP_END)
    expect_counts(path, read_counts(), {"compact": events, "expand": events,
                                        "mixture_pdf": events})
    if not (np.isfinite(s["performance"]) and 0 <= s["mpc_frac"] <= 1
            and s["runtime"] >= 0):
        raise AssertionError(f"{path}: {s}")
    util = exp_pf_cl.utilization(s, DT_CONTROL)
    log(f"{path}, n={n}, end_time={EXP_LOOP_END}: ITSE "
        f"{s['performance']:.6g}, mpc_frac {s['mpc_frac']:.3f}, runtime "
        f"{s['runtime']:.3f} s, utilisation {util:.4f} ({card})")
    return {"itse": float(s["performance"]), "runtime_s": s["runtime"],
            "utilization": util, "mpc_frac": s["mpc_frac"]}


def phase_experiments(dev, card: str) -> dict:
    """(i) The experiments, through the entry points a campaign calls,
    with the jar under a temporary directory: the PF and GSF run
    sequences at the top of the reference's grids (2^23.5 and 2^18.5),
    the breakdown, the pacf series, energy per step, the closed-loop
    summaries and the MPC run sequence."""
    t_phase = time.perf_counter()
    old_root = os.environ.get(jar_cache.ROOT_ENV)
    with tempfile.TemporaryDirectory(prefix="smoke_jar_") as jar:
        os.environ[jar_cache.ROOT_ENV] = jar
        try:
            metric = experiments(dev, card)
        finally:
            if old_root is None:
                del os.environ[jar_cache.ROOT_ENV]
            else:
                os.environ[jar_cache.ROOT_ENV] = old_root
    metric.update(phase_s=time.perf_counter() - t_phase, card=card)
    log(f"experiments (i): phase {metric['phase_s']:.1f} s ({card})")
    return metric


def exp_graphed(card: str) -> dict:
    """(i) Each graphed op of the experiments against its eager form
    (``graphs.disabled``) from the same state and generator state:
    ``build``'s four at 2^20 particles (``pf``) and the GSF's predict,
    update and resample at 2^18 Gaussians, the breakdown's at 2^18, the
    sigma-point op at 2^18; ``EXP_GRAPH_STEPS`` chained calls bit-equal,
    then ms a call both ways; ``compact`` and ``expand`` once a call of
    every op that resamples, replays included. Each op's graphs are
    freed before the next's."""
    pf_state, pf_ops = exp_fb.build("pf", N, True)
    gsf_state, gsf_ops = exp_fb.build("gsf", N_BANK, True)
    bd_state, bd_ops = exp_fb.breakdown_ops(EXP_BREAKDOWN_N, True)
    groups = [(f"PF {k} n={N}", op, pf_state, k in ("resample", "step"),
               k in ("update", "step")) for k, op in pf_ops.items()]
    groups += [(f"GSF {k} N={N_BANK}", gsf_ops[k], gsf_state,
                k == "resample", k == "update")
               for k in ("predict", "update", "resample")]
    groups += [(f"GSF sigma_points N={N_BANK}", exp_gsf.sigma_points_op,
                gsf_state, False, False)]
    groups += [(f"breakdown {k} n={EXP_BREAKDOWN_N}", op, bd_state,
                k == "full_step", k == "full_step")
               for k, op in bd_ops.items()]
    out = {}
    for path, op, state, resamples, updates in groups:
        zero_counts()
        a, b = chained_pair(f"experiments {path}", op, state,
                            EXP_GRAPH_STEPS, "(i)")
        out[path] = timed_pair(f"experiments {path}", op, a, b, card,
                               EXP_GRAPH_TIMED, "(i)")
        calls = 2 * (EXP_GRAPH_STEPS + 2 * (EXP_GRAPH_TIMED + 1))
        expect_counts(f"(i) graphed {path}", read_counts(),
                      {"compact": calls * resamples,
                       "expand": calls * resamples,
                       "mixture_pdf": calls * updates})
        if op.replays < 2 * EXP_GRAPH_TIMED:
            raise AssertionError(f"(i) {path}: {op.replays} replays")
        exp_fb.release(op)
    log(f"experiments (i): {len(groups)} graphed ops bit-equal to eager "
        f"over {EXP_GRAPH_STEPS} chained calls ({card})")
    return out


def experiments(dev, card: str) -> dict:
    pf_entries = [("predict", exp_pf.predict_run_seq, False, False),
                  ("update", exp_pf.update_run_seq, False, True),
                  ("resample", exp_pf.resample_run_seq, True, False),
                  ("step", exp_pf.step_run_seq, True, True)]
    gsf_entries = [("predict", exp_gsf.predict_run_seq, False, False),
                   ("update", exp_gsf.update_run_seq, False, True),
                   ("resample", exp_gsf.resample_run_seq, True, False),
                   ("sigma_points", exp_gsf.sigma_points_run_seq, False,
                    False)]
    metric = {"metric": "experiments", "unit": "ms",
              "graphed_vs_eager": exp_graphed(card),
              "pf_run_seq_card": exp_run_seqs("PF", pf_entries, EXP_PF_LOG2,
                                              True, card),
              "pf_run_seq_cpu": exp_run_seqs("PF", pf_entries,
                                             EXP_PF_CPU_LOG2, False, card),
              "gsf_run_seq_card": exp_run_seqs("GSF", gsf_entries,
                                               EXP_GSF_LOG2, True, card)}
    zero_counts()
    _, (noop,) = exp_gsf.noop_run_seq(np.array([1]), EXP_RUNS, True)
    expect_counts("(i) noop", read_counts(), {})
    if not (noop >= 0).all():
        raise AssertionError(f"(i) noop: {noop}")

    # the chunked sequences' pacf against the series built to pass it
    _, (chunked,) = exp_pf.step_run_seq(np.array([N]), EXP_RUNS, True)
    zero_counts()
    with exp_fb.warm_calls() as warms:
        rows = exp_pf.breakdown_run_seqs(EXP_BREAKDOWN_N, EXP_RUNS, True)
    # the full step's, the last op timed
    calls = EXP_RUNS + warms[-1]
    expect_counts("(i) breakdown", read_counts(),
                  {"compact": calls, "expand": calls, "mixture_pdf": calls})
    metric["breakdown_ms"] = {k: float(np.median(v)) * 1e3
                              for k, v in rows.items()}
    zero_counts()
    series = exp_pacf.pacf_series(N, EXP_PACF_K, EXP_PACF_REPS, gpu=True)
    # the kernels launch K times at the warm-up on a side stream and K
    # times at each replay: each rep, and the warm-up rep, is one
    k = EXP_PACF_K * (EXP_PACF_REPS + 2)
    expect_counts("(i) pacf series", read_counts(),
                  {"compact": k, "expand": k})
    if series["replays"] != EXP_PACF_REPS + 1:
        raise AssertionError(f"(i) pacf series: {series['replays']} "
                             f"replays, not {EXP_PACF_REPS + 1}")
    for key in ("device_series_ms", "graph_series_ms"):
        if not (np.isfinite(series[key]).all() and min(series[key]) > 0):
            raise AssertionError(f"(i) pacf series: {key} {series[key]}")
    metric["pacf"] = {"chunked_step_2^20": max_abs_pacf(chunked, 10),
                      "series_2^20": series["max_abs_pacf"],
                      "series_median_rep_ms": series["median_rep_ms"],
                      "device_series_2^20": series["device_max_abs_pacf"],
                      "device_median_rep_ms":
                          series["device_median_rep_ms"],
                      "graph_series_2^20": series["graph_max_abs_pacf"],
                      "graph_median_rep_ms": series["graph_median_rep_ms"],
                      "host_series_ms": series["series_ms"],
                      "device_series_ms": series["device_series_ms"],
                      "graph_series_ms": series["graph_series_ms"]}
    log(f"experiments (i), breakdown at n={EXP_BREAKDOWN_N}, median ms: "
        + ", ".join(f"{k} {v:.4f}" for k, v in metric["breakdown_ms"].items())
        + f"; max |pacf|: chunked step sequence at 2^20 "
        f"{metric['pacf']['chunked_step_2^20']:.3f}, pacf series (K = "
        f"{EXP_PACF_K}, {EXP_PACF_REPS} reps, one CUDA graph replay a rep) "
        f"host ms "
        f"{series['max_abs_pacf']:.3f}, device ms "
        f"{series['device_max_abs_pacf']:.3f}, graph alone "
        f"{series['graph_max_abs_pacf']:.3f} (gate 0.2; printed, not "
        f"failed on), median {series['median_rep_ms']:.3f} ms host, "
        f"{series['device_median_rep_ms']:.3f} ms device, "
        f"{series['graph_median_rep_ms']:.3f} ms graph a rep ({card})")
    log("experiments (i), pacf series host ms: "
        + " ".join(f"{t:.3f}" for t in series["series_ms"]))
    log("experiments (i), pacf series device ms: "
        + " ".join(f"{t:.3f}" for t in series["device_series_ms"]))
    log("experiments (i), pacf series graph ms: "
        + " ".join(f"{t:.3f}" for t in series["graph_series_ms"]))

    zero_counts()
    with exp_fb.warm_calls() as warms:
        _, ((steps, (e_cpu, e_card)),) = exp_power.step_energy(
            np.array([N]), EXP_POWER_T_RUN, True)
    calls = steps + sum(warms)
    expect_counts("(i) energy", read_counts(),
                  {"compact": calls, "expand": calls, "mixture_pdf": calls})
    (_, cpu_j, card_j), = exp_power.per_step([N], [(steps, (e_cpu, e_card))])
    samples = exp_power.step_energy.raw.last_samples
    span = float(samples[0, -1] - samples[0, 0])
    limit = power_limit_w(card)
    if not (np.isfinite(e_card) and e_card > 0
            and e_card / span <= 1.05 * limit):
        raise AssertionError(f"(i) energy: card {e_card} J over {span:.2f} s "
                             f"against a limit of {limit} W")
    metric["energy_2^20"] = {"card_j_per_step": card_j,
                             "cpu_j_per_step": cpu_j if np.isfinite(cpu_j)
                             else None, "card_mean_w": e_card / span,
                             "steps": steps}
    log(f"experiments (i), energy at n={N}: {steps} steps in {span:.2f} s, "
        f"card {card_j:.4f} J/step (mean {e_card / span:.1f} W of the "
        f"{limit:.0f} W limit), CPU {cpu_j:.4f} J/step (NaN where the host's "
        f"counters do not advance) ({card})")

    ts = np.linspace(0, EXP_LOOP_END, int(EXP_LOOP_END * 10))
    events = int(sim_loop.event_masks(ts, DT_CONTROL, DT_CONTROL)[1].sum())
    metric["closed_loop"] = {
        "pf_host_2^20": exp_summary("(i) PF get_sim_summary",
                                    exp_pf_cl.get_sim_summary, N, events,
                                    card),
        "pf_device_2^20": exp_summary("(i) PF get_sim_summary_device",
                                      exp_pf_cl.get_sim_summary_device, N,
                                      2 * events, card),
        "gsf_host_2^14": exp_summary("(i) GSF get_sim_summary",
                                     exp_gsf_cl.get_sim_summary,
                                     EXP_GSF_LOOP_N, events, card),
        "gsf_device_2^14": exp_summary("(i) GSF get_sim_summary_device",
                                       exp_gsf_cl.get_sim_summary_device,
                                       EXP_GSF_LOOP_N, 2 * events, card)}

    zero_counts()
    times = exp_mpc.mpc_run_seq(n_runs=EXP_MPC_RUNS)
    solve_ms, iters = exp_mpc.device_solve_ms()
    eager_solve_ms, _ = exp_mpc.device_solve_ms(graphed=False)
    itse = exp_pvcp.get_simulation_performance(30.0, 0)
    expect_counts("(i) MPC", read_counts(), {})
    if not (times.shape == (EXP_MPC_RUNS,) and (times > 0).all()
            and np.isfinite(solve_ms) and np.isfinite(itse)):
        raise AssertionError(f"(i) MPC: {times}, {solve_ms}, {itse}")
    metric["mpc"] = {"k_step_median_ms": float(np.median(times[1:])) * 1e3,
                     "device_solve_ms": solve_ms,
                     "eager_chain_solve_ms": eager_solve_ms,
                     "cold_start_iterations": iters,
                     "itse_dt_control_30": float(itse)}
    log(f"experiments (i), MPC at dt_control={DT_CONTROL}: K.step median "
        f"{metric['mpc']['k_step_median_ms']:.3f} ms over {EXP_MPC_RUNS - 1}"
        f" warm solves, device solve {solve_ms:.3f} ms (slope of chained "
        f"solves, each chain one graph replay; {eager_solve_ms:.3f} ms as a "
        f"Python loop of the solves' replays), cold start {iters:.0f} "
        f"iterations; ITSE at dt_control=30"
        f" {itse:.6g} ({card})")
    return metric


def main() -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    card, dev = phase_card()
    phase_build()
    errs = phase_kernels_vs_plain(dev, args.seed)
    (errs["counter_draw"], draw_times, draw_bound,
     draw_library_ms) = phase_counter_draw(dev, card)
    (errs["mixture_pdf"], pdf_times, pdf_bound,
     pdf_library_ms) = phase_mixture_pdf(dev, card)
    with watchdog(WATCHDOG_S, "the edge cases and repeats of compact and "
                              "expand"):
        phase_edge_cases(dev, args.seed)
        phase_compact_repeats(dev, args.seed, card)
    errs.update(phase_merge_kernels_vs_plain(dev, args.seed))
    with watchdog(WATCHDOG_S, "the edge cases and ring feeds of the merge "
                              "and coarse kernels"):
        edge_errs = phase_merge_edge_cases(dev, args.seed)
    for name, err in edge_errs.items():
        errs[name] = max(errs[name], err)
    phase_fixture(dev)
    phase_fixture_gsukf(dev)
    main_errs, times, metric, bounds = phase_main_path(dev, args.seed, card)
    state, r = phase_flat_pf(dev, args.seed, card)
    phase_router_routes(dev, args.seed)
    merge_errs, merge_times, merge_bounds = phase_merge_times(
        dev, card, state, r, args.seed)
    phase_profile(dev, args.seed, card)
    v2_err, v2_times = phase_v2_path(dev, args.seed, card)
    errs["expand"] = max(errs["expand"], v2_err)
    gsukf_metric = phase_gsukf(dev, args.seed, card)
    graph_metric = phase_graphs(dev, args.seed, card)
    graph_metric["v2_2^20"] = v2_times
    cond_ms, cond_plain_ms, cond_bound, cond_metric = phase_graph_cond(
        dev, card)
    graph_metric["graph_cond"] = cond_metric
    sim_b, K_cpu, setup_s = control_setup(dev, args.seed, card)
    mpc_metric = phase_mpc(sim_b, K_cpu, card)
    mpc_metric["host_setup_s"] = setup_s
    pf_metric, state0, x0 = phase_closed_loop(sim_b, card)
    loop_metric = {
        "metric": "closed_loop_ms_per_control_event_pf_2^20_P3000",
        "pf": pf_metric,
        "scan": phase_scan_loop(dev, sim_b, state0, x0, card, args.seed),
        "gsukf_2^18": phase_gsukf_loop(dev, card, args.seed),
        "card": card,
    }
    phase_first_qp(dev, card)
    scenario_metric, scen = phase_scenario(dev, card)
    instr_metric = phase_instrumentation(dev, args.seed, card)
    multi_metric = phase_multi_device(dev, args.seed, card, scen)
    control_metric = phase_control(dev, args.seed, card, sim_b, K_cpu)
    exp_metric = phase_experiments(dev, card)
    times.update(merge_times, counter_draw=draw_times, mixture_pdf=pdf_times)
    bounds.update(merge_bounds, counter_draw=draw_bound,
                  mixture_pdf=pdf_bound)
    # no single PyTorch call computes any of the resample kernels'
    # functions (each is a sorted search, a compaction or a merge, and a
    # gather): their library_ms stays null
    library = {"counter_draw": draw_library_ms,
               "mixture_pdf": pdf_library_ms}
    for name in KERNELS:
        if times[name][0] < bounds[name][0]:
            raise AssertionError(f"{name}: {times[name][0]:.4f} ms is under "
                                 f"its bound {bounds[name][0]:.4f} ms")
    kernels = [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": TALLY[name],
        "max_abs_err": max(errs[name], main_errs.get(name, 0.0),
                           merge_errs.get(name, 0.0)),
        "ms": times[name][0], "plain_ms": times[name][1],
        "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
        "library_ms": library.get(name),
    } for name, (source, replaces, _) in KERNELS.items()]
    # graph_cond: a WHILE iteration; its plain version the host-driven
    # loop's iteration; every device-loop solve and record bit-equal to
    # the host-driven loop's (else the run failed); no PyTorch call runs
    # a loop on the card
    if cond_ms < cond_bound[0]:
        raise AssertionError("graph_cond: under its bound")
    kernels.append({
        "name": "graph_cond", "route": "cuda", "source": COND_SOURCE,
        "replaces": COND_REPLACES, "launches": sum(TALLY_COND),
        "max_abs_err": 0.0, "ms": cond_ms, "plain_ms": cond_plain_ms,
        "bound_ms": cond_bound[0], "bound_by": cond_bound[1],
        "library_ms": None})
    if not all(TALLY_COND):
        raise AssertionError(f"graph_cond: a QP path ran no WHILE "
                             f"iteration ({TALLY_COND})")
    log(f"chip_smoke.py: {time.perf_counter() - t_start:.1f} s in all, "
        f"the build included ({card})")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps(metric))
    print(json.dumps(gsukf_metric))
    print(json.dumps(graph_metric))
    print(json.dumps(mpc_metric))
    print(json.dumps(loop_metric))
    print(json.dumps(scenario_metric))
    print(json.dumps(instr_metric))
    print(json.dumps(multi_metric))
    print(json.dumps(control_metric))
    print(json.dumps(exp_metric))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
