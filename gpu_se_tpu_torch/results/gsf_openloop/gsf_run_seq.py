"""GSF run sequences, the sigma-point benchmark and the timer-overhead
control experiment.

Counterpart of the reference's ``results/gsf_openloop/gsf_run_seq.py``,
on the port's ``filters/gs_ukf``; "CPU" is ``device="cpu"``, the card
leg the CUDA card.
"""
import dataclasses
import time

import numpy as np

from gpu_se_tpu_torch.filters import gs_ukf
from gpu_se_tpu_torch.results._common import card_label, pyplot, save_fig
from gpu_se_tpu_torch.results._filter_bench import (
    build,
    graphed,
    release,
    run_seq,
    time_op,
)
from gpu_se_tpu_torch.results.pf_openloop.pf_run_seq import OPS, run_seq_grids
from gpu_se_tpu_torch.utils import PickleJar, RunSequences

CPU_LOG2 = np.arange(0, 15, 1.0)
# the reference's card grid: 2^0..2^18.5 in halves
ACC_LOG2 = np.arange(0, 19, 0.5)


@RunSequences.vectorize
@PickleJar.pickle(path="gsf/raw")
def predict_run_seq(N, runs, gpu):
    return run_seq("gsf", "predict", N, runs, gpu)


@RunSequences.vectorize
@PickleJar.pickle(path="gsf/raw")
def update_run_seq(N, runs, gpu):
    return run_seq("gsf", "update", N, runs, gpu)


@RunSequences.vectorize
@PickleJar.pickle(path="gsf/raw")
def resample_run_seq(N, runs, gpu):
    return run_seq("gsf", "resample", N, runs, gpu)


@graphed
def sigma_points_op(s):
    """Sigma-point generation alone (batched Cholesky and spread), a
    graphed op as ``build``'s are, as the reference jits it: chained
    through the state (the first sigma point is the mean), so that each
    call takes the last one's output."""
    return dataclasses.replace(s, means=gs_ukf.get_sigma_points(s)[:, 0, :])


@RunSequences.vectorize
@PickleJar.pickle(path="gsf/raw")
def sigma_points_run_seq(N, runs, gpu):
    """Sigma-point generation alone (:data:`sigma_points_op`)."""
    state, _ = build("gsf", N, gpu)
    try:
        return time_op(sigma_points_op, state, runs)
    finally:
        release(sigma_points_op)


@RunSequences.vectorize
@PickleJar.pickle(path="gsf/noop")
def noop_run_seq(N, runs, gpu):
    """Timer-overhead control: time an empty region."""
    del N, gpu
    out = np.empty(runs)
    for i in range(runs):
        t0 = time.perf_counter()
        out[i] = time.perf_counter() - t0
    return out


def cpu_gpu_run_seqs(runs=50, cpu_log2=CPU_LOG2, acc_log2=ACC_LOG2):
    """``[cpu, card]``, each the ``(ns, seqs)`` of predict, update and
    resample, the card's read first."""
    return run_seq_grids((predict_run_seq, update_run_seq, resample_run_seq),
                         runs, cpu_log2, acc_log2)


def plot(runs=50):
    plt = pyplot()
    card = card_label()
    (cpu_seqs, acc_seqs) = cpu_gpu_run_seqs(runs)
    fig, axes = plt.subplots(1, 3, sharey="row", figsize=(18, 5))
    for ax, name, cpu_rs, acc_rs in zip(axes, OPS, cpu_seqs, acc_seqs):
        for label, (ns, seqs) in (("CPU", cpu_rs), (card, acc_rs)):
            med = np.median(seqs, axis=1)
            ax.loglog(ns, med, ".-", label=label)
            ax.fill_between(
                ns, np.quantile(seqs, 0.1, axis=1), np.quantile(seqs, 0.9, axis=1),
                alpha=0.2,
            )
        ax.set_title(name)
        ax.set_xlabel("N Gaussians")
        ax.legend()
    axes[0].set_ylabel("time per call (s)")
    save_fig("gsf_run_seq.png")

    plt.figure(figsize=(6.25, 5))
    for name, cpu_rs, acc_rs in zip(OPS, cpu_seqs, acc_seqs):
        ns_c, seq_c = cpu_rs
        ns_a, seq_a = acc_rs
        common, ic, ia = np.intersect1d(ns_c, ns_a, return_indices=True)
        plt.loglog(
            common,
            np.median(seq_c, axis=1)[ic] / np.median(seq_a, axis=1)[ia],
            ".-", label=name,
        )
    plt.axhline(1.0, color="red", alpha=0.5)
    plt.xlabel("N Gaussians")
    plt.ylabel(f"CPU / {card}")
    plt.legend()
    return save_fig("gsf_speedup.png")


if __name__ == "__main__":
    plot()
