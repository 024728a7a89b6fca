"""PF run sequences: predict / update / resample / step times against the
particle count, CPU against the card, with the pacf validity gate, the
speed-up plot and the per-stage breakdown.

Counterpart of the reference's ``results/pf_openloop/pf_run_seq.py``:
"CPU" is the port on ``device="cpu"``, the card leg the same code on the
CUDA card, labelled with the card's name.
"""
import numpy as np

from gpu_se_tpu_torch.results._common import card_label, pyplot, save_fig
from gpu_se_tpu_torch.results._filter_bench import breakdown_pf, run_seq
from gpu_se_tpu_torch.utils import PickleJar, RunSequences, max_abs_pacf

# the reference's grids: the CPU leg in whole log2 steps, the card's
# 2^1..2^23.5 in halves (a half step gives an odd n: 2^23.5 -> 11863283)
CPU_LOG2 = np.arange(1, 20, 1.0)
ACC_LOG2 = np.arange(1, 24, 0.5)
OPS = ("predict", "update", "resample")


@RunSequences.vectorize
@PickleJar.pickle(path="pf/raw")
def predict_run_seq(N, runs, gpu):
    return run_seq("pf", "predict", N, runs, gpu)


@RunSequences.vectorize
@PickleJar.pickle(path="pf/raw")
def update_run_seq(N, runs, gpu):
    return run_seq("pf", "update", N, runs, gpu)


@RunSequences.vectorize
@PickleJar.pickle(path="pf/raw")
def resample_run_seq(N, runs, gpu):
    return run_seq("pf", "resample", N, runs, gpu)


@RunSequences.vectorize
@PickleJar.pickle(path="pf/raw")
def step_run_seq(N, runs, gpu):
    return run_seq("pf", "step", N, runs, gpu)


@PickleJar.pickle(path="pf/breakdown")
def breakdown_run_seqs(n, runs, gpu):
    """:func:`breakdown_pf`, memoized for the breakdown figure."""
    return breakdown_pf(n, runs, gpu)


def grid(log2s) -> np.ndarray:
    return (2.0 ** np.asarray(log2s)).astype(int)


def cpu_gpu_run_seqs(runs=50, cpu_log2=CPU_LOG2, acc_log2=ACC_LOG2):
    """``[cpu, card]``, each the ``(ns, seqs)`` of predict, update and
    resample. The card's leg is read first: where its memos are missing
    and there is no card, this raises before any CPU work."""
    return run_seq_grids((predict_run_seq, update_run_seq, resample_run_seq),
                         runs, cpu_log2, acc_log2)


def run_seq_grids(entries, runs, cpu_log2, acc_log2):
    """``[cpu, card]``: each entry's ``(ns, seqs)`` over the leg's grid,
    the card's computed (or read) first."""
    card = [fn(grid(acc_log2), runs, True) for fn in entries]
    cpu = [fn(grid(cpu_log2), runs, False) for fn in entries]
    return [cpu, card]


def pacf_gate(runs=50, acc_log2=ACC_LOG2):
    """``(op, n, max |pacf|)`` of the card's predict sequences; the
    reference's validity threshold is 0.2."""
    ns, seqs = predict_run_seq(grid(acc_log2), runs, True)
    return [("predict", int(n), max_abs_pacf(seq)) for n, seq in zip(ns, seqs)]


def plot(runs=50):
    plt = pyplot()
    card = card_label()
    (cpu_seqs, acc_seqs) = cpu_gpu_run_seqs(runs)
    fig, axes = plt.subplots(1, 3, sharey="row", figsize=(18, 5))
    for ax, name, cpu_rs, acc_rs in zip(axes, OPS, cpu_seqs, acc_seqs):
        for label, (ns, seqs) in (("CPU", cpu_rs), (card, acc_rs)):
            med = np.median(seqs, axis=1)
            lo = np.quantile(seqs, 0.1, axis=1)
            hi = np.quantile(seqs, 0.9, axis=1)
            ax.loglog(ns, med, ".-", label=label)
            ax.fill_between(ns, lo, hi, alpha=0.2)
        ax.set_title(name)
        ax.set_xlabel("N particles")
        ax.legend()
    axes[0].set_ylabel("time per call (s)")
    save_fig("pf_run_seq.png")

    plt.figure(figsize=(6.25, 5))
    for name, cpu_rs, acc_rs in zip(OPS, cpu_seqs, acc_seqs):
        ns_c, seq_c = cpu_rs
        ns_a, seq_a = acc_rs
        common, ic, ia = np.intersect1d(ns_c, ns_a, return_indices=True)
        plt.loglog(
            common,
            np.median(seq_c, axis=1)[ic] / np.median(seq_a, axis=1)[ia],
            ".-",
            label=name,
        )
    plt.axhline(1.0, color="red", alpha=0.5)
    plt.xlabel("N particles")
    plt.ylabel(f"CPU time / {card} time")
    plt.legend()
    return save_fig("pf_speedup.png")


def plot_breakdown(n=2**18, runs=30):
    """Stacked per-stage medians on the card and on the CPU."""
    plt = pyplot()
    rows = {}
    for gpu, label in ((True, card_label()), (False, "CPU")):
        rows[label] = {k: float(np.median(v))
                       for k, v in breakdown_run_seqs(n, runs, gpu).items()}
        print(label, rows[label])
    stages = ["dynamics", "noise", "indices", "gather"]
    fig, ax = plt.subplots(figsize=(6.25, 5))
    for i, label in enumerate(rows):
        bottom = 0.0
        for st in stages:
            ax.bar(i, rows[label][st], bottom=bottom, label=st if i == 0 else None)
            bottom += rows[label][st]
    ax.set_xticks(range(len(rows)), list(rows))
    ax.set_ylabel(f"median time per stage (s), N = {n}")
    ax.legend()
    return save_fig("pf_breakdown.png")


if __name__ == "__main__":
    plot()
