"""RunSequences: vectorize a benchmark over particle counts.

Counterpart of ``gpu_se_tpu/utils/run_sequences.py`` (numpy only, the
same code): turns ``f(N, ...)`` into ``f(N_array, ...) -> (N_array,
stacked_results)``.
"""
from __future__ import annotations

import numpy as np


class RunSequences:
    def __init__(self, func):
        self.func = func
        # the function under the memo wrappers (a PickleJar's too)
        self.raw = getattr(func, "raw", func)
        self.__name__ = getattr(func, "__name__", "run_seq")

    def __call__(self, N_particles, *args, **kwargs):
        results = [self.func(int(n), *args, **kwargs) for n in N_particles]
        try:
            run_seqs = np.array(results)
        except ValueError:
            # inhomogeneous results (e.g. PowerMeasurement's (count,
            # energy) tuples) — keep them as a list, same reference
            # contract of "stacked results per N"
            run_seqs = results
        return np.asarray(N_particles), run_seqs

    @staticmethod
    def vectorize(function):
        return RunSequences(function)
