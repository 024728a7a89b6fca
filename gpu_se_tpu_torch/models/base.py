"""Nonlinear process-model interface.

Counterpart of ``gpu_se_tpu/models/base.py``: the stateful host shell
(``DEs``/``step``/``outputs`` on numpy) and the pure hooks ``des(x, u)``
and ``out(x, u)`` on torch tensors, which the linearizer differentiates
with ``torch.func.jacfwd``.
"""
from __future__ import annotations

import abc

import numpy as np


class NonlinearModel(abc.ABC):
    """Stateful shell for host-side plant simulation.

    Attributes
    ----------
    X : numpy.ndarray
        Current state (mutated by :meth:`step`).
    t : float
        Current time.
    """

    X: np.ndarray
    t: float

    @abc.abstractmethod
    def DEs(self, inputs):
        """Time derivatives of the state at the current state and inputs."""

    def step(self, dt, inputs):
        """Explicit-Euler update of the internal state."""
        self.t += dt
        dX = self.DEs(inputs)
        self.X = self.X + np.asarray(dX) * dt
        return self.outputs(inputs)

    @abc.abstractmethod
    def outputs(self, inputs):
        """Model outputs at the current state."""

    # ------------------------------------------------------------------
    # Pure hooks: side-effect-free functions of torch tensors (x, u).
    # ------------------------------------------------------------------
    def des(self, x, u):
        """Pure state-derivative function dx/dt = des(x, u)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not expose a pure `des(x, u)`; "
            "the linearizer will fall back to finite differences."
        )

    def out(self, x, u):
        """Pure output function y = out(x, u)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not expose a pure `out(x, u)`."
        )
