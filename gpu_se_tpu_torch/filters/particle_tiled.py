"""Fused particle-filter step: predict + update + systematic resample.

Counterpart of ``gpu_se_tpu/filters/particle_tiled.py``. The reference
keeps its state in the TPU kernel's ``(T, 1024)`` lane-tiled layout; the
port keeps it as structure-of-arrays ``(nx, n)`` float32, the layout the
CUDA resample kernels read and write, so the kernel output is the next
step's state and no step transposes anything. :func:`tile_to_jax` and
:func:`untile_from_jax` convert to and from the reference's layout for
the tests.

Semantics follow the reference step: ``f(x, u, dt)`` and ``g(x, u)``
take stacked ``(nx, ...)`` states (``models/bioreactor.py``), the noise
is :meth:`GaussianSum.draw_t`'s and the weights :meth:`GaussianSum.pdf_t`'s.
The incoming weights are uniform (every step resamples), so the step
carries no weight vector and skips multiplying by them: for a
power-of-two ``n`` that multiply is an exact scale of the cumsum and
cannot move a segment boundary.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from gpu_se_tpu_torch import graphs
from gpu_se_tpu_torch.distributions.gaussian_sum import GaussianSum
from gpu_se_tpu_torch.ops.resample_coarse import ends_from_weights
from gpu_se_tpu_torch.ops.resample_pallas4 import resample_core

LANES = 128          # the reference's tile width and point-estimate block
TILE_ROWS = 8        # lane groups per reference tile row


@dataclass
class TiledPFState:
    """Particle-filter state.

    Attributes
    ----------
    x : (nx, n) float32 tensor
        The particles, one row per state dimension.
    generator : torch.Generator
        The stream :func:`step` draws from, on ``x``'s device. ``step``
        advances it in place.
    """

    x: torch.Tensor
    generator: torch.Generator

    @property
    def n_particles(self) -> int:
        return self.x.shape[1]


def init(generator: torch.Generator, n_particles: int,
         x0: GaussianSum) -> TiledPFState:
    """``n_particles`` draws from ``x0`` on the generator's device."""
    return TiledPFState(x=x0.draw_t(generator, n_particles),
                        generator=generator)


def dims(state: TiledPFState) -> torch.Tensor:
    """The ``(nx, n)`` particle dims."""
    return state.x


def predict_update_local(x, u, z, dt, f: Callable, g: Callable,
                         meas_pdf: GaussianSum, noise: torch.Tensor):
    """Predict with the given ``noise (nx, n)`` and weight by the
    measurement ``z``; returns ``(xn (nx, n), w (n,))``."""
    xn = x + f(x, u, dt) + noise
    ys = g(xn, u)
    resid = z.reshape(-1, 1).to(xn.dtype) - ys
    return xn, meas_pdf.pdf_t(resid)


def step_from_noise(x, u, z, dt, f: Callable, g: Callable,
                    meas_pdf: GaussianSum, noise: torch.Tensor,
                    r) -> torch.Tensor:
    """The deterministic step: predict + update with ``noise``, then the
    systematic resample at the uniform ``r``. Returns the new ``(nx, n)``
    particles."""
    xn, w = predict_update_local(x, u, z, dt, f, g, meas_pdf, noise)
    out, _ = resample_core(xn, ends_from_weights(w, r))
    return out


def step(state: TiledPFState, u, z, dt, f: Callable, g: Callable,
         state_pdf: GaussianSum, meas_pdf: GaussianSum) -> TiledPFState:
    """One filter step; the noise, then ``r``, come from the state's
    generator."""
    x = state.x
    noise = state_pdf.draw_t(state.generator, state.n_particles)
    r = torch.rand((), generator=state.generator, dtype=x.dtype,
                   device=x.device)
    x = step_from_noise(x, u, z, dt, f, g, meas_pdf, noise, r)
    return TiledPFState(x=x, generator=state.generator)


def graphed_step() -> graphs.Graphed:
    """:func:`step` as a CUDA graph on the card, replayed a call: the
    counterpart of the reference's ``jax.jit(particle_tiled.step)``
    (``bench.py``, ``entry()``). Call it as :func:`step`; the next
    state's particles are the caller's own."""
    return graphs.Graphed(step)


def graphed_step_from_noise() -> graphs.Graphed:
    """:func:`step_from_noise` as a CUDA graph, for a caller that feeds
    the noise and ``r``."""
    return graphs.Graphed(step_from_noise)


def point_estimate(state: TiledPFState) -> torch.Tensor:
    """Uniform-weight particle mean per dim: float32 sums over blocks of
    128 particles, then over the blocks (zero-padded to a whole block)."""
    x = state.x
    nx, n = x.shape
    pad = (-n) % LANES
    if pad:
        x = torch.cat([x, x.new_zeros((nx, pad))], dim=1)
    per_block = torch.sum(x.reshape(nx, -1, LANES), dim=2)
    return torch.sum(per_block, dim=1) / n


# ----------------------------------------------------------------------
# the reference's (t_data, 1024) layout, for the tests
# ----------------------------------------------------------------------
def tile_to_jax(x: torch.Tensor) -> np.ndarray:
    """``(nx, n)`` particles to the reference's ``(n / 128, 1024)`` tiled
    array: lane group ``d`` of tile row ``c`` is particles
    ``128 c .. 128 c + 127`` of dim ``d``; groups ``nx..7`` are zero."""
    nx, n = x.shape
    if n % LANES or nx > TILE_ROWS:
        raise ValueError(f"cannot tile {tuple(x.shape)}")
    p8 = np.zeros((TILE_ROWS, n), np.float32)
    p8[:nx] = x.detach().cpu().numpy()
    t_data = n // LANES
    return (p8.reshape(TILE_ROWS, t_data, LANES)
            .transpose(1, 0, 2).reshape(t_data, TILE_ROWS * LANES))


def untile_from_jax(tiled: np.ndarray, nx: int) -> torch.Tensor:
    """The reference's ``(t_data, 1024)`` tiled array to ``(nx, n)``
    particles (on the CPU)."""
    t_data = tiled.shape[0]
    back = (np.asarray(tiled, np.float32)
            .reshape(t_data, TILE_ROWS, LANES)
            .transpose(1, 0, 2).reshape(TILE_ROWS, t_data * LANES))
    return torch.from_numpy(np.ascontiguousarray(back[:nx]))
