"""Configuration layer: explicit dataclasses for building the rig.

Counterpart of ``gpu_se_tpu/config.py``. The dataclasses name every knob
(particle counts, horizons, tolerances, the device mesh, dtype) so that
an experiment is reproducible from one object; ``build_rig`` builds the
canonical rig from one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass
class FilterConfig:
    kind: str = "pf"  # "pf" | "gsf"
    n_particles: int = 2**15
    seed: int = 0
    dtype: torch.dtype = torch.float32


@dataclasses.dataclass
class MPCConfig:
    dt_control: float = 1.0
    horizon_minutes: float = 300.0  # P = horizon // dt_control
    control_minutes: float = 200.0  # M = max(control // dt_control, 1)
    q_diag: Tuple[float, float] = (0.1, 1.0)
    r_diag: Tuple[float, float] = (1.0, 1.0)
    ysp: Tuple[float, float] = (280.0, 850.0)
    eps_abs: float = 1e-6
    eps_rel: float = 1e-6
    max_iter: int = 10000

    @property
    def P(self) -> int:
        return int(self.horizon_minutes // self.dt_control)

    @property
    def M(self) -> int:
        return max(int(self.control_minutes // self.dt_control), 1)


@dataclasses.dataclass
class MeshConfig:
    n_devices: Optional[int] = None  # None = all
    axis_name: str = "particles"


@dataclasses.dataclass
class SimConfig:
    end_time: float = 50.0
    dt_predict: float = 0.1
    filter: FilterConfig = dataclasses.field(default_factory=FilterConfig)
    mpc: MPCConfig = dataclasses.field(default_factory=MPCConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)


def build_rig(cfg: SimConfig, device="cuda"):
    """Construct ``(bioreactor, lin_model, mpc, filter)`` from a config,
    its tensors on ``device`` (the card unless the caller passes
    ``device="cpu"``)."""
    from gpu_se_tpu_torch import sim

    return sim.get_parts(
        dt_control=cfg.mpc.dt_control,
        N_particles=cfg.filter.n_particles,
        pf=(cfg.filter.kind == "pf"),
        seed=cfg.filter.seed,
        device=device,
    )
