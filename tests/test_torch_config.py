"""The port's configuration layer against the reference's: the same
defaults and horizons, and the rig it builds on the CPU."""
import dataclasses

import numpy as np
import pytest
import torch

from gpu_se_tpu import config as ref_config
from gpu_se_tpu_torch import config


@pytest.mark.parametrize("cls", ["FilterConfig", "MPCConfig", "MeshConfig"])
def test_defaults_equal_the_reference(cls):
    ours, ref = getattr(config, cls)(), getattr(ref_config, cls)()
    for f in dataclasses.fields(ref):
        if f.name == "dtype":
            assert ours.dtype == torch.float32
        else:
            assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    assert [f.name for f in dataclasses.fields(ours)] == [
        f.name for f in dataclasses.fields(ref)]


def test_sim_config_defaults():
    cfg = config.SimConfig()
    ref = ref_config.SimConfig()
    assert (cfg.end_time, cfg.dt_predict) == (ref.end_time, ref.dt_predict)
    assert cfg.mpc.P == 300 and cfg.mpc.M == 200
    assert cfg.filter.n_particles == 2**15


@pytest.mark.parametrize("dt_control, P, M", [(1, 300, 200), (2, 150, 100),
                                              (30, 10, 6), (0.1, 2999, 1999)])
def test_horizons_follow_dt_control(dt_control, P, M):
    """``int(300 // dt)``: at 0.1 the float floor division gives 2999."""
    ours = config.MPCConfig(dt_control=dt_control)
    ref = ref_config.MPCConfig(dt_control=dt_control)
    assert (ours.P, ours.M) == (ref.P, ref.M) == (P, M)


def test_build_rig_on_the_cpu():
    cfg = config.SimConfig(
        filter=config.FilterConfig(n_particles=64),
        mpc=config.MPCConfig(dt_control=2),
    )
    bioreactor, lin_model, K, est = config.build_rig(cfg, device="cpu")
    assert K.P == 150 and K.M == 100
    assert est.N_particles == 64
    assert np.isfinite(bioreactor.X).all()
    assert K.qp.device == torch.device("cpu")
    assert est.particles.device == torch.device("cpu")
