"""Two processes through ``initialize_distributed`` with a TCP
coordinator; mirrors ``tests/test_multihost.py``.

``gpu_se_tpu_torch.parallel.launch.run_group`` spawns the two ranks,
each of which starts the default group at ``127.0.0.1:<free port>``
over gloo and runs one ``make_shard_map_step`` on its half of 1024
particles around the steady state (``tests/_torch_parallel_workers.
multihost_step``). Both ranks see the same point estimate, and the
step equals the single-process step on the same seed bit for bit (the
shards hold whole 128-slot segments, so the ``ends`` do not depend on
the width).
"""
import numpy as np
import pytest

from gpu_se_tpu.sim import harness
from gpu_se_tpu_torch.parallel import (
    global_mesh,
    initialize_distributed,
    make_mesh,
)
from gpu_se_tpu_torch.parallel.launch import run_group

from tests import _torch_parallel_workers as workers

N = 1024
FIELDS = ("means", "covariances", "weights", "chol", "inv_cov", "log_const")
X_SS = np.array([280 / 180, 640 / 24.6, 1000 / 116, 0.0, 0.0])


def _inputs():
    state_pdf, meas_pdf = harness.get_noise()
    rng = np.random.default_rng(0)
    parts = (X_SS[None, :] + rng.normal(scale=1e-2, size=(N, 5))).astype(
        np.float32)
    u = np.array([0.06, 0.2], np.float32)
    return dict(
        parts=parts, weights=np.full(N, 1.0 / N, np.float32), seed=7, u=u,
        z=np.array([0.3, 2.0], np.float32), dt=np.float32(0.1),
        **{k: tuple(np.asarray(getattr(gs.dist, f)) for f in FIELDS)
           for k, gs in (("state_pdf", state_pdf), ("meas", meas_pdf))})


def test_two_process_distributed_pf_step():
    d = _inputs()
    outs = run_group(workers.multihost_step, 2, d, timeout_s=180)
    assert [(o[2], o[3]) for o in outs] == [(2, 0), (2, 1)]
    # both processes see the same estimate of the whole population
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    # and the same step as one process on the same seed
    parts, est, size, rank = workers.multihost_step(d)
    assert (size, rank) == (1, 0)
    np.testing.assert_array_equal(
        np.concatenate([outs[0][0], outs[1][0]]), parts)
    np.testing.assert_array_equal(outs[0][1], est)
    assert np.isfinite(est).all()


def test_single_process_start_up_is_a_no_op(monkeypatch):
    for key in ("MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    assert initialize_distributed() is False
    mesh = global_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    assert str(mesh.device) == "cpu"
    with pytest.raises(ValueError, match="initialize_distributed"):
        make_mesh(2, device="cpu")
