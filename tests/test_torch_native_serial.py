"""The port's float64 serial engine (``gpu_se_tpu_torch/native``): its
own copy of the JAX package's C++ engine gives the same bits as the
JAX package's ``native.serial`` on every entry, and it holds the port's
flat float32 predict and update, fed the same noise, at the tolerance of
``tests/test_native_serial.py`` (``rtol=1e-4, atol=1e-5``, on the
particles and on the weights normalized to mean 1), as ``chip_smoke.py``
phase (j) holds the card's."""
import numpy as np
import pytest
import torch

from gpu_se_tpu.native import serial as ref_serial
from gpu_se_tpu_torch import rig
from gpu_se_tpu_torch.distributions import GaussianSum
from gpu_se_tpu_torch.filters import particle as tpf
from gpu_se_tpu_torch.models import bioreactor as tbio
from gpu_se_tpu_torch.native import serial


@pytest.fixture(scope="module")
def libs():
    if not (serial.available() and ref_serial.available()):
        pytest.skip("no C++ toolchain")
    return serial.library(), ref_serial._load()


def test_library_is_the_ports_own_build(libs):
    assert serial.library_path().parent.name == "_build"
    assert "gpu_se_tpu_torch" in str(serial.library_path())
    assert serial.library_path().exists()


def test_homeostatic_des_same_bits(libs):
    lib, ref = libs
    rng = np.random.default_rng(0)
    for _ in range(20):
        x, u = rng.uniform(-1, 30, 5), rng.uniform(0, 0.3, 2)
        got, want = np.empty(5), np.empty(5)
        lib.homeostatic_des(x, u, 0.1, got)
        ref.homeostatic_des(x, u, 0.1, want)
        np.testing.assert_array_equal(got, want)


def _engines(n, seed):
    particles, noise = rig.serial_case(n, seed)
    return ([mod.SerialParticleFilter(particles, *rig.SERIAL_MEAS)
             for mod in (serial, ref_serial)], noise)


@pytest.mark.parametrize("n", (1, 256, 4099))
def test_predict_update_resample_gather_same_bits(libs, n):
    (eng, ref), noise = _engines(n, n)
    for e in (eng, ref):
        e.predict(rig.SERIAL_U, rig.SERIAL_DT, noise)
    np.testing.assert_array_equal(eng.particles, ref.particles)
    for e in (eng, ref):
        e.update(rig.SERIAL_Z)
    np.testing.assert_array_equal(eng.weights, ref.weights)
    for r in (0.0, 0.371, 0.9):
        lib, ref_lib = libs
        got, want = np.empty(n, np.int64), np.empty(n, np.int64)
        lib.systematic_resample_indices(eng.weights, n, r, got)
        ref_lib.systematic_resample_indices(ref.weights, n, r, want)
        np.testing.assert_array_equal(got, want)
        g_out, w_out = np.empty((n, 5)), np.empty((n, 5))
        lib.gather(eng.particles, got, n, 5, g_out)
        ref_lib.gather(ref.particles, want, n, 5, w_out)
        np.testing.assert_array_equal(g_out, w_out)
    np.testing.assert_array_equal(eng.resample(0.5), ref.resample(0.5))
    np.testing.assert_array_equal(eng.particles, ref.particles)
    np.testing.assert_array_equal(eng.point_estimate(), ref.point_estimate())


def test_noise_shape_is_checked(libs):
    (eng, _), noise = _engines(8, 0)
    with pytest.raises(ValueError):
        eng.predict(rig.SERIAL_U, rig.SERIAL_DT, noise[:4])


@pytest.mark.parametrize("n", (256, rig.SERIAL_N))
def test_flat_predict_update_against_the_engine(libs, n):
    """The port's float32 ``predict_from_noise`` and ``update`` on the
    CPU against the float64 engine, fed the same particles and noise."""
    particles, noise = rig.serial_case(n)
    eng = serial.SerialParticleFilter(particles, *rig.SERIAL_MEAS)
    eng.predict(rig.SERIAL_U, rig.SERIAL_DT, noise)
    eng.update(rig.SERIAL_Z)
    meas = GaussianSum.create(*rig.SERIAL_MEAS, device="cpu")
    u = torch.tensor(rig.SERIAL_U, dtype=torch.float32)
    z = torch.tensor(rig.SERIAL_Z, dtype=torch.float32)
    x = tpf.predict_from_noise(torch.from_numpy(particles), u,
                               torch.tensor(rig.SERIAL_DT),
                               tbio.homeostatic_des, torch.from_numpy(noise))
    w = tpf.update(tpf.PFState(x, torch.full((n,), 1.0 / n), None), u, z,
                   tbio.static_outputs, meas).weights
    np.testing.assert_allclose(x.numpy(), eng.particles,
                               rtol=rig.SERIAL_RTOL, atol=rig.SERIAL_ATOL)
    w = w.numpy()
    np.testing.assert_allclose(w / w.mean(), eng.weights / eng.weights.mean(),
                               rtol=rig.SERIAL_RTOL, atol=rig.SERIAL_ATOL)
