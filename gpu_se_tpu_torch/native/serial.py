"""The float64 serial particle-filter engine: ctypes binding and build.

Counterpart of the JAX package's ``native/serial.py``, over the port's
own copy of the C++ source (``native/csrc/serial_pf.cpp``). ``g++ -O2``
builds the shared library at first use into ``gpu_se_tpu_torch/_build/``
under a name keyed by a hash of the source and the flags; the build
writes a temporary file and renames it into place, so processes that
build at once do not collide. :func:`available` says whether the engine
builds and loads here; :class:`SerialParticleFilter` raises if it does
not. It needs numpy and a C++ compiler, no torch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "serial_pf.cpp"
_BUILD = _SRC.parent.parent.parent / "_build"
_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lib = None
_load_error = None


def library_path() -> pathlib.Path:
    """Where the library for this source and these flags lives."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode())
    return _BUILD / f"libserial_pf_{digest.hexdigest()[:16]}.so"


def _compile(lib: pathlib.Path) -> None:
    _BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", tmp], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _load_error
    if _lib is not None:
        return _lib
    path = library_path()
    try:
        if not path.exists():
            _compile(path)
        lib = ctypes.CDLL(str(path))
    except (OSError, subprocess.SubprocessError) as exc:
        _load_error = exc
        return None

    dp = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
    ip = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    f64 = ctypes.c_double

    lib.homeostatic_des.argtypes = [dp, dp, f64, dp]
    lib.pf_predict.argtypes = [dp, i64, i64, dp, f64, dp]
    lib.pf_update.argtypes = [dp, dp, i64, i64, dp, i64, i64, dp, dp, dp, dp]
    lib.systematic_resample_indices.argtypes = [dp, i64, f64, ip]
    lib.gather.argtypes = [dp, ip, i64, i64, dp]
    for fn in (lib.homeostatic_des, lib.pf_predict, lib.pf_update,
               lib.systematic_resample_indices, lib.gather):
        fn.restype = None
    _lib = lib
    return lib


def available() -> bool:
    """Whether the engine builds and loads here."""
    return _load() is not None


def library():
    """The loaded engine; raises ``RuntimeError`` if it cannot build or
    load."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the serial engine does not build here: "
                           f"{_load_error}")
    return lib


class SerialParticleFilter:
    """The serial float64 PF on the bioreactor model: predict, update,
    systematic resample and point estimate, with the noise and ``r``
    given by the caller so that a run can share them with another
    engine. The measurement model is ``g = (180 x_0, 116 x_2)`` with a
    Gaussian-sum noise of ``meas_means``, ``meas_covs``,
    ``meas_weights``."""

    def __init__(self, particles: np.ndarray, meas_means, meas_covs,
                 meas_weights):
        self._lib = library()
        # a copy: the engine updates the particles in place
        self.particles = np.array(particles, dtype=np.float64, order="C",
                                  copy=True)
        n = self.particles.shape[0]
        self.weights = np.full(n, 1.0 / n)
        self._means = np.ascontiguousarray(meas_means, dtype=np.float64)
        covs = np.asarray(meas_covs, dtype=np.float64)
        self._inv_cov = np.ascontiguousarray(np.linalg.inv(covs))
        ny = covs.shape[-1]
        self._norm_const = np.ascontiguousarray(
            (2 * np.pi) ** (-ny / 2) / np.sqrt(np.linalg.det(covs)))
        self._mix_w = np.ascontiguousarray(meas_weights, dtype=np.float64)

    def predict(self, u, dt, noise) -> None:
        """``x_i += f(x_i, u, dt) + noise_i``."""
        n, nx = self.particles.shape
        noise = np.ascontiguousarray(noise, dtype=np.float64)
        if noise.shape != (n, nx):
            raise ValueError(f"noise {noise.shape}, particles {(n, nx)}")
        self._lib.pf_predict(self.particles, n, nx,
                             np.ascontiguousarray(u, dtype=np.float64),
                             float(dt), noise)

    def update(self, z) -> None:
        """``w_i *= pdf(z - g(x_i))``."""
        n, nx = self.particles.shape
        nd, ny = self._means.shape
        self._lib.pf_update(self.particles, self.weights, n, nx,
                            np.ascontiguousarray(z, dtype=np.float64), ny, nd,
                            self._means, self._inv_cov, self._norm_const,
                            self._mix_w)

    def resample(self, r) -> np.ndarray:
        """The systematic resample at the uniform ``r``; returns the
        ancestor indices and leaves uniform weights."""
        n, nx = self.particles.shape
        idx = np.empty(n, dtype=np.int64)
        self._lib.systematic_resample_indices(self.weights, n, float(r), idx)
        out = np.empty_like(self.particles)
        self._lib.gather(self.particles, idx, n, nx, out)
        self.particles = out
        self.weights = np.full(n, 1.0 / n)
        return idx

    def point_estimate(self) -> np.ndarray:
        """The weighted mean of the particles, normalized."""
        w = self.weights / self.weights.sum()
        return w @ self.particles
