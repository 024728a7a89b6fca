"""Write ``tests/data/torch_parity_step.npz``: one reference tiled PF step.

Runs ``gpu_se_tpu.filters.particle_tiled.step`` (Pallas kernels in
interpret mode, on the CPU) at n = 4096 on the bench rig of ``bench.py``,
for two measurements: the rig's own (heavy-tailed weights, the
compacted kernel route) and one 20 mg/L off (near-uniform weights, the
direct route). Both start from the same particles and key, so they share
the noise and ``r``. The file holds what the PyTorch port needs to redo
the step without JAX: the input particles, the reference's noise, ``r``,
``u``, ``dt``, the measurement mixture's float32 fields, and per regime
``z``, the weights, ``ends`` and the output particles, all as
structure-of-arrays ``(nx, n)``.

``tests/test_torch_particle_tiled.py`` regenerates the arrays and checks
that they equal the committed file; ``chip_smoke.py`` holds the port's
CUDA path to it. Run from the repository root::

    python scripts/make_torch_parity_fixture.py
"""
from __future__ import annotations

import functools
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "torch_parity_step.npz")
N = 4096
NX = 5
X_SS = np.array([280 / 180, 640 / 24.6, 1000 / 116, 0.0, 0.0])
REGIMES = {"heavy": 0.0, "near_uniform": 20.0}   # z offset, mg/L


def bench_rig():
    """(x0, state_pdf, meas_pdf) mixture arguments of ``bench.py``."""
    x0 = (np.stack([X_SS, X_SS]),
          np.stack([np.eye(5) * 1e-4, np.eye(5) * 1e-3]),
          np.array([0.75, 0.25]))
    state_pdf = (np.zeros((2, 5)),
                 np.stack([np.diag([1e-4, 1e-7, 1e-3, 1e-3, 1e-7]),
                           np.diag([1e-3, 1e-6, 1e-2, 1e-2, 1e-6])]),
                 np.array([0.75, 0.25]))
    meas_pdf = (np.array([[1e-1, 0], [0, -1e-1]]),
                np.array([[[6e-2, 0], [0, 8e-2]], [[500, 100], [100, 700]]]),
                np.array([0.85, 0.15]))
    return x0, state_pdf, meas_pdf


def build(n: int = N) -> dict[str, np.ndarray]:
    """The fixture's arrays (runs the reference step eagerly: a jitted
    step may fuse the model's float32 ops differently)."""
    import jax
    import jax.numpy as jnp

    from gpu_se_tpu.distributions import GaussianSum
    from gpu_se_tpu.filters import particle_tiled as pft
    from gpu_se_tpu.models import bioreactor as bio
    from gpu_se_tpu.ops.resample_coarse import ends_from_weights

    x0_args, sp_args, mp_args = bench_rig()
    x0 = GaussianSum.create(*x0_args)
    state_pdf = GaussianSum.create(*sp_args)
    meas_pdf = GaussianSum.create(*mp_args)
    f = functools.partial(bio.homeostatic_des, xp=jnp)
    g = functools.partial(bio.static_outputs, xp=jnp)
    u = jnp.array([0.06, 0.2], jnp.float32)
    dt = jnp.float32(0.1)
    z0 = np.asarray(bio.static_outputs(X_SS, np.asarray(u), xp=np),
                    np.float32)

    state = pft.init(jax.random.PRNGKey(0), n, x0)
    _, kn, kr = jax.random.split(state.key, 3)        # as pft.step splits
    noise = state_pdf.draw_t(kn, n)
    r = jax.random.uniform(kr, (), dtype=jnp.float32)
    x_in = pft.untile(state, NX).T                     # (nx, n)

    out = {
        "x_in": np.asarray(x_in), "noise": np.asarray(noise),
        "r": np.asarray(r), "u": np.asarray(u), "dt": np.asarray(dt),
    }
    for field in ("means", "covariances", "weights", "chol", "inv_cov",
                  "log_const"):
        out[f"meas_{field}"] = np.asarray(getattr(meas_pdf, field))
    for name, offset in REGIMES.items():
        z = jnp.asarray(z0 + np.float32(offset))
        xn = x_in + f(x_in, u, dt) + noise
        w = meas_pdf.pdf_t(z.reshape(-1, 1) - g(xn, u))
        ends = ends_from_weights(w, r)
        stepped = pft.step(state, u, z, dt, f, g, state_pdf, meas_pdf,
                           interpret=True)
        out[f"{name}_z"] = np.asarray(z)
        out[f"{name}_w"] = np.asarray(w)
        out[f"{name}_ends"] = np.asarray(ends)
        out[f"{name}_x_out"] = np.asarray(pft.untile(stepped, NX).T)
    return out


def main() -> int:
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_threefry_partitionable", True)
    arrays = build()
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
