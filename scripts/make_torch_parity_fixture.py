"""Write the reference fixtures the PyTorch port is held to on the card.

``tests/data/torch_parity_step.npz``: one reference tiled PF step.

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

``tests/data/torch_parity_gsukf.npz``: one reference GSUKF step
(``predict_core``, ``update_core``, then the plain resample of the bank at
a fixed ``r``) at n = 4096 Gaussians on the same rig, from the
reference's initial bank; the sigma-point noise is made by numpy from
``NOISE_SEED`` (``gsukf_noise`` of ``gpu_se_tpu_torch/rig.py``, which
imports numpy only: the file holds the seed and the scales, not the
noise). It holds the input bank, the updated means and weights,
``ends`` and the resampled bank. Beside it, the reference's
v2 fused resample (``fused_systematic_resample_v2``, interpret mode) at
n = 4096 on integer-valued weights, where every cumsum is exact.

``tests/test_torch_particle_tiled.py`` and ``tests/test_torch_gs_ukf.py``
regenerate the arrays and check that they equal the committed files;
``chip_smoke.py`` holds the port's CUDA path to them. Run from the
repository root::

    python scripts/make_torch_parity_fixture.py
"""
from __future__ import annotations

import functools
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from gpu_se_tpu_torch.rig import (  # noqa: E402
    NOISE_SEED,
    NX,
    R_GSUKF,
    V2_GEOMETRY,
    V2_SEED,
    X_SS,
    bench_rig,
    gsukf_noise,
    v2_case,
)

OUT = os.path.join(REPO, "tests", "data", "torch_parity_step.npz")
OUT_GSUKF = os.path.join(REPO, "tests", "data", "torch_parity_gsukf.npz")
N = 4096
REGIMES = {"heavy": 0.0, "near_uniform": 20.0}   # z offset, mg/L


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


def build_gsukf(n: int = N) -> dict[str, np.ndarray]:
    """The GSUKF fixture's arrays (the reference run eagerly)."""
    import jax
    import jax.numpy as jnp

    from gpu_se_tpu.distributions import GaussianSum
    from gpu_se_tpu.filters import gs_ukf
    from gpu_se_tpu.filters.resampling import systematic_resample_indices
    from gpu_se_tpu.models import bioreactor as bio
    from gpu_se_tpu.ops.resample_coarse import ends_from_weights
    from gpu_se_tpu.ops.resample_pallas2 import fused_systematic_resample_v2

    x0_args, sp_args, mp_args = bench_rig()
    x0 = GaussianSum.create(*x0_args)
    state_pdf = GaussianSum.create(*sp_args)
    meas_pdf = GaussianSum.create(*mp_args)
    f = functools.partial(bio.homeostatic_des, xp=jnp)
    g = functools.partial(bio.static_outputs, xp=jnp)
    u = jnp.array([0.06, 0.2], jnp.float32)
    dt = jnp.float32(0.1)
    z = jnp.asarray(bio.static_outputs(X_SS, np.asarray(u), xp=np),
                    jnp.float32)
    r = jnp.float32(R_GSUKF)
    sd = np.sqrt(np.diag(sp_args[1][0])).astype(np.float32)

    state = gs_ukf.init(jax.random.PRNGKey(0), n, x0, state_pdf)
    means, covs = gs_ukf.predict_core(
        state.means, state.covariances, u, dt,
        jnp.asarray(gsukf_noise(sd, n)), f, noise_is_lanes=True)
    means, covs, w = gs_ukf.update_core(means, covs, state.weights, u, z,
                                        g, meas_pdf)
    idx = systematic_resample_indices(w, r)
    out = {
        "means_in": np.asarray(state.means),
        "covs_in": np.asarray(state.covariances),
        "w_in": np.asarray(state.weights),
        "noise_sd": sd, "noise_seed": np.int64(NOISE_SEED),
        "u": np.asarray(u), "dt": np.asarray(dt), "z": np.asarray(z),
        "r": np.asarray(r),
        "upd_means": np.asarray(means), "upd_w": np.asarray(w),
        "ends": np.asarray(ends_from_weights(w, r)),
        "out_means": np.asarray(means[idx]),
        "out_covs": np.asarray(covs[idx]),
    }
    for field in ("means", "covariances", "weights", "chol", "inv_cov",
                  "log_const"):
        out[f"meas_{field}"] = np.asarray(getattr(meas_pdf, field))
    parts, w2, r2 = v2_case(n)
    window, block = V2_GEOMETRY
    out.update({
        "v2_seed": np.int64(V2_SEED), "v2_window": np.int64(window),
        "v2_block": np.int64(block),
        "v2_out": np.asarray(fused_systematic_resample_v2(
            jnp.asarray(parts), jnp.asarray(w2), jnp.asarray(r2),
            window=window, block=block, interpret=True)),
    })
    return out


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_threefry_partitionable", True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    for path, arrays in ((OUT, build()), (OUT_GSUKF, build_gsukf())):
        np.savez_compressed(path, **arrays)
        print(f"wrote {path} ({os.path.getsize(path)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
