"""Dense ADMM QP solver with OSQP semantics.

Counterpart of ``gpu_se_tpu/control/qp.py``. Solves

    min 1/2 x^T P x + q^T x  s.t.  l <= A x <= u

for a family with fixed ``(P, A)``: the host setup (Ruiz equilibration,
per-row rho, the dense inverse of the KKT matrix or, for an identity
Hessian, the m x m Woodbury factor) runs once in float64 numpy, as the
reference's; only ``q``, ``l``, ``u`` and the warm start change per solve.

The reference's solve is one ``lax.while_loop`` with a ``lax.cond`` every
``check_every`` iterations. Here the loop runs on the constants' device
in chunks of ``check_every`` iterations: no value is read back inside a
chunk, and after each check one small transfer says whether any member
is still running and whether any needs a new rho. On CUDA a chunk is
replayed from a CUDA graph, captured at the first solve of a batch size
and cached on the constants; the check runs eagerly. The adaptive-rho
refactorization is computed for every member when any needs it and kept
per member by ``torch.where``; its inverse is ``torch.linalg.inv_ex``,
which does not wait for the card to report an error.

Every solve is batched: ``solve`` is a batch of one, and the matrix
products are per-member ``bmm`` calls, so a member of ``solve_batch``
computes what a single ``solve`` does. A member that has stopped keeps
its state while the others run on. Matrix products run with TF32 off
whatever the caller has set (the reference pins float32 matmul passes
around its solve), and the caller's setting is restored after.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from gpu_se_tpu_torch import graphs
from gpu_se_tpu_torch.ops.smallmat import _sqrt

# Status codes (OSQP-compatible naming)
SOLVED = 1
MAX_ITER_REACHED = 0
PRIMAL_INFEASIBLE = -3
DUAL_INFEASIBLE = -4


@dataclass
class QPSettings:
    rho: float = 0.1
    rho_eq_scale: float = 1e3  # rho multiplier for equality rows (l == u)
    sigma: float = 1e-6
    alpha: float = 1.6
    eps_abs: float = 1e-4
    eps_rel: float = 1e-4
    eps_infeas: float = 1e-4
    max_iter: int = 4000
    check_every: int = 25
    scaling_iters: int = 10
    # adaptive rho (OSQP-style): scale rho by sqrt(prim_rel/dual_rel) when
    # the ratio drifts past the threshold, refactorizing K on the device
    adaptive_rho: bool = True
    adaptive_rho_threshold: float = 5.0
    rho_min: float = 1e-6
    rho_max: float = 1e6
    # set automatically by DenseQP when P is (a multiple of) the identity:
    # the KKT solve uses the Woodbury identity through an m x m factor, so
    # no n x n matrix is ever built or shipped to the device
    identity_hessian: bool = False
    dtype: torch.dtype = torch.float32


@dataclass
class QPConstants:
    """Device-resident constants for a fixed (P, A) pair."""

    P_s: torch.Tensor  # scaled P (n, n); (0, 0) dummy in identity mode
    A_s: torch.Tensor  # scaled A (m, n)
    K: torch.Tensor  # P_s + sigma I + A_s^T diag(rho) A_s; (0, 0) in identity mode
    K_inv: torch.Tensor
    rho: torch.Tensor  # (m,)
    rho_inv: torch.Tensor
    d_scale: torch.Tensor  # (n,) Ruiz D diagonal
    e_scale: torch.Tensor  # (m,) Ruiz E diagonal
    c_scale: torch.Tensor  # scalar cost scaling
    aat: torch.Tensor  # (m, m) A_s A_s^T — identity mode only, else (0, 0)
    s_fac: torch.Tensor  # (m, m) inv(diag(1/rho) + aat / (1 + sigma)) — identity mode


@dataclass
class QPSolution:
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    status: torch.Tensor
    iterations: torch.Tensor
    prim_res: torch.Tensor
    dual_res: torch.Tensor


def _ruiz_equilibrate(P: np.ndarray, A: np.ndarray, q: np.ndarray, iters: int):
    """Modified Ruiz equilibration of the stacked KKT matrix + cost scaling
    (the dense analogue of OSQP's scaling routine)."""
    n = P.shape[0]
    m = A.shape[0]
    d = np.ones(n)
    e = np.ones(m) if m else np.ones(0)
    c = 1.0
    for _ in range(iters):
        P_s = c * (d[:, None] * P * d[None, :])
        A_s = (e[:, None] * A * d[None, :]) if m else A
        # column norms over the stacked [P_s; A_s]
        col_norm = np.maximum(
            np.abs(P_s).max(axis=0), np.abs(A_s).max(axis=0) if m else 0.0
        )
        col_norm = np.where(col_norm > 1e-12, col_norm, 1.0)
        delta_d = 1.0 / np.sqrt(col_norm)
        if m:
            row_norm = np.abs(A_s).max(axis=1)
            row_norm = np.where(row_norm > 1e-12, row_norm, 1.0)
            delta_e = 1.0 / np.sqrt(row_norm)
            e = e * delta_e
        d = d * delta_d
        # cost scaling: norms of the *currently scaled* cost data
        P_s = c * (d[:, None] * P * d[None, :])
        p_col_mean = np.abs(P_s).max(axis=0).mean()
        q_norm = np.abs(c * d * q).max() if q is not None else 0.0
        denom = max(p_col_mean, q_norm)
        gamma = 1.0 / denom if denom > 1e-12 else 1.0
        c = c * gamma
    return d, e, c


class DenseQP:
    """Host-side setup and the device solve for a QP family with fixed
    (P, A).

    Parameters
    ----------
    P : (n, n) Hessian (PSD)
    A : (m, n) constraint matrix
    l_pattern, u_pattern : (m,) representative bounds used only to decide
        which rows are equalities for per-row rho (values may change per
        solve, the equality *pattern* must not — same contract as OSQP's
        ``update(l, u)``).
    q_pattern : (n,) representative linear cost for cost scaling.
    device : where the constants and every solve live: the card unless
        the caller passes ``device="cpu"``.
    """

    def __init__(
        self,
        P: np.ndarray,
        A: np.ndarray,
        l_pattern: Optional[np.ndarray] = None,
        u_pattern: Optional[np.ndarray] = None,
        q_pattern: Optional[np.ndarray] = None,
        settings: Optional[QPSettings] = None,
        device="cuda",
    ):
        self.settings = settings or QPSettings()
        s = self.settings
        P = np.asarray(P, dtype=np.float64)
        A = np.atleast_2d(np.asarray(A, dtype=np.float64))
        if A.size == 0:
            A = np.zeros((0, P.shape[0]))
        self.n = P.shape[0]
        self.m = A.shape[0]
        q_pattern = (
            np.zeros(self.n) if q_pattern is None else np.asarray(q_pattern, float)
        )

        # identity-Hessian fast path: no n x n matrix is built or shipped;
        # the KKT solve goes through an m x m Woodbury factor
        is_identity = P[0, 0] > 0 and np.array_equal(P, P[0, 0] * np.eye(self.n))
        if is_identity:
            d = np.ones(self.n)
            c = 1.0 / P[0, 0]
            if self.m:
                row_norm = np.abs(A).max(axis=1)
                e = 1.0 / np.where(row_norm > 1e-12, row_norm, 1.0)
                A_s = e[:, None] * A
            else:
                e = np.ones(0)
                A_s = A
            P_s = np.zeros((0, 0))
            K = K_inv = np.zeros((0, 0))
        else:
            d, e, c = _ruiz_equilibrate(P, A, q_pattern, s.scaling_iters)
            P_s = c * (d[:, None] * P * d[None, :])
            A_s = e[:, None] * A * d[None, :] if self.m else A

        # per-row rho: equalities get rho * rho_eq_scale
        rho_vec = np.full(self.m, s.rho)
        if self.m and l_pattern is not None and u_pattern is not None:
            eq = np.isclose(np.asarray(l_pattern, float), np.asarray(u_pattern, float))
            rho_vec = np.where(eq, s.rho * s.rho_eq_scale, s.rho)

        beta = 1.0 + s.sigma
        if is_identity:
            aat = A_s @ A_s.T if self.m else np.zeros((0, 0))
            if self.m:
                s_fac = np.linalg.inv(np.diag(1.0 / rho_vec) + aat / beta)
            else:
                s_fac = np.zeros((0, 0))
        else:
            aat = s_fac = np.zeros((0, 0))
            K = P_s + s.sigma * np.eye(self.n)
            if self.m:
                K = K + A_s.T @ (rho_vec[:, None] * A_s)
            K_inv = np.linalg.inv(K)

        self.settings = s = dataclasses.replace(s, identity_hessian=is_identity)
        self.device = torch.device(device)

        def dev(a):
            return torch.as_tensor(np.asarray(a), dtype=s.dtype,
                                   device=self.device)

        self.consts = QPConstants(
            P_s=dev(P_s),
            A_s=dev(A_s),
            K=dev(K),
            K_inv=dev(K_inv),
            rho=dev(rho_vec),
            rho_inv=dev(1.0 / rho_vec if self.m else rho_vec),
            d_scale=dev(d),
            e_scale=dev(e),
            c_scale=dev(c),
            aat=dev(aat),
            s_fac=dev(s_fac),
        )

    def to(self, device) -> "DenseQP":
        """This QP with its constants on ``device``: the host setup is
        shared, not rebuilt."""
        new = copy.copy(self)
        new.device = torch.device(device)
        new.consts = QPConstants(**{
            f.name: getattr(self.consts, f.name).to(new.device)
            for f in dataclasses.fields(QPConstants)})
        return new

    def _t(self, v) -> torch.Tensor:
        return torch.as_tensor(v, dtype=self.settings.dtype, device=self.device)

    def solve_batch(self, qs, ls, us, x0s=None, y0s=None) -> QPSolution:
        """Solve a batch of QPs sharing (P, A): one ADMM over the leading
        axis, run until every member has stopped. Each member comes out
        as :meth:`solve` would return it."""
        qs, ls, us = self._t(qs), self._t(ls), self._t(us)
        b = qs.shape[0]
        x0s = self._t(x0s) if x0s is not None else qs.new_zeros((b, self.n))
        y0s = self._t(y0s) if y0s is not None else qs.new_zeros((b, self.m))
        return _admm_solve(self.consts, qs, ls, us, x0s, y0s, self.settings)

    def solve(self, q, l, u, x0=None, y0=None) -> QPSolution:
        q, l, u = self._t(q), self._t(l), self._t(u)
        x0 = self._t(x0) if x0 is not None else q.new_zeros(self.n)
        y0 = self._t(y0) if y0 is not None else q.new_zeros(self.m)
        return _admm_solve(self.consts, q, l, u, x0, y0, self.settings)


# ----------------------------------------------------------------------
@contextlib.contextmanager
def _f32_matmul():
    """Full float32 matrix products (TF32 off) for the body, then the
    caller's setting back."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``M @ v_b`` for every member ``b``: ``M`` is ``(r, k)`` or ``(B, r,
    k)``, ``v`` is ``(B, k)``; returns ``(B, r)``. One ``bmm``, so each
    member's product is the same call whatever the batch size."""
    b = v.shape[0]
    if M.dim() == 2:
        M = M.expand(b, *M.shape)
    return torch.bmm(M, v.unsqueeze(-1)).squeeze(-1)


def _graphed(c: QPConstants, key, fn, args: dict):
    """``fn(**args)`` as a CUDA graph (``gpu_se_tpu_torch.graphs``) cached
    on ``c`` under ``key``: run at the first call, then captured; later
    calls copy ``args`` into its inputs and replay it. The outputs of a
    replay are the graph's own tensors, rewritten by the next replay."""
    cache = c.__dict__.setdefault("_graphs", {})
    if key not in cache:
        cache[key] = graphs.Graphed(fn, copy_out=False)
    return cache[key](**args)


def _amax(v: torch.Tensor) -> torch.Tensor:
    """Per-member max over the last axis."""
    return torch.amax(v, dim=-1)


def _admm_solve(c: QPConstants, q, l, u, x0, y0,
                settings: QPSettings) -> QPSolution:
    """One ADMM solve, or a batch of them. Inputs and outputs are in
    UNSCALED units. ``q``, ``l``, ``u``, ``x0``, ``y0`` are vectors (one
    problem) or carry a leading batch axis."""
    single = q.dim() == 1
    if single:
        q, l, u, x0, y0 = (t.unsqueeze(0) for t in (q, l, u, x0, y0))
    with _f32_matmul(), torch.no_grad():
        sol = _admm_solve_impl(c, q, l, u, x0, y0, settings)
    if single:
        sol = QPSolution(*(getattr(sol, f.name)[0]
                           for f in dataclasses.fields(sol)))
    return sol


def _admm_solve_impl(c: QPConstants, q, l, u, x0, y0,
                     settings: QPSettings) -> QPSolution:
    """The batched ADMM, on ``(B, .)`` vectors.

    Implements OSQP's adaptive-rho scheme: when the primal/dual relative
    residual ratio drifts past ``adaptive_rho_threshold``, rho is scaled
    by sqrt(prim_rel / dual_rel) and the KKT matrix is refactorized on the
    device. Each member carries its own rho and factor.
    """
    s = settings
    m = c.A_s.shape[0]
    n = c.d_scale.shape[0]
    b = q.shape[0]
    dtype, device = q.dtype, q.device
    big = torch.tensor(torch.finfo(dtype).max / 4, dtype=dtype, device=device)

    def scalar(v):
        return torch.tensor(v, dtype=dtype, device=device)

    # scale problem data
    q_s = c.c_scale * c.d_scale * q
    l_s = torch.clamp(c.e_scale * l, -big, big)
    u_s = torch.clamp(c.e_scale * u, -big, big)

    # warm start in scaled coordinates
    x = x0 / c.d_scale
    y = (c.c_scale / c.e_scale) * y0 if m else y0
    z = _mv(c.A_s, x) if m else q.new_zeros((b, 0))
    z = torch.clamp(z, l_s, u_s)

    ident = s.identity_hessian
    beta = 1.0 + s.sigma
    A_t = c.A_s.T

    def kkt_solve(K, K_inv, s_fac, rhs):
        if ident:
            # Woodbury: (beta I + A' R A)^{-1} = I/beta - A' S^{-1} A / beta^2
            if m:
                return rhs / beta - _mv(A_t, _mv(s_fac, _mv(c.A_s, rhs))) / (
                    beta * beta)
            return rhs / beta
        sol = _mv(K_inv, rhs)
        r = rhs - _mv(K, sol)
        return sol + _mv(K_inv, r)  # one refinement step for f32 accuracy

    zero = scalar(0.0)

    def residuals(x, z, y):
        ax = _mv(c.A_s, x) if m else None
        prim = _amax(torch.abs((ax - z) / c.e_scale)) if m else zero.expand(b)
        px = x / c.c_scale if ident else _mv(c.P_s, x)
        aty = _mv(A_t, y) if m else torch.zeros_like(x)
        dual = _amax(torch.abs((px + q_s + aty) / c.d_scale)) / c.c_scale
        # relative denominators (unscaled norms)
        denom_p = torch.maximum(
            _amax(torch.abs(ax / c.e_scale)) if m else zero.expand(b),
            _amax(torch.abs(z / c.e_scale)) if m else zero.expand(b),
        )
        denom_d = _amax(
            torch.stack(
                [
                    _amax(torch.abs(px / c.d_scale)),
                    _amax(torch.abs(aty / c.d_scale)),
                    _amax(torch.abs(q_s / c.d_scale)),
                ],
                dim=-1,
            )
        ) / c.c_scale
        return prim, dual, denom_p, denom_d

    def check_infeasibility(dx, dy):
        eps = s.eps_infeas
        # primal infeasibility certificate from dy (unscaled: E dy / c)
        if m:
            dy_un = c.e_scale * dy / c.c_scale
            norm_dy = _amax(torch.abs(dy_un))
            aty_dy = _amax(torch.abs(_mv(A_t, dy) / c.d_scale / c.c_scale))
            dy_plus = torch.clamp_min(dy_un, 0.0)
            dy_minus = torch.clamp_max(dy_un, 0.0)
            sup = torch.sum(torch.where(dy_plus > 0, u * dy_plus, zero),
                            dim=-1) + torch.sum(
                torch.where(dy_minus < 0, l * dy_minus, zero), dim=-1)
        else:
            norm_dy = zero.expand(b)
            aty_dy = sup = scalar(float("inf")).expand(b)
        prim_infeas = (
            (norm_dy > 1e-12)
            & (aty_dy <= eps * norm_dy)
            & (sup <= -eps * norm_dy)
        )
        # dual infeasibility certificate from dx
        dx_un = c.d_scale * dx
        norm_dx = _amax(torch.abs(dx_un))
        pdx_vec = dx / c.c_scale if ident else _mv(c.P_s, dx)
        pdx = _amax(torch.abs(pdx_vec / c.d_scale)) / c.c_scale
        qdx = torch.sum((q_s / c.d_scale) * dx_un, dim=-1) / c.c_scale
        dual_infeas = (
            (norm_dx > 1e-12)
            & (pdx <= eps * norm_dx)
            & (qdx <= -eps * norm_dx)
        )
        if m:
            adx = _mv(c.A_s, dx) / c.e_scale
            lim = (eps * norm_dx)[:, None]
            up_ok = torch.all(torch.where(torch.isfinite(u), adx <= lim, True),
                              dim=-1)
            lo_ok = torch.all(torch.where(torch.isfinite(l), adx >= -lim, True),
                              dim=-1)
            dual_infeas = dual_infeas & up_ok & lo_ok
        return prim_infeas, dual_infeas

    def inverse(M):
        # inv_ex: no check of the factorization, so no wait on the card
        return torch.linalg.inv_ex(M)[0]

    def refactor(rho):
        if ident:
            return None, None, inverse(torch.diag_embed(1.0 / rho) + c.aat / beta)
        K = c.P_s + s.sigma * torch.eye(n, dtype=dtype, device=device)
        if m:
            K = K + torch.bmm(A_t.expand(b, n, m), rho[:, :, None] * c.A_s)
        return K, inverse(K), None

    def per_member(t):
        return t.expand(b, *t.shape).clone()

    # carry: x, z, y, x_prev, y_prev and the factor, each per member
    rho = per_member(c.rho)
    K = K_inv = s_fac = None
    if ident:
        s_fac = per_member(c.s_fac)
    else:
        K, K_inv = per_member(c.K), per_member(c.K_inv)
    x_prev, y_prev = x, y
    its = torch.zeros(b, dtype=torch.int32, device=device)
    status = torch.full((b,), MAX_ITER_REACHED, dtype=torch.int32,
                        device=device)

    def iterate(x, z, y, xp, yp, rho, rho_inv, q_s, l_s, u_s, K=None,
                K_inv=None, s_fac=None):
        """``steps`` ADMM iterations; returns the iterate, the one before
        it, and the one before that (the reference's carried x_prev,
        y_prev at its check)."""
        for _ in range(steps):
            dx_from, dy_from = xp, yp
            # x-update
            rhs = s.sigma * x - q_s
            if m:
                rhs = rhs + _mv(A_t, rho * z - y)
            x_t = kkt_solve(K, K_inv, s_fac, rhs)
            x_new = s.alpha * x_t + (1 - s.alpha) * x
            if m:
                z_t = _mv(c.A_s, x_t)
                # z_pre carries rho^{-1} y, so the dual update collapses to
                # y_new = rho (z_pre - z_new)  [OSQP Algorithm 1 steps 4-5]
                z_pre = s.alpha * z_t + (1 - s.alpha) * z + rho_inv * y
                z_new = torch.clamp(z_pre, l_s, u_s)
                y_new = rho * (z_pre - z_new)
            else:
                z_new, y_new = z, y
            xp, yp = x, y
            x, z, y = x_new, z_new, y_new
        return x, z, y, xp, yp, dx_from, dy_from

    it = 0
    while it < s.max_iter:
        running = status == MAX_ITER_REACHED
        steps = min(s.check_every - it % s.check_every, s.max_iter - it)
        args = dict(x=x, z=z, y=y, xp=x_prev, yp=y_prev, rho=rho,
                    rho_inv=1.0 / rho if m else rho, q_s=q_s, l_s=l_s,
                    u_s=u_s)
        if ident:
            args["s_fac"] = s_fac
        else:
            args.update(K=K, K_inv=K_inv)
        if device.type == "cuda":
            key = (b, steps, dataclasses.astuple(s))
            out = _graphed(c, key, iterate, args)
        else:
            out = iterate(**args)
        xs, zs, ys, xps, yps, dx_from, dy_from = out
        it += steps

        def keep(new, old):
            mask = running.reshape((b,) + (1,) * (new.dim() - 1))
            return torch.where(mask, new, old)

        its = torch.where(running, its + steps, its)
        need = None
        if it % s.check_every == 0:
            prim_r, dual_r, denom_p, denom_d = residuals(xs, zs, ys)
            eps_p = s.eps_abs + s.eps_rel * denom_p
            eps_d = s.eps_abs + s.eps_rel * denom_d
            solved = (prim_r <= eps_p) & (dual_r <= eps_d)
            p_inf, d_inf = check_infeasibility(xs - dx_from, ys - dy_from)
            new_status = torch.where(
                solved, SOLVED,
                torch.where(p_inf, PRIMAL_INFEASIBLE,
                            torch.where(d_inf, DUAL_INFEASIBLE, status)),
            ).to(torch.int32)
            status = keep(new_status, status)
            if m and s.adaptive_rho:
                tiny = scalar(1e-10)
                prim_rel = prim_r / (denom_p + tiny)
                dual_rel = dual_r / (denom_d + tiny)
                factor = _sqrt(prim_rel / (dual_rel + tiny) + tiny)
                need = running & (status == MAX_ITER_REACHED) & (
                    (factor > s.adaptive_rho_threshold)
                    | (factor < 1.0 / s.adaptive_rho_threshold)
                )
        x, z, y = keep(xs, x), keep(zs, z), keep(ys, y)
        x_prev, y_prev = keep(xps, x_prev), keep(yps, y_prev)
        if it >= s.max_iter:
            break
        # the one read of a check: any member still running, any to refactor
        flags = torch.stack([
            (status == MAX_ITER_REACHED).any(),
            need.any() if need is not None else status.new_zeros((), dtype=torch.bool),
        ]).tolist()
        if flags[1]:
            new_rho = torch.clamp(rho * factor[:, None], s.rho_min, s.rho_max)
            K2, K_inv2, s_fac2 = refactor(new_rho)
            sel = need[:, None]
            rho = torch.where(sel, new_rho, rho)
            if ident:
                s_fac = torch.where(sel[:, :, None], s_fac2, s_fac)
            else:
                K = torch.where(sel[:, :, None], K2, K)
                K_inv = torch.where(sel[:, :, None], K_inv2, K_inv)
        if not flags[0]:
            break

    # final residual check in case max_iter landed between checks
    prim_r, dual_r, denom_p, denom_d = residuals(x, z, y)
    status = torch.where(
        (status == MAX_ITER_REACHED)
        & (prim_r <= s.eps_abs + s.eps_rel * denom_p)
        & (dual_r <= s.eps_abs + s.eps_rel * denom_d),
        SOLVED,
        status,
    ).to(torch.int32)

    return QPSolution(
        x=c.d_scale * x,
        y=(c.e_scale * y / c.c_scale) if m else y,
        z=(z / c.e_scale) if m else z,
        status=status,
        iterations=its,
        prim_res=prim_r,
        dual_res=dual_r,
    )
