"""Dense ADMM QP solver with OSQP semantics.

Counterpart of ``gpu_se_tpu/control/qp.py``. Solves

    min 1/2 x^T P x + q^T x  s.t.  l <= A x <= u

for a family with fixed ``(P, A)``: the host setup (Ruiz equilibration,
per-row rho, the dense inverse of the KKT matrix or, for an identity
Hessian, the m x m Woodbury factor) runs once in float64 numpy, as the
reference's; only ``q``, ``l``, ``u`` and the warm start change per solve.

The reference's solve is one ``lax.while_loop`` with a ``lax.cond`` every
``check_every`` iterations (``gpu_se_tpu/control/qp.py:404-489``). Here
the solve is split into parts that act in place on a carry
(:class:`_Loop`): a chunk of ``check_every`` iterations ending in the
check, which leaves two flags on the device (any member still running
with a whole chunk left, any member to refactorize), the adaptive-rho
refactorization, and the iterations after the last check. On the CPU a
Python loop drives the parts, reading the flags once a chunk. On CUDA
each part is captured once as a CUDA graph, cached on the constants by
batch size and settings, and a solve is one graph: the scaling and warm
start, a conditional WHILE node whose body runs the chunk and, under a
nested IF node, the refactorization, an IF node over the tail, and the
final check (``ops/graph_cond``): nothing is read back to the host.
Called inside a caller's capture it joins it, loop and all. Inside
:func:`host_driven` the card's solve is driven from the host instead:
the same parts' graphs in the same order, so the same bits, the
comparison's other side; under ``graphs.disabled()`` the parts run
eagerly from the host, as ``lax.while_loop`` runs from Python under
``jax.disable_jit()``. A solve that cannot be built or captured raises:
nothing falls back to the host. The refactorization is computed
for every member when any needs it and kept per member by
``torch.where``; its inverse is ``torch.linalg.inv_ex`` through cuSOLVER,
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
from gpu_se_tpu_torch.ops import graph_cond
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


@dataclass(frozen=True, eq=False)
class QPConstants:
    """Device-resident constants for a fixed (P, A) pair; a graph reads
    them at their addresses (``graphs``), and the solve's device loops are
    cached on them."""

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


_HOST_DRIVEN: list = []


@contextlib.contextmanager
def host_driven():
    """Inside it a solve on the card runs its loop from the host: after
    each chunk one read says whether to refactor and whether to go on, as
    ``lax.while_loop`` runs under ``jax.disable_jit()``. The same parts
    run in the same order (each chunk, refactorization and tail a replay
    of the graph the device loop holds a clone of), so the results are
    bit-equal to the device loop's: the comparison's host side. Nothing
    on a main path enters it."""
    _HOST_DRIVEN.append(True)
    try:
        yield
    finally:
        _HOST_DRIVEN.pop()


def _amax(v: torch.Tensor) -> torch.Tensor:
    """Per-member max over the last axis."""
    return torch.amax(v, dim=-1)


@contextlib.contextmanager
def _cusolver(device: torch.device):
    """cuSOLVER and cuBLAS for ``inv_ex`` on the card (a MAGMA path may
    wait for the host, which no capture allows), then the caller's
    choice back."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


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
    """The batched ADMM, on ``(B, .)`` vectors: on the CPU, and on the
    card inside :func:`host_driven` or ``graphs.disabled()``, the host's
    loop over :class:`_Loop`'s parts; else the device loop, one graph."""
    b = q.shape[0]
    if q.device.type != "cuda":
        return _Loop(c, b, settings, q.dtype, q.device).host_solve(
            q, l, u, x0, y0)
    loop = _card_loop(c, b, settings, q.dtype, q.device)
    if _HOST_DRIVEN or graphs.is_disabled(loop.solve):
        return loop.host_solve(q, l, u, x0, y0)
    return loop.solve(q, l, u, x0, y0)


def _card_loop(c: QPConstants, b: int, settings: QPSettings, dtype,
               device) -> "_Loop":
    """The :class:`_Loop` of ``b`` members cached on ``c``, its parts
    captured at its first solve. A capture cannot hold another capture,
    so a solve first met inside one raises."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    cache = c.__dict__.setdefault("_loops", {})
    key = (b, dataclasses.astuple(settings), dtype, device)
    if key not in cache:
        if graphs.capturing(device):
            raise RuntimeError(
                f"the QP's device loop for a batch of {b} is built outside a "
                f"capture: solve once before capturing a caller")
        graph_cond.prepare(device)
        loop = _Loop(c, b, settings, dtype, device)
        loop.capture_parts()
        cache[key] = loop
    return cache[key]


class _Loop:
    """The ADMM's carry for a batch of ``b`` solves and the parts that act
    on it in place: :meth:`prepare` (scaling, warm start, a fresh
    status), :meth:`chunk` (``check_every`` iterations, then the check),
    :meth:`refactor_where` (a new rho and factor for the members that
    asked), :meth:`tail` (the iterations after the last check) and
    :meth:`result` (the final residual check, unscaled).

    The chunk leaves three flags on the device: ``go`` (a member still
    running, and a whole chunk left before ``max_iter``), ``refac`` (a
    member to refactor, and iterations left) and ``more`` (a member still
    running, and iterations left: the tail runs). On the card
    :meth:`capture_parts` captures the chunk, the refactorization and
    the tail once; the solve's graph holds

        prepare; WHILE(go) { chunk; IF(refac) { refactor_where } };
        IF(more) { tail }; result

    and :meth:`host_solve` drives the same parts from the host, reading
    the flags once a chunk.

    Implements OSQP's adaptive-rho scheme: when the primal/dual relative
    residual ratio drifts past ``adaptive_rho_threshold``, rho is scaled
    by sqrt(prim_rel / dual_rel) and the KKT matrix is refactorized on the
    device. Each member carries its own rho and factor.
    """

    def __init__(self, c: QPConstants, b: int, settings: QPSettings, dtype,
                 device):
        s = self.s = settings
        self.c, self.b = c, b
        self.m = m = c.A_s.shape[0]
        self.n = n = c.d_scale.shape[0]
        self.ident = s.identity_hessian
        self.adapt = bool(m and s.adaptive_rho)

        def zeros(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=device)

        def scalar(v):
            return torch.tensor(v, dtype=dtype, device=device)

        self.big = scalar(torch.finfo(dtype).max / 4)
        self.zero = scalar(0.0)
        self.inf = scalar(float("inf"))
        self.tiny = scalar(1e-10)
        self.A_t = c.A_s.T
        if not self.ident:
            self.K_base = c.P_s + s.sigma * torch.eye(n, dtype=dtype,
                                                      device=device)
        # the problem, scaled and unscaled
        self.q_s, self.l, self.u = zeros(b, n), zeros(b, m), zeros(b, m)
        self.l_s, self.u_s = zeros(b, m), zeros(b, m)
        # the iterate, the one before it, and the rho and factor
        self.x, self.z, self.y = zeros(b, n), zeros(b, m), zeros(b, m)
        self.xp, self.yp = zeros(b, n), zeros(b, m)
        self.rho, self.factor = zeros(b, m), zeros(b)
        # an inverse comes column-major from LAPACK and cuSOLVER, so the
        # carried inverse is too: a product reads it alike before and
        # after a refactorization
        if self.ident:
            self.s_fac = zeros(b, m, m).transpose(1, 2)
        else:
            self.K = zeros(b, n, n)
            self.K_inv = zeros(b, n, n).transpose(1, 2)
        self.its = zeros(b, dt=torch.int32)
        self.status = zeros(b, dt=torch.int32)
        self.refactors = zeros(b, dt=torch.int32)
        self.need = zeros(b, dt=torch.bool)
        self.it = zeros(dt=torch.int32)
        self.go, self.refac, self.more = (zeros(dt=torch.bool)
                                          for _ in range(3))
        self.fns = {"chunk": self.chunk, "refactor": self.refactor_where,
                    "tail": self.tail}
        self.parts = None          # the captured graphs of ``fns``
        self.solve = graphs.Graphed(self._device_solve, warm=False)

    # ------------------------------------------------------------------
    # the linear algebra
    # ------------------------------------------------------------------
    def kkt_solve(self, K, K_inv, s_fac, rhs):
        c, m, beta = self.c, self.m, 1.0 + self.s.sigma
        if self.ident:
            # Woodbury: (beta I + A' R A)^{-1} = I/beta - A' S^{-1} A / beta^2
            if m:
                return rhs / beta - _mv(self.A_t, _mv(s_fac, _mv(
                    c.A_s, rhs))) / (beta * beta)
            return rhs / beta
        sol = _mv(K_inv, rhs)
        r = rhs - _mv(K, sol)
        return sol + _mv(K_inv, r)  # one refinement step for f32 accuracy

    def residuals(self, x, z, y):
        c, m, b, zero = self.c, self.m, self.b, self.zero
        ax = _mv(c.A_s, x) if m else None
        prim = _amax(torch.abs((ax - z) / c.e_scale)) if m else zero.expand(b)
        px = x / c.c_scale if self.ident else _mv(c.P_s, x)
        aty = _mv(self.A_t, y) if m else torch.zeros_like(x)
        dual = _amax(torch.abs((px + self.q_s + aty) / c.d_scale)) / c.c_scale
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
                    _amax(torch.abs(self.q_s / c.d_scale)),
                ],
                dim=-1,
            )
        ) / c.c_scale
        return prim, dual, denom_p, denom_d

    def check_infeasibility(self, dx, dy):
        c, m, b, s, zero = self.c, self.m, self.b, self.s, self.zero
        eps = s.eps_infeas
        l, u = self.l, self.u
        # primal infeasibility certificate from dy (unscaled: E dy / c)
        if m:
            dy_un = c.e_scale * dy / c.c_scale
            norm_dy = _amax(torch.abs(dy_un))
            aty_dy = _amax(torch.abs(_mv(self.A_t, dy) / c.d_scale
                                     / c.c_scale))
            dy_plus = torch.clamp_min(dy_un, 0.0)
            dy_minus = torch.clamp_max(dy_un, 0.0)
            sup = torch.sum(torch.where(dy_plus > 0, u * dy_plus, zero),
                            dim=-1) + torch.sum(
                torch.where(dy_minus < 0, l * dy_minus, zero), dim=-1)
        else:
            norm_dy = zero.expand(b)
            aty_dy = sup = self.inf.expand(b)
        prim_infeas = (
            (norm_dy > 1e-12)
            & (aty_dy <= eps * norm_dy)
            & (sup <= -eps * norm_dy)
        )
        # dual infeasibility certificate from dx
        dx_un = c.d_scale * dx
        norm_dx = _amax(torch.abs(dx_un))
        pdx_vec = dx / c.c_scale if self.ident else _mv(c.P_s, dx)
        pdx = _amax(torch.abs(pdx_vec / c.d_scale)) / c.c_scale
        qdx = torch.sum((self.q_s / c.d_scale) * dx_un, dim=-1) / c.c_scale
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

    def factorize(self, rho):
        """``(K, K_inv, s_fac)`` for a rho per member; ``inv_ex`` checks
        nothing, so nothing waits for the card."""
        c, m, beta = self.c, self.m, 1.0 + self.s.sigma
        with _cusolver(rho.device):
            if self.ident:
                return None, None, torch.linalg.inv_ex(
                    torch.diag_embed(1.0 / rho) + c.aat / beta)[0]
            K = self.K_base
            if m:
                K = K + torch.bmm(self.A_t.expand(self.b, self.n, m),
                                  rho[:, :, None] * c.A_s)
            return K, torch.linalg.inv_ex(K)[0], None

    # ------------------------------------------------------------------
    # the parts
    # ------------------------------------------------------------------
    def prepare(self, q, l, u, x0, y0) -> None:
        """Scale the problem, warm-start, and reset the counters, rho and
        factor: the carry of a fresh solve."""
        c, m, s = self.c, self.m, self.s
        b = self.b
        self.q_s.copy_(c.c_scale * c.d_scale * q)
        self.l.copy_(l)
        self.u.copy_(u)
        self.l_s.copy_(torch.clamp(c.e_scale * l, -self.big, self.big))
        self.u_s.copy_(torch.clamp(c.e_scale * u, -self.big, self.big))
        # warm start in scaled coordinates
        x = x0 / c.d_scale
        y = (c.c_scale / c.e_scale) * y0 if m else y0
        z = _mv(c.A_s, x) if m else q.new_zeros((b, 0))
        z = torch.clamp(z, self.l_s, self.u_s)
        for dst, src in ((self.x, x), (self.z, z), (self.y, y),
                         (self.xp, x), (self.yp, y)):
            dst.copy_(src)
        self.rho.copy_(c.rho.expand(b, m))
        if self.ident:
            self.s_fac.copy_(c.s_fac.expand(b, m, m))
        else:
            self.K.copy_(c.K.expand(b, self.n, self.n))
            self.K_inv.copy_(c.K_inv.expand(b, self.n, self.n))
        self.its.zero_()
        self.status.fill_(MAX_ITER_REACHED)
        self.refactors.zero_()
        self.it.zero_()
        self.go.fill_(True)
        self.refac.fill_(False)
        self.more.fill_(s.max_iter > 0)

    def iterate(self, steps: int):
        """``steps`` ADMM iterations from the carry; returns the iterate,
        the one before it, and the one before that (the reference's
        carried x_prev, y_prev at its check)."""
        s, m, c = self.s, self.m, self.c
        x, z, y, xp, yp = self.x, self.z, self.y, self.xp, self.yp
        rho = self.rho
        rho_inv = 1.0 / rho if m else rho
        K = K_inv = s_fac = None
        if self.ident:
            s_fac = self.s_fac
        else:
            K, K_inv = self.K, self.K_inv
        for _ in range(steps):
            dx_from, dy_from = xp, yp
            # x-update
            rhs = s.sigma * x - self.q_s
            if m:
                rhs = rhs + _mv(self.A_t, rho * z - y)
            x_t = self.kkt_solve(K, K_inv, s_fac, rhs)
            x_new = s.alpha * x_t + (1 - s.alpha) * x
            if m:
                z_t = _mv(c.A_s, x_t)
                # z_pre carries rho^{-1} y, so the dual update collapses to
                # y_new = rho (z_pre - z_new)  [OSQP Algorithm 1 steps 4-5]
                z_pre = s.alpha * z_t + (1 - s.alpha) * z + rho_inv * y
                z_new = torch.clamp(z_pre, self.l_s, self.u_s)
                y_new = rho * (z_pre - z_new)
            else:
                z_new, y_new = z, y
            xp, yp = x, y
            x, z, y = x_new, z_new, y_new
        return x, z, y, xp, yp, dx_from, dy_from

    def _advance(self, steps: int, check: bool) -> None:
        s, b = self.s, self.b
        running = self.status == MAX_ITER_REACHED
        xs, zs, ys, xps, yps, dx_from, dy_from = self.iterate(steps)

        def keep(new, old):
            mask = running.reshape((b,) + (1,) * (new.dim() - 1))
            return torch.where(mask, new, old)

        self.it.add_(steps)
        self.its.copy_(torch.where(running, self.its + steps, self.its))
        if check:
            status = self.status
            prim_r, dual_r, denom_p, denom_d = self.residuals(xs, zs, ys)
            eps_p = s.eps_abs + s.eps_rel * denom_p
            eps_d = s.eps_abs + s.eps_rel * denom_d
            solved = (prim_r <= eps_p) & (dual_r <= eps_d)
            p_inf, d_inf = self.check_infeasibility(xs - dx_from, ys - dy_from)
            new_status = torch.where(
                solved, SOLVED,
                torch.where(p_inf, PRIMAL_INFEASIBLE,
                            torch.where(d_inf, DUAL_INFEASIBLE, status)),
            ).to(torch.int32)
            self.status.copy_(keep(new_status, status))
            if self.adapt:
                tiny = self.tiny
                prim_rel = prim_r / (denom_p + tiny)
                dual_rel = dual_r / (denom_d + tiny)
                factor = _sqrt(prim_rel / (dual_rel + tiny) + tiny)
                need = running & (self.status == MAX_ITER_REACHED) & (
                    (factor > s.adaptive_rho_threshold)
                    | (factor < 1.0 / s.adaptive_rho_threshold)
                )
                self.factor.copy_(factor)
                self.need.copy_(need)
        # every kept value first: after one step the iterate before it is
        # the carry itself
        kept = [(dst, keep(new, dst)) for dst, new in (
            (self.x, xs), (self.z, zs), (self.y, ys), (self.xp, xps),
            (self.yp, yps))]
        for dst, new in kept:
            dst.copy_(new)
        if check:
            left = self.status == MAX_ITER_REACHED
            left = left.any()
            self.go.copy_(left & (self.it <= s.max_iter - s.check_every))
            self.more.copy_(left & (self.it < s.max_iter))
            if self.adapt:
                self.refac.copy_(self.need.any() & (self.it < s.max_iter))

    def chunk(self) -> None:
        """``check_every`` iterations, the check, and the flags."""
        self._advance(self.s.check_every, True)

    def tail(self) -> None:
        """The ``max_iter % check_every`` iterations after the last whole
        chunk: no check, as ``max_iter`` lands between checks."""
        self._advance(self.s.max_iter % self.s.check_every, False)

    def refactor_where(self) -> None:
        """A new rho, and the factor for it, for each member that asked at
        the last check; the others keep theirs."""
        s = self.s
        new_rho = torch.clamp(self.rho * self.factor[:, None], s.rho_min,
                              s.rho_max)
        K2, K_inv2, s_fac2 = self.factorize(new_rho)
        sel = self.need[:, None]
        self.rho.copy_(torch.where(sel, new_rho, self.rho))
        if self.ident:
            self.s_fac.copy_(torch.where(sel[:, :, None], s_fac2, self.s_fac))
        else:
            self.K.copy_(torch.where(sel[:, :, None], K2, self.K))
            self.K_inv.copy_(torch.where(sel[:, :, None], K_inv2, self.K_inv))
        self.refactors.add_(self.need.to(torch.int32))

    def result(self) -> QPSolution:
        """The final residual check, in case max_iter landed between
        checks, and the solution in unscaled units (new tensors)."""
        c, m, s = self.c, self.m, self.s
        x, z, y = self.x, self.z, self.y
        prim_r, dual_r, denom_p, denom_d = self.residuals(x, z, y)
        status = torch.where(
            (self.status == MAX_ITER_REACHED)
            & (prim_r <= s.eps_abs + s.eps_rel * denom_p)
            & (dual_r <= s.eps_abs + s.eps_rel * denom_d),
            SOLVED,
            self.status,
        ).to(torch.int32)
        return QPSolution(
            x=c.d_scale * x,
            y=(c.e_scale * y / c.c_scale) if m else y.clone(),
            z=(z / c.e_scale) if m else z.clone(),
            status=status,
            iterations=self.its.clone(),
            prim_res=prim_r,
            dual_res=dual_r,
        )

    # ------------------------------------------------------------------
    # the two drivers
    # ------------------------------------------------------------------
    def capture_parts(self) -> None:
        """Run the chunk, the refactorization and the tail once each, then
        capture each as a graph kept for the device loop's clones (on the
        card; outside any capture)."""
        dev = self.x.device
        s = self.s
        names = ["chunk"] + ["refactor"] * self.adapt + [
            "tail"] * bool(s.max_iter % s.check_every)
        self.parts = {}
        for name in names:
            fn = self.fns[name]
            graphs.warm_up(fn, (), {}, dev)
            self.parts[name] = graphs.capture(fn, (), {}, [], dev,
                                              keep_graph=True)[0]

    def _run(self, name: str) -> None:
        """A part on the host's orders: its graph's replay, or the part
        itself on the CPU and under ``graphs.disabled()``."""
        if self.parts is None or graphs.is_disabled(self.solve):
            self.fns[name]()
        else:
            self.parts[name].replay()

    def host_solve(self, q, l, u, x0, y0) -> QPSolution:
        """The loop on the host: one read of the flags a chunk."""
        s = self.s
        self.prepare(q, l, u, x0, y0)
        go, refac, more = True, False, s.max_iter > 0
        if s.max_iter >= s.check_every:
            while go:
                self._run("chunk")
                go, refac, more = torch.stack(
                    [self.go, self.refac, self.more]).tolist()
                if refac:
                    self._run("refactor")
        if s.max_iter % s.check_every and more:
            self._run("tail")
        return self.result()

    def _device_solve(self, q, l, u, x0, y0) -> QPSolution:
        """The solve as one graph, captured (whole, or inline in a
        caller's capture): no read to the host."""
        s = self.s
        self.prepare(q, l, u, x0, y0)
        if s.max_iter >= s.check_every:
            body = [self.parts["chunk"]]
            if self.adapt:
                body.append(graph_cond.If(self.refac,
                                          (self.parts["refactor"],)))
            graph_cond.while_loop(self.go, body)
        if s.max_iter % s.check_every:
            graph_cond.if_then(self.more, [self.parts["tail"]])
        return self.result()
