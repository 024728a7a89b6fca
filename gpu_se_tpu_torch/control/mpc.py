"""Linear MPC on a condensed, whitened, optimum-centered dense QP.

Counterpart of ``gpu_se_tpu/control/mpc.py``. The setup is the
reference's host float64 numpy, line for line, so every host matrix is
bit-equal to the reference's:

1. **Condensation**: the velocity-form recursions are eliminated into
   dense prediction maps over the control moves d = [du_0 .. du_M].
2. **Whitening**: w = L^T d (L = chol of the condensed Hessian) makes the
   Hessian the identity, so the QP takes the Woodbury path of
   :class:`~gpu_se_tpu_torch.control.qp.DenseQP`.
3. **Optimum centering**: w = -q + v makes the objective (1/2)||v||^2;
   the linear cost's effect on the bounds and the controls enters
   through small maps precomposed in float64 (``compose``) and applied on
   the host each step.

Only ``A_s``, the Woodbury factor and the two maps from ``v`` to the
first control move and the first predicted output reach the device, as
float32. ``MPC.step`` reads the solve back once per step (status,
residuals, control and prediction in one transfer) and keeps the
reference's contract: the ±1e10 clamp of its inputs, the output bias
(``y0 - y_predicted``), the acceptance of a max-iteration stop whose
residuals are below max(10 eps_abs, 1e-4) (the reference's "near-solved"
rule, kept as it is; ``last_solution`` holds the solve), and a
``ValueError`` on any other status. ``make_device_step`` is the
all-device float32 step of the on-device loop.

Rows whose bounds are infinite on both sides are pruned at setup (the
canonical rig has no output or step bounds, so its per-step QP carries
only the Ni input rows).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import numpy as np
import scipy.linalg
import torch

from gpu_se_tpu_torch.control.qp import (
    MAX_ITER_REACHED,
    SOLVED,
    DenseQP,
    QPSettings,
    QPSolution,
    _admm_solve,
    _f32_matmul,
    _mv,
)
from gpu_se_tpu_torch.models.linear import LinearModel


def build_prediction_matrices(lin: LinearModel, P: int, M: int):
    """Condense the velocity-form recursions into dense prediction maps.

    Returns
    -------
    F_x : (P*No, Nx)   y_free state part: row block k is C A^k
    F_u : (P*No, Ni)   u_-1 part: C G_k B + D
    Theta : (P*No, (M+1)*Ni)  control-move map (see module docstring)
    k_vec : (P,)       bias multipliers (y_k carries k * bias)
    """
    A, B, C, D = lin.A, lin.B, lin.C, lin.D
    nx, ni, no = lin.Nx, lin.Ni, lin.No

    a_pows = np.empty((P + 1, nx, nx))
    a_pows[0] = np.eye(nx)
    for k in range(1, P + 1):
        a_pows[k] = a_pows[k - 1] @ A
    g = np.cumsum(a_pows[:P], axis=0)  # g[k-1] = G_k = I + A + ... + A^{k-1}

    F_x = np.einsum("oy,kyx->kox", C, a_pows[1:]).reshape(P * no, nx)

    t = np.einsum("oy,kyx,xi->koi", C, g, B)  # t[k-1] = C G_k B
    F_u = (t + D[None]).reshape(P * no, ni)

    # Theta[k, i] for k = 1..P (row), i = 0..M (col block):
    #   i = 0:       C G_k B + D
    #   1 <= i < M:  C G_{k-i} B * [k > i]  +  D * [k >= i]
    #   i = M:       D * [k >= M]
    ks = np.arange(1, P + 1)[:, None]
    is_ = np.arange(0, M + 1)[None, :]
    lag = ks - is_
    state_mask = (lag >= 1) & (is_ < M)
    t_full = np.concatenate([np.zeros((1, no, ni)), t])
    theta = t_full[np.clip(lag, 0, P)] * state_mask[..., None, None]
    d_mask = ks >= np.maximum(is_, 1)
    theta = theta + D[None, None] * d_mask[..., None, None]
    theta = theta.transpose(0, 2, 1, 3).reshape(P * no, (M + 1) * ni)

    k_vec = np.arange(1, P + 1, dtype=float)
    return F_x, F_u, theta, k_vec


class MPC:
    """Linear MPC with the reference constructor surface; its device
    tensors live on ``device``, the card unless the caller passes
    ``device="cpu"``."""

    def __init__(
        self,
        P,
        M,
        Q,
        R,
        lin_model: LinearModel,
        ysp,
        y_bounds=None,
        u_bounds=None,
        u_step_bounds=None,
        qp_settings: Optional[QPSettings] = None,
        device="cuda",
    ):
        self.P, self.M = int(P), int(M)
        self.Q = np.atleast_2d(np.asarray(Q, float))
        self.R = np.atleast_2d(np.asarray(R, float))
        self.model = lin_model
        self.ysp = np.asarray(ysp, float)

        nx, ni, no = lin_model.Nx, lin_model.Ni, lin_model.No
        self.Nx, self.Ni, self.No = nx, ni, no
        n_d = (self.M + 1) * ni

        def unpack(bounds, dim):
            if bounds is None:
                return np.full(dim, -np.inf), np.full(dim, np.inf)
            lo, hi = [np.asarray(b, float) for b in zip(*bounds)]
            return lo, hi

        y_min, y_max = unpack(y_bounds, no)
        u_min, u_max = unpack(u_bounds, ni)
        du_min, du_max = unpack(u_step_bounds, ni)

        F_x, F_u, theta, k_vec = build_prediction_matrices(lin_model, self.P, self.M)

        # cost: (1/2) d' (Th' Qbar Th + Rbar) d + (y_free - ysp)' Qbar Th d
        # with Qbar = I_P (x) Q applied blockwise (Q symmetric).
        theta_r = theta.reshape(self.P, no, n_d)
        theta_t_q = (
            np.einsum("oy,kyn->kon", self.Q, theta_r).reshape(self.P * no, n_d).T
        )  # (n_d, P*No) = Th' Qbar
        r_blocks = np.kron(np.eye(self.M + 1), self.R)
        P_qp = theta_t_q @ theta + r_blocks

        # ---- whitening: w = L^T d, Hessian -> I ----
        ridge = 1e-12 * max(np.trace(P_qp) / n_d, 1.0)
        try:
            L = np.linalg.cholesky(P_qp)
        except np.linalg.LinAlgError:
            L = np.linalg.cholesky(P_qp + ridge * np.eye(n_d))
        L_invT = scipy.linalg.solve_triangular(L, np.eye(n_d), lower=True).T
        W = L_invT.T @ theta_t_q  # (n_d, P*No): q = W (y_free - ysp_tile)

        # constraint rows in w coordinates; prune all-infinite blocks
        self._has_y_rows = np.isfinite(y_min).any() or np.isfinite(y_max).any()
        self._has_du_rows = np.isfinite(du_min).any() or np.isfinite(du_max).any()
        self._has_u0_rows = np.isfinite(u_min).any() or np.isfinite(u_max).any()

        a_rows = []
        if self._has_y_rows:
            a_rows.append(theta @ L_invT)
        if self._has_du_rows:
            a_rows.append(L_invT)
        if self._has_u0_rows:
            a_rows.append(L_invT[:ni])
        A_qp = np.vstack(a_rows) if a_rows else np.zeros((0, n_d))
        m = A_qp.shape[0]

        l_rep = np.concatenate(
            ([np.tile(y_min, self.P)] if self._has_y_rows else [])
            + ([np.tile(du_min, self.M + 1)] if self._has_du_rows else [])
            + ([u_min] if self._has_u0_rows else [])
        ) if a_rows else np.zeros(0)
        u_rep = np.concatenate(
            ([np.tile(y_max, self.P)] if self._has_y_rows else [])
            + ([np.tile(du_max, self.M + 1)] if self._has_du_rows else [])
            + ([u_max] if self._has_u0_rows else [])
        ) if a_rows else np.zeros(0)

        if qp_settings is None:
            qp_settings = QPSettings(eps_abs=1e-6, eps_rel=1e-6, max_iter=10000)
        self.qp = DenseQP(
            np.eye(n_d), A_qp, l_rep, u_rep, np.zeros(n_d), settings=qp_settings,
            device=device,
        )

        # ---- optimum centering: w = -q + v ------------------------------
        # Precompose (float64) every map through q so the large vector q
        # never materializes. For any matrix S (rows x n_d):
        #   S q = SQ_x x0 + SQ_u um1 + SQ_b bias - sq_0
        # with SQ_x = S W F_x, SQ_u = S W F_u, SQ_b = S W_b, sq_0 = S W ysp.
        W_b = (
            W.reshape(n_d, self.P, no) * k_vec[None, :, None]
        ).sum(axis=1)  # (n_d, No): W @ kron(k_vec, .)
        ysp_tile = np.tile(self.ysp, self.P)

        def compose(S):
            SW = S @ W
            return (
                SW @ F_x,
                SW @ F_u,
                S @ W_b,
                SW @ ysp_tile,
            )

        ctrl_map = L_invT[:ni]  # du_0 = ctrl_map @ w
        theta0_w = theta[:no] @ L_invT  # y_1 move part
        self._h = dict(
            A_q=compose(A_qp) if m else None,
            ctrl_q=compose(ctrl_map),
            y1_q=compose(theta0_w),
            F_x0=F_x[:no],
            F_u0=F_u[:no],
            F_x=F_x,
            F_u=F_u,
            k_vec=k_vec,
            ysp_tile=ysp_tile,
            y_lo=np.tile(y_min, self.P),
            y_hi=np.tile(y_max, self.P),
            du_lo=np.tile(du_min, self.M + 1),
            du_hi=np.tile(du_max, self.M + 1),
            u_lo=u_min,
            u_hi=u_max,
        )

        dt = self.qp.settings.dtype
        dev = self.qp.device
        self._consts = dict(
            qp=self.qp.consts,
            ctrl_map=torch.as_tensor(ctrl_map, dtype=dt, device=dev),
            theta0_w=torch.as_tensor(theta0_w, dtype=dt, device=dev),
        )

        self._warm_v = torch.zeros(n_d, dtype=dt, device=dev)
        self._warm_y = torch.zeros(m, dtype=dt, device=dev)
        self.reset()

    def to(self, device) -> "MPC":
        """This MPC with its device constants on ``device``, reset: the
        float64 host setup is shared, not rebuilt."""
        new = copy.copy(self)
        new.qp = self.qp.to(device)
        dev = new.qp.device
        new._consts = dict(qp=new.qp.consts,
                           ctrl_map=self._consts["ctrl_map"].to(dev),
                           theta0_w=self._consts["theta0_w"].to(dev))
        new._warm_v, new._warm_y = self._warm_v.to(dev), self._warm_y.to(dev)
        new.reset()
        return new

    def reset(self):
        """Forget the steps taken: no prediction, no last solution, a
        zero warm start; the next step is solved as the first."""
        self.y_predicted = None
        self.last_solution = None
        self._warm_v = torch.zeros_like(self._warm_v)
        self._warm_y = torch.zeros_like(self._warm_y)

    # ------------------------------------------------------------------
    def _host_prepare(self, x0, um1, bias):
        """Float64 host preprocessing: bound shifts and unconstrained
        offsets (tiny matvecs — microseconds)."""
        h = self._h

        def through_q(parts):
            qx, qu, qb, q0 = parts
            return qx @ x0 + qu @ um1 + qb @ bias - q0

        l_parts, u_parts = [], []
        if self._has_y_rows:
            y_free = h["F_x"] @ x0 + h["F_u"] @ um1 + np.kron(h["k_vec"], bias)
            l_parts.append(h["y_lo"] - y_free)
            u_parts.append(h["y_hi"] - y_free)
        if self._has_du_rows:
            l_parts.append(h["du_lo"])
            u_parts.append(h["du_hi"])
        if self._has_u0_rows:
            l_parts.append(h["u_lo"] - um1)
            u_parts.append(h["u_hi"] - um1)

        if l_parts:
            aq = through_q(h["A_q"])
            l = np.concatenate(l_parts) + aq
            u = np.concatenate(u_parts) + aq
        else:
            l = np.zeros(0)
            u = np.zeros(0)

        ctrl_unc = -through_q(h["ctrl_q"]) + um1  # du_0(-q) + um1
        y1_unc = h["F_x0"] @ x0 + h["F_u0"] @ um1 + bias - through_q(h["y1_q"])
        return l, u, ctrl_unc, y1_unc

    # ------------------------------------------------------------------
    def step(self, x0, um1, y0):
        """Return the MPC control move; raises ValueError if the solver
        fails (the caller falls back)."""
        clip = lambda v: np.clip(np.asarray(v, float), -1e10, 1e10)
        x0, um1, y0 = clip(x0), clip(um1), clip(y0)

        if self.y_predicted is not None:
            bias = y0 - self.y_predicted
        else:
            bias = np.zeros_like(y0)

        l, u, ctrl_unc, y1_unc = self._host_prepare(x0, um1, bias)
        dt, dev = self.qp.settings.dtype, self.qp.device
        c = self._consts
        v0 = self._warm_v
        sol = _admm_solve(
            c["qp"], torch.zeros_like(v0),
            torch.as_tensor(l, dtype=dt, device=dev),
            torch.as_tensor(u, dtype=dt, device=dev), v0, self._warm_y,
            self.qp.settings,
        )
        ctrl, y1_move = _extract(c, sol.x)
        self.last_solution = sol
        # the step's one read: status, residuals, control and prediction
        host = torch.cat([
            torch.stack([sol.status.to(dt), sol.prim_res, sol.dual_res]),
            ctrl, y1_move,
        ]).cpu().numpy()
        status = int(host[0])
        prim_res, dual_res = host[1], host[2]
        ctrl, y1_move = host[3:3 + self.Ni], host[3 + self.Ni:]
        if status != SOLVED:
            # the reference's "solved inaccurate" acceptance: a max-iter
            # stop whose residuals meet max(10 eps_abs, the class default
            # 1e-4) counts as solved
            eps = max(10.0 * self.qp.settings.eps_abs, QPSettings.eps_abs)
            near = (
                status == MAX_ITER_REACHED
                and float(prim_res) < eps
                and float(dual_res) < eps
            )
            if not near:
                raise ValueError(
                    f"QP solver did not solve the problem! Status: {status}")

        self._warm_v, self._warm_y = sol.x, sol.y
        ctrl_full = ctrl_unc + np.asarray(ctrl, float)
        self.y_predicted = y1_unc + np.asarray(y1_move, float) - bias
        return ctrl_full


def _extract(consts, v):
    """The v-dependent parts of the first control move and the first
    predicted output, on the device."""
    with _f32_matmul():
        return consts["ctrl_map"] @ v, consts["theta0_w"] @ v


# ----------------------------------------------------------------------
# The all-device step of the on-device loop: float32 end to end.
# ----------------------------------------------------------------------
def make_device_step(mpc: "MPC"):
    """Return ``(consts, step_fn)`` where ``step_fn(consts, x0, um1, bias,
    warm_v, warm_y) -> (ctrl, y_pred, sol)`` runs entirely on the MPC's
    device, in float32, on one set of vectors or on a batch of them."""
    h = mpc._h
    dt, device = mpc.qp.settings.dtype, mpc.qp.device

    def dev(x):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

    consts = dict(
        qp=mpc.qp.consts,
        ctrl_map=mpc._consts["ctrl_map"],
        theta0_w=mpc._consts["theta0_w"],
        A_q=tuple(dev(p) for p in h["A_q"]) if h["A_q"] is not None else None,
        ctrl_q=tuple(dev(p) for p in h["ctrl_q"]),
        y1_q=tuple(dev(p) for p in h["y1_q"]),
        F_x0=dev(h["F_x0"]),
        F_u0=dev(h["F_u0"]),
        F_x=dev(h["F_x"]) if mpc._has_y_rows else None,
        F_u=dev(h["F_u"]) if mpc._has_y_rows else None,
        k_vec=dev(h["k_vec"]) if mpc._has_y_rows else None,
        y_lo=dev(h["y_lo"]) if mpc._has_y_rows else None,
        y_hi=dev(h["y_hi"]) if mpc._has_y_rows else None,
        du_lo=dev(h["du_lo"]) if mpc._has_du_rows else None,
        du_hi=dev(h["du_hi"]) if mpc._has_du_rows else None,
        u_lo=dev(h["u_lo"]) if mpc._has_u0_rows else None,
        u_hi=dev(h["u_hi"]) if mpc._has_u0_rows else None,
    )
    has_y, has_du, has_u0 = mpc._has_y_rows, mpc._has_du_rows, mpc._has_u0_rows
    settings = mpc.qp.settings

    def step_fn(c, x0, um1, bias, warm_v, warm_y):
        """One solve on vectors, or a batch of solves when every input
        has a leading batch axis: each member's products are per-member
        ``bmm`` calls, so a member equals its single solve bit for bit."""
        single = x0.dim() == 1
        if single:
            x0, um1, bias, warm_v, warm_y = (
                t.unsqueeze(0) for t in (x0, um1, bias, warm_v, warm_y))
        with _f32_matmul():
            ctrl, y_pred, sol = _step(c, x0, um1, bias, warm_v, warm_y)
        if single:
            ctrl, y_pred = ctrl[0], y_pred[0]
            sol = QPSolution(*(getattr(sol, f.name)[0]
                               for f in dataclasses.fields(sol)))
        return ctrl, y_pred, sol

    def _step(c, x0, um1, bias, warm_v, warm_y):
        b = x0.shape[0]

        def through_q(parts):
            qx, qu, qb, q0 = parts
            return _mv(qx, x0) + _mv(qu, um1) + _mv(qb, bias) - q0

        l_parts, u_parts = [], []
        if has_y:
            y_free = _mv(c["F_x"], x0) + _mv(c["F_u"], um1) + (
                c["k_vec"][None, :, None] * bias[:, None, :]).reshape(b, -1)
            l_parts.append(c["y_lo"] - y_free)
            u_parts.append(c["y_hi"] - y_free)
        if has_du:
            l_parts.append(c["du_lo"].expand(b, -1))
            u_parts.append(c["du_hi"].expand(b, -1))
        if has_u0:
            l_parts.append(c["u_lo"] - um1)
            u_parts.append(c["u_hi"] - um1)
        if l_parts:
            aq = through_q(c["A_q"])
            l = torch.cat(l_parts, dim=1) + aq
            u = torch.cat(u_parts, dim=1) + aq
        else:
            l = x0.new_zeros((b, 0))
            u = x0.new_zeros((b, 0))

        sol = _admm_solve(c["qp"], torch.zeros_like(warm_v), l, u, warm_v,
                          warm_y, settings)
        ctrl = -through_q(c["ctrl_q"]) + um1 + _mv(c["ctrl_map"], sol.x)
        y1 = _mv(c["F_x0"], x0) + _mv(c["F_u0"], um1) + bias - through_q(
            c["y1_q"]) + _mv(c["theta0_w"], sol.x)
        return ctrl, y1 - bias, sol

    return consts, step_fn
