"""Scenario MPC: one shared first move, per-scenario predictions and
constraints.

Counterpart of ``gpu_se_tpu/control/scenario_mpc.py``. Given S
disturbance scenarios ``(x0_s, bias_s)`` of one linear velocity-form
model, choose the control moves

    D = [du_0 ; du^1_{1..M} ; ... ; du^S_{1..M}]

minimizing the scenario average of the condensed MPC cost subject to
every scenario's constraints: du_0 is common to all scenarios
(non-anticipativity), later moves may recourse per scenario. With no
constraint binding, the linear model makes the scenario solution the
solve at the scenario mean (certainty equivalence); an outlier scenario
pressing an output bound makes the shared du_0 hedge.

The host setup is the reference's float64 numpy and scipy, line for
line, over the port's :func:`build_prediction_matrices`, so every host
array is bit-equal to the reference's. The device side is the port's
:class:`DenseQP`, on ``device`` (the card unless the caller passes
``device="cpu"``). Two solvers share the condensed data:

* :class:`ScenarioMPC`: the exact stacked QP, its block-arrow Hessian
  (du_0 couples to every scenario block) whitened to the identity at
  setup, so the solve takes the Woodbury path as the nominal MPC's does;
* :func:`consensus_consts` with
  :func:`gpu_se_tpu_torch.parallel.scenario.make_consensus_scenario_step`:
  consensus ADMM over the scenarios, each solving its own proximal QP
  with du_0 tied to the consensus value, all in one batched solve.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.linalg
import torch

from gpu_se_tpu_torch.control.mpc import build_prediction_matrices
from gpu_se_tpu_torch.control.qp import SOLVED, DenseQP, QPSettings
from gpu_se_tpu_torch.models.linear import LinearModel


def _unpack_bounds(bounds, dim):
    if bounds is None:
        return np.full(dim, -np.inf), np.full(dim, np.inf)
    lo, hi = [np.asarray(b, float) for b in zip(*bounds)]
    return lo, hi


@dataclasses.dataclass
class _CondensedData:
    """Per-scenario condensed cost and constraint data (float64 host)."""

    F_x: np.ndarray
    F_u: np.ndarray
    theta: np.ndarray
    k_vec: np.ndarray
    theta_t_q: np.ndarray  # (n_d, P*No): q_s = theta_t_q @ (y_free_s - ysp_tile)
    P_dd: np.ndarray  # (n_d, n_d) condensed Hessian
    ysp_tile: np.ndarray
    y_lo: np.ndarray
    y_hi: np.ndarray
    du_lo: np.ndarray
    du_hi: np.ndarray
    u_lo: np.ndarray
    u_hi: np.ndarray
    has_y: bool
    has_du: bool
    has_u0: bool


def condense(lin: LinearModel, P: int, M: int, Q, R, ysp,
             y_bounds=None, u_bounds=None, u_step_bounds=None) -> _CondensedData:
    """The nominal cost's condensation, shared by every scenario."""
    Q = np.atleast_2d(np.asarray(Q, float))
    R = np.atleast_2d(np.asarray(R, float))
    ni, no = lin.Ni, lin.No
    n_d = (M + 1) * ni
    F_x, F_u, theta, k_vec = build_prediction_matrices(lin, P, M)
    theta_r = theta.reshape(P, no, n_d)
    theta_t_q = np.einsum("oy,kyn->kon", Q, theta_r).reshape(P * no, n_d).T
    P_dd = theta_t_q @ theta + np.kron(np.eye(M + 1), R)
    y_lo, y_hi = _unpack_bounds(y_bounds, no)
    du_lo, du_hi = _unpack_bounds(u_step_bounds, ni)
    u_lo, u_hi = _unpack_bounds(u_bounds, ni)
    return _CondensedData(
        F_x=F_x, F_u=F_u, theta=theta, k_vec=k_vec, theta_t_q=theta_t_q,
        P_dd=P_dd, ysp_tile=np.tile(np.asarray(ysp, float), P),
        y_lo=np.tile(y_lo, P), y_hi=np.tile(y_hi, P),
        du_lo=du_lo, du_hi=du_hi, u_lo=u_lo, u_hi=u_hi,
        has_y=np.isfinite(y_lo).any() or np.isfinite(y_hi).any(),
        has_du=np.isfinite(du_lo).any() or np.isfinite(du_hi).any(),
        has_u0=np.isfinite(u_lo).any() or np.isfinite(u_hi).any(),
    )


def _chol_whiten(H: np.ndarray):
    """Return ``(L, L^{-T})`` with a trace-scaled ridge fallback."""
    n = H.shape[0]
    ridge = 1e-12 * max(np.trace(H) / n, 1.0)
    try:
        L = np.linalg.cholesky(H)
    except np.linalg.LinAlgError:
        L = np.linalg.cholesky(H + ridge * np.eye(n))
    L_invT = scipy.linalg.solve_triangular(L, np.eye(n), lower=True).T
    return L, L_invT


class ScenarioMPC:
    """Exact multi-scenario MPC: the stacked condensed QP with a shared
    du_0.

    Parameters mirror :class:`~gpu_se_tpu_torch.control.mpc.MPC` plus
    ``n_scenarios``. ``step(x0s, um1, biases)`` solves for the shared
    first move over the scenario rows ``x0s (S, Nx)`` and ``biases (S,
    No)`` and returns ``(ctrl, y1_preds)``, ``y1_preds (S, No)`` each
    scenario's one-step-ahead output prediction (bias-corrected, as
    ``MPC.y_predicted``). It raises ``ValueError`` on any status but
    solved.
    """

    def __init__(self, P, M, Q, R, lin_model: LinearModel, ysp, n_scenarios,
                 y_bounds=None, u_bounds=None, u_step_bounds=None,
                 qp_settings: Optional[QPSettings] = None, device="cuda"):
        self.P, self.M, self.S = int(P), int(M), int(n_scenarios)
        self.model = lin_model
        ni, no = lin_model.Ni, lin_model.No
        self.Ni, self.No = ni, no
        cd = condense(lin_model, self.P, self.M, Q, R, ysp,
                      y_bounds, u_bounds, u_step_bounds)
        self._cd = cd
        S, n_d = self.S, (self.M + 1) * ni
        nm = self.M * ni
        n_D = ni + S * nm
        self.n_D = n_D

        # --- block-arrow stacked Hessian (scenario-average cost) ---------
        P00 = cd.P_dd[:ni, :ni]
        P0m = cd.P_dd[:ni, ni:]
        Pmm = cd.P_dd[ni:, ni:]
        H = np.zeros((n_D, n_D))
        H[:ni, :ni] = P00
        for s in range(S):
            blk = slice(ni + s * nm, ni + (s + 1) * nm)
            H[:ni, blk] = P0m / S
            H[blk, :ni] = P0m.T / S
            H[blk, blk] = Pmm / S

        L, L_invT = _chol_whiten(H)
        self._L, self._L_invT = L, L_invT

        # --- stacked constraints, rows in w = L^T D coordinates ----------
        # scenario selector: d_s = [du_0; m_s] = E_s D
        def sel(s):
            E = np.zeros((n_d, n_D))
            E[:ni, :ni] = np.eye(ni)
            E[ni:, ni + s * nm: ni + (s + 1) * nm] = np.eye(nm)
            return E

        a_rows, l_rows, u_rows = [], [], []
        if cd.has_y:
            for s in range(S):
                a_rows.append(cd.theta @ sel(s))
                l_rows.append(np.full(self.P * no, -np.inf))  # pattern only
                u_rows.append(np.full(self.P * no, np.inf))
        if cd.has_du:
            # du_0 once + each scenario's recourse moves
            a_rows.append(sel(0)[:ni])
            l_rows.append(cd.du_lo)
            u_rows.append(cd.du_hi)
            for s in range(S):
                a_rows.append(sel(s)[ni:])
                l_rows.append(np.tile(cd.du_lo, self.M))
                u_rows.append(np.tile(cd.du_hi, self.M))
        if cd.has_u0:
            a_rows.append(sel(0)[:ni])
            l_rows.append(cd.u_lo)  # pattern
            u_rows.append(cd.u_hi)
        A_D = np.vstack(a_rows) if a_rows else np.zeros((0, n_D))
        A_w = A_D @ L_invT
        self.m = A_D.shape[0]

        if qp_settings is None:
            qp_settings = QPSettings(eps_abs=1e-6, eps_rel=1e-6, max_iter=20000)
        self.qp = DenseQP(
            np.eye(n_D), A_w,
            np.concatenate(l_rows) if l_rows else None,
            np.concatenate(u_rows) if u_rows else None,
            settings=qp_settings, device=device,
        )
        dt, dev = self.qp.settings.dtype, self.qp.device
        self._warm_w = torch.zeros(n_D, dtype=dt, device=dev)
        self._warm_y = torch.zeros(self.m, dtype=dt, device=dev)

    # ------------------------------------------------------------------
    def _y_free(self, x0s, um1, biases):
        """Free response per scenario: F_x x0_s + F_u u_-1 + k*bias_s
        (the k*bias term is the velocity form's integral action)."""
        cd = self._cd
        bias_terms = np.einsum("k,so->sko", cd.k_vec, biases)
        return (
            x0s @ cd.F_x.T
            + (cd.F_u @ um1)[None, :]
            + bias_terms.reshape(x0s.shape[0], -1)
        )

    def step(self, x0s, um1, biases):
        cd = self._cd
        S, ni, no = self.S, self.Ni, self.No
        nm = self.M * ni
        x0s = np.clip(np.asarray(x0s, float), -1e10, 1e10)
        um1 = np.clip(np.asarray(um1, float), -1e10, 1e10)
        biases = np.clip(np.asarray(biases, float), -1e10, 1e10)
        if x0s.shape[0] != S or biases.shape[0] != S:
            raise ValueError(f"expected {S} scenario rows, got x0s "
                             f"{x0s.shape} and biases {biases.shape}")

        y_free = self._y_free(x0s, um1, biases)  # (S, P*No)
        qs = (y_free - cd.ysp_tile[None, :]) @ cd.theta_t_q.T  # (S, n_d)

        q_D = np.zeros(self.n_D)
        q_D[:ni] = qs[:, :ni].mean(axis=0)
        for s in range(S):
            q_D[ni + s * nm: ni + (s + 1) * nm] = qs[s, ni:] / S
        q_w = scipy.linalg.solve_triangular(self._L, q_D, lower=True)

        l_parts, u_parts = [], []
        if cd.has_y:
            for s in range(S):
                l_parts.append(cd.y_lo - y_free[s])
                u_parts.append(cd.y_hi - y_free[s])
        if cd.has_du:
            l_parts.append(cd.du_lo)
            u_parts.append(cd.du_hi)
            for _ in range(S):
                l_parts.append(np.tile(cd.du_lo, self.M))
                u_parts.append(np.tile(cd.du_hi, self.M))
        if cd.has_u0:
            l_parts.append(cd.u_lo - um1)
            u_parts.append(cd.u_hi - um1)
        l = np.concatenate(l_parts) if l_parts else np.zeros(0)
        u = np.concatenate(u_parts) if u_parts else np.zeros(0)

        sol = self.qp.solve(q_w, l, u, self._warm_w, self._warm_y)
        self.last_solution = sol
        # the step's one read: the status and the solution
        host = torch.cat([sol.status.to(sol.x.dtype)[None], sol.x]).cpu()
        status = int(host[0])
        if status != SOLVED:
            raise ValueError(
                f"QP solver did not solve the problem! Status: {status}"
            )
        self._warm_w, self._warm_y = sol.x, sol.y
        D = self._L_invT @ host[1:].numpy().astype(float)
        du0 = D[:ni]

        # per-scenario y_1 prediction (MPC semantics: y_predicted = y_1 -
        # bias; y_free's k=1 row already carries 1*bias)
        y1 = np.empty((S, no))
        for s in range(S):
            d_s = np.concatenate([du0, D[ni + s * nm: ni + (s + 1) * nm]])
            y1[s] = y_free[s, :no] + cd.theta[:no] @ d_s
        return du0 + um1, y1 - biases

    def last_moves(self):
        """The last solve's shared first move and each scenario's moves,
        ``(du0 (Ni,), moves (S, M, Ni))``, for tests and analysis."""
        ni = self.Ni
        D = self._L_invT @ self.last_solution.x.cpu().numpy().astype(float)
        du0 = D[:ni]
        return du0, D[ni:].reshape(self.S, self.M, ni)


# ----------------------------------------------------------------------
# Consensus-ADMM device constants (consumed by parallel.scenario)
# ----------------------------------------------------------------------
def consensus_consts(lin: LinearModel, P: int, M: int, Q, R, ysp,
                     y_bounds=None, u_bounds=None, u_step_bounds=None,
                     rho_consensus: Optional[float] = None,
                     qp_settings: Optional[QPSettings] = None,
                     device="cuda"):
    """Build the per-scenario proximal QP family for consensus ADMM.

    Each scenario subproblem is
        min (1/2) d' P_dd d + q_s' d + (rho_c/2) ||d_0 - v_s||^2
        s.t. per-scenario bounds,
    whitened once against P_aug = P_dd + rho_c E0'E0 so the solves take
    the identity-Hessian Woodbury path.

    Returns ``(consts, settings, dims)``: ``consts`` a dict of float32
    tensors on ``device`` (its ``qp`` entry the :class:`QPConstants`),
    ``dims`` the sizes.
    """
    cd = condense(lin, P, M, Q, R, ysp, y_bounds, u_bounds, u_step_bounds)
    ni = lin.Ni
    n_d = (M + 1) * ni
    if rho_consensus is None:
        rho_consensus = float(np.trace(cd.P_dd[:ni, :ni]) / ni)

    P_aug = cd.P_dd.copy()
    P_aug[:ni, :ni] += rho_consensus * np.eye(ni)
    L, L_invT = _chol_whiten(P_aug)
    L_inv = L_invT.T

    a_rows, l_pat, u_pat = [], [], []
    if cd.has_y:
        a_rows.append(cd.theta)
        l_pat.append(np.full(cd.theta.shape[0], -np.inf))
        u_pat.append(np.full(cd.theta.shape[0], np.inf))
    if cd.has_du:
        a_rows.append(np.eye(n_d))
        l_pat.append(np.tile(cd.du_lo, M + 1))
        u_pat.append(np.tile(cd.du_hi, M + 1))
    if cd.has_u0:
        a_rows.append(np.eye(ni, n_d))
        l_pat.append(cd.u_lo)
        u_pat.append(cd.u_hi)
    A_d = np.vstack(a_rows) if a_rows else np.zeros((0, n_d))
    A_w = A_d @ L_invT

    if qp_settings is None:
        qp_settings = QPSettings(eps_abs=1e-6, eps_rel=1e-6, max_iter=20000)
    qp = DenseQP(
        np.eye(n_d), A_w,
        np.concatenate(l_pat) if l_pat else None,
        np.concatenate(u_pat) if u_pat else None,
        settings=qp_settings, device=device,
    )
    dt, dev = qp.settings.dtype, qp.device

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    consts = dict(
        qp=qp.consts,
        F_x=t(cd.F_x),
        F_u=t(cd.F_u),
        k_vec=t(cd.k_vec),
        theta_t_q=t(cd.theta_t_q),
        ysp_tile=t(cd.ysp_tile),
        L_inv=t(L_inv),
        L_invT=t(L_invT),
        y_lo=t(cd.y_lo) if cd.has_y else None,
        y_hi=t(cd.y_hi) if cd.has_y else None,
        du_lo=t(np.tile(cd.du_lo, M + 1)) if cd.has_du else None,
        du_hi=t(np.tile(cd.du_hi, M + 1)) if cd.has_du else None,
        u_lo=t(cd.u_lo) if cd.has_u0 else None,
        u_hi=t(cd.u_hi) if cd.has_u0 else None,
        rho_c=t(rho_consensus),
    )
    dims = dict(
        n_d=n_d, ni=ni, m=qp.m, has_y=cd.has_y, has_du=cd.has_du,
        has_u0=cd.has_u0, P=P, M=M,
    )
    return consts, qp.settings, dims
