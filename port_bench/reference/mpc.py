"""The closed loop's MPC, solved exactly in float64, for the comparison.

The same control law as the port's rig, derived again from the
configuration: the plant linearised about its operating point (central
differences, ``reference/plant.py``) and discretised by a zero-order
hold over the control period; states, inputs and outputs cut to the
configuration's subsets; predictions over ``P`` steps of the moves
``d_0 .. d_M`` (``u_j = u_-1 + sum_{i <= j, i < M} d_i``; ``d_M`` only
pays its cost), the ``k``-th prediction carrying ``k`` times the output
bias; cost ``1/2 sum_k |y_k - ysp|_Q^2 + 1/2 sum_i |d_i|_R^2``; the
first move bounded so that ``u_0`` stays within the input bounds.

With bounds on the first move alone, the optimum is the unconstrained
one moved within the first move's coordinates: a quadratic program of
``Ni`` variables, solved here by trying each set of active bounds. The
condensed Hessian (``(M + 1) Ni`` square) is built and factored once on
the device in float64; each event is a few small products on the host.
:meth:`solve` with ``tf32_ops=True`` computes each event's products
from operands rounded to TF32's 10-bit mantissa: the control of the loop
cell's comparison. (The set-up stays float64, as the port's does: its
products from TF32 operands leave the condensed Hessian indefinite.)
"""
from __future__ import annotations

import itertools

import numpy as np
import scipy.linalg
import torch

from port_bench.reference import plant
from port_bench.reference.pf import round_tf32

F64 = torch.float64


def tf32(a) -> np.ndarray:
    """``a`` as a TF32 product reads it (``pf.round_tf32``), float64."""
    return round_tf32(torch.as_tensor(np.asarray(a, dtype=np.float32))
                      ).double().numpy()


class ReferenceMPC:
    def __init__(self, cfg: dict, device="cpu"):
        m = cfg["mpc"]
        pl = cfg["plant"]
        dt = float(m["dt_control"])
        self.P = int(m["horizon_time"] // dt)
        self.M = max(int(m["moves_time"] // dt), 1)
        states, inputs, outputs = m["states"], m["inputs"], m["outputs"]
        u_op = np.asarray(pl["u_op"], dtype=float)
        x_bar = plant.steady_state(u_op, pl["x_guess"])
        a_c, b_c = plant.jacobians(x_bar, u_op)
        nx, ni = a_c.shape[0], b_c.shape[1]
        blk = np.zeros((nx + ni, nx + ni))
        blk[:nx, :nx], blk[:nx, nx:] = a_c, b_c
        e = scipy.linalg.expm(blk * dt)
        a_d, b_d = e[:nx, :nx], e[:nx, nx:]
        c_full = np.diag(plant.MOLAR_MASSES)
        A = a_d[np.ix_(states, states)]
        B = b_d[np.ix_(states, inputs)]
        C = c_full[np.ix_(outputs, states)]
        D = np.zeros((len(outputs), len(inputs)))
        self.x_bar = x_bar[states]
        self.u_bar = u_op[inputs]
        self.y_bar = (x_bar * np.asarray(plant.MOLAR_MASSES))[outputs]
        self.states, self.inputs = list(states), list(inputs)
        self.Ni, self.No = len(inputs), len(outputs)
        lo = np.asarray(m["u_min"], dtype=float) - self.u_bar
        hi = np.asarray(m.get("u_max", [np.inf] * self.Ni), dtype=float) \
            - self.u_bar
        self.u_lo, self.u_hi = lo, hi
        ysp = np.asarray(m["ysp"], dtype=float) - self.y_bar
        self._condense(A, B, C, D, np.asarray(m["Q"], float),
                       np.asarray(m["R"], float), ysp, device)

    def _condense(self, A, B, C, D, Q, R, ysp, device):
        P, M, no, ni = self.P, self.M, self.No, self.Ni
        nx = A.shape[0]
        kw = dict(dtype=F64, device=device)
        At, Bt, Ct, Dt = (torch.as_tensor(v, **kw) for v in (A, B, C, D))
        pows = [torch.eye(nx, **kw)]
        for _ in range(P):
            pows.append(pows[-1] @ At)
        pows = torch.stack(pows)                               # (P+1, nx, nx)
        g = torch.cumsum(pows[:P], dim=0)                      # G_1 .. G_P
        t = Ct @ g @ Bt                                # (P, no, ni)
        f_x = (Ct @ pows[1:]).reshape(P * no, nx)
        f_u = (t + Dt).reshape(P * no, ni)
        k = torch.arange(1, P + 1, **kw)[:, None]
        i = torch.arange(0, M + 1, **kw)[None, :]
        lag = (k - i).long()
        t0 = torch.cat([torch.zeros(1, no, ni, **kw), t])
        mask = ((lag >= 1) & (i < M)).to(F64)
        theta = t0[lag.clamp(0, P)] * mask[..., None, None]
        theta = theta + Dt * (k >= torch.clamp_min(i, 1)).to(F64)[..., None,
                                                                    None]
        theta = theta.permute(0, 2, 1, 3).reshape(P * no, (M + 1) * ni)
        qt = torch.as_tensor(Q, **kw)
        th_q = (qt @ theta.reshape(P, no, -1)).reshape(P * no, -1)  # Qbar Th
        n_d = (M + 1) * ni
        hess = theta.T @ th_q + torch.kron(torch.eye(M + 1, **kw),
                                           torch.as_tensor(R, **kw))
        bias_map = torch.kron(k, torch.eye(no, **kw))          # (P no, no)
        ysp_tile = torch.as_tensor(ysp, **kw).repeat(P)
        rhs = th_q.T @ torch.cat([f_x, f_u, bias_map, ysp_tile[:, None]], 1)
        sel = torch.zeros(n_d, ni, **kw)
        sel[:ni] = torch.eye(ni, **kw)
        low = torch.linalg.cholesky(hess)
        z = torch.cholesky_solve(torch.cat([rhs, sel], 1), low)
        zq, hs = z[:, :rhs.shape[1]], z[:, rhs.shape[1]:]
        theta0 = theta[:no]
        host = lambda v: v.detach().cpu().numpy()
        # d_unc = -(zq @ [x0, um1, bias, -1]); first move and first output
        self.first_move = host(zq[:ni])
        self.first_out = host(theta0 @ zq)
        self.G = host(hs[:ni])
        self.Y = host(theta0 @ hs)
        self.F_x0, self.F_u0 = host(f_x[:no]), host(f_u[:no])

    def solve(self, x0, um1, bias, tf32_ops: bool = False):
        """``(u, y_pred)`` in deviation variables for the estimate's
        deviation ``x0``, the last input's ``um1`` and the bias."""
        rnd = tf32 if tf32_ops else (lambda a: np.asarray(a, dtype=float))
        v = np.concatenate([x0, um1, bias, [-1.0]])
        d0 = -(rnd(self.first_move) @ rnd(v))
        y1m = -(rnd(self.first_out) @ rnd(v))
        G, Y = rnd(self.G), rnd(self.Y)
        lo, hi = self.u_lo - um1, self.u_hi - um1
        lam = self._active_set(d0, G, lo, hi)
        move = d0 + G @ lam
        y1 = (rnd(self.F_x0) @ rnd(x0) + rnd(self.F_u0) @ rnd(um1) + bias
              + y1m + Y @ lam)
        return move + um1, y1 - bias

    @staticmethod
    def _active_set(d0, G, lo, hi):
        """Multipliers ``lam`` of ``min 1/2 (d - d0)' G^-1 (d - d0)``
        subject to ``lo <= d <= hi``, with ``d = d0 + G lam``."""
        n = d0.shape[0]
        best = None
        for act in itertools.product((0, -1, 1), repeat=n):
            idx = [i for i in range(n) if act[i]]
            lam = np.zeros(n)
            if idx:
                b = np.array([lo[i] if act[i] < 0 else hi[i] for i in idx])
                if not np.all(np.isfinite(b)):
                    continue
                lam[idx] = np.linalg.solve(G[np.ix_(idx, idx)], b - d0[idx])
            d = d0 + G @ lam
            viol = (np.maximum(lo - d, 0).sum() + np.maximum(d - hi, 0).sum()
                    + sum(max(-lam[i], 0) for i in idx if act[i] < 0)
                    + sum(max(lam[i], 0) for i in idx if act[i] > 0))
            if best is None or viol < best[0]:
                best = (viol, lam)
        return best[1]
