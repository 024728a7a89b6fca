"""Closed-loop simulation harness: the canonical bioreactor rig.

Counterpart of ``gpu_se_tpu/sim/harness.py``: ``get_parts`` builds the
plant, linear model, MPC and filter; ``get_noise`` the canonical noise
mixtures; ``performance`` the time-weighted ISE; ``Simulation`` the event
loop with independent predict and control timers.

The plant integrates on the host in float64 numpy; the filter and the
MPC's QP run on ``device``, the card unless the caller passes
``device="cpu"``. The plant noise is drawn for the whole horizon up
front from ``torch.Generator``s seeded ``seed + 101`` and ``seed + 202``
(the reference draws it with JAX keys; the streams differ). The fully
on-device loop is ``gpu_se_tpu_torch.sim.loop``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.integrate
import torch

from gpu_se_tpu_torch.control import MPC
from gpu_se_tpu_torch.distributions import (
    DeterministicGaussianSum,
    MultivariateGaussianSum,
)
from gpu_se_tpu_torch.filters import (
    GaussianSumUnscentedKalmanFilter,
    ParticleFilter,
)
from gpu_se_tpu_torch.models import Bioreactor, create_linear_model
from gpu_se_tpu_torch.models.bioreactor import static_outputs

# The MPC's output and input weights (Cg, Cfa; Fg_in, Fm_in).
MPC_Q = np.diag([0.1, 1.0])
MPC_R = np.diag([1.0, 1.0])


def get_parts(dt_control=1, N_particles=2 * 15, gpu=True, pf=True, seed=0,
              device="cuda"):
    """Canonical closed-loop rig: ``(bioreactor, lin_model, K, est)``.

    ``gpu`` is accepted for the reference's surface and ignored (the
    device is ``device``). The default ``N_particles=2*15`` (=30) is the
    reference's, kept verbatim.
    """
    del gpu
    bioreactor, lin_model, K = _plant_and_controller(dt_control, device)
    est = _estimator(bioreactor, N_particles, pf, seed, device)
    return bioreactor, lin_model, K, est


def _plant_and_controller(dt_control, device):
    """The plant at its steady state, the linear model about the
    operating point (states, inputs and outputs Cg, Cfa and both feeds)
    and the MPC over 300 time units with 200 of control moves."""
    bioreactor = Bioreactor(
        X0=Bioreactor.find_SS(
            np.array([0.06, 0.2]),
            #            Ng,       Nx,       Nfa, Ne, Nh
            np.array([260 / 180, 640 / 24.6, 1000 / 116, 0, 0]),
        ),
        high_N=False,
    )

    lin_model = create_linear_model(
        bioreactor,
        x_bar=Bioreactor.find_SS(
            np.array([0.04, 0.1]),
            np.array([260 / 180, 640 / 24.6, 1000 / 116, 0, 0]),
        ),
        u_bar=np.array([0.04, 0.1]),
        T=dt_control,
    )
    lin_model.select_subset(
        states=[0, 2],  # Cg, Cfa
        inputs=[0, 1],  # Fg_in, Fm_in
        outputs=[0, 2],  # Cg, Cfa
    )

    K = MPC(
        P=int(300 // dt_control),
        M=max(int(200 // dt_control), 1),
        Q=MPC_Q,
        R=MPC_R,
        lin_model=lin_model,
        ysp=lin_model.yn2d(np.array([280, 850]), subselect=False),
        u_bounds=[
            np.array([0, np.inf]) - lin_model.u_bar[0],
            np.array([0, np.inf]) - lin_model.u_bar[1],
        ],
        device=device,
    )
    return bioreactor, lin_model, K


def _estimator(bioreactor, N_particles, pf, seed, device):
    """The particle filter (``pf``) or the GSUKF over the regime model,
    its initial mixture the state noise moved to the plant's state."""
    filter_cls = ParticleFilter if pf else GaussianSumUnscentedKalmanFilter
    state_pdf, measurement_pdf = get_noise(device=device)
    x0, _ = get_noise(device=device)
    x0.dist = dataclasses.replace(
        x0.dist,
        means=x0.dist.means + torch.as_tensor(
            np.asarray(bioreactor.X, dtype=np.float32)[None, :], device=device),
    )
    return filter_cls(
        f=Bioreactor.homeostatic_DEs,
        g=Bioreactor.static_outputs,
        N_particles=N_particles,
        x0=x0,
        state_pdf=state_pdf,
        measurement_pdf=measurement_pdf,
        seed=seed,
        device=device,
    )


def get_noise(lib=None, deterministic=False, device="cuda"):
    """Canonical state and measurement noise mixtures. ``lib`` is
    accepted for the reference's surface and ignored."""
    del lib
    distribution = DeterministicGaussianSum if deterministic else MultivariateGaussianSum
    state_pdf = distribution(
        means=np.zeros(shape=(2, 5)),
        covariances=np.array(
            [
                np.diag([1e-4, 1e-7, 1e-3, 1e-3, 1e-7]),
                np.diag([1e-3, 1e-6, 1e-2, 1e-2, 1e-6]),
            ]
        ),
        weights=np.array([0.75, 0.25]),
        device=device,
    )
    measurement_pdf = distribution(
        means=np.array([[1e-1, 0], [0, -1e-1]]),
        covariances=np.array(
            [[[6e-2, 0], [0, 8e-2]], [[500, 100], [100, 700]]]
        ),
        weights=np.array([0.85, 0.15]),
        device=device,
    )
    return state_pdf, measurement_pdf


def performance(ys, r, ts):
    """Time-weighted ISE: the integral of (y - r)^2 * t over each output,
    summed (the reference's docstring calls it ITAE; its code, kept here,
    integrates this)."""
    se = (np.asarray(ys) - np.asarray(r)) ** 2
    return sum(
        scipy.integrate.simpson(se_ax * ts, x=ts) for se_ax in np.rollaxis(se, 1)
    )


def get_random_io(rng=None):
    """Random system input and output draws."""
    rng = rng or np.random.default_rng()
    u = np.array([rng.uniform(0, 0.1), rng.uniform(0, 0.2)])
    y = np.array([rng.uniform(0.25, 0.3), rng.uniform(0.8, 0.9)])
    return u, y


def _host(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy(), dtype=float)


def _host_outputs(x: np.ndarray) -> np.ndarray:
    """The measurement function on a float64 host state."""
    return static_outputs(torch.as_tensor(x)).numpy()


class Simulation:
    """Closed-loop simulation with independent predict and control
    periods; the filter and the MPC on ``device``."""

    def __init__(self, N_particles, dt_control, dt_predict, end_time=50, pf=True,
                 seed=0, device="cuda"):
        self.ts = np.linspace(0, end_time, int(end_time * 10))
        self.dt = self.ts[1]
        self.dt_control = dt_control
        self.dt_predict = dt_predict

        self.bioreactor, self.lin_model, self.K, self.f = get_parts(
            dt_control=dt_control, N_particles=N_particles, pf=pf, seed=seed,
            device=device,
        )

        self.state_pdf, self.measurement_pdf = get_noise(device=device)
        # independent plant-noise streams, drawn for the whole horizon
        n_steps = len(self.ts)

        def draw(pdf, stream_seed):
            gen = torch.Generator(device=device).manual_seed(stream_seed)
            return _host(pdf.dist.draw(gen, (n_steps,)))

        self._state_noise = draw(self.state_pdf, seed + 101)
        self._meas_noise = draw(self.measurement_pdf, seed + 202)

        self.us = [np.array([0.06, 0.2])]
        self.xs = [self.bioreactor.X.copy()]
        self.ys = [self.bioreactor.outputs(self.us[-1])]
        self.ys_meas = [self.bioreactor.outputs(self.us[-1])]
        self.xs_f = [_host(self.f.point_estimate())]
        self.ys_f = [_host_outputs(self.xs_f[-1])]
        self.covariance_point_size = [float(self.f.point_covariance())]

        self.biass = []
        self.performance = None
        self.mpc_frac = None
        self.predict_count, self.update_count = 0, 0

    def simulate(self, progress=False):
        t_next_control, t_next_predict = 0.0, 0.0
        mpc_converged, mpc_no_converged = 0, 0
        iterator = self.ts[1:]
        if progress:
            import tqdm

            iterator = tqdm.tqdm(iterator)
        for t in iterator:
            if t > t_next_predict:
                self.f.predict(self.us[-1], self.dt)
                self.predict_count += 1
                t_next_predict += self.dt_predict

            if t > t_next_control:
                u_prev = self.us[-1].copy()
                if self.K.y_predicted is not None:
                    self.biass.append(
                        self.lin_model.yn2d(self.ys_meas[-1]) - self.K.y_predicted
                    )
                z = np.asarray(self.ys_meas[-1])[self.lin_model.outputs]
                self.f.update(self.us[-1], z)
                self.f.resample()
                self.update_count += 1

                self.xs_f.append(_host(self.f.moments()[0]))
                try:
                    u = self.K.step(
                        self.lin_model.xn2d(self.xs_f[-1]),
                        self.lin_model.un2d(self.us[-1]),
                        self.lin_model.yn2d(self.ys_meas[-1]),
                    )
                    mpc_converged += 1
                except ValueError:
                    u = np.array([0.06, 0.2])
                    mpc_no_converged += 1
                u_prev[self.lin_model.inputs] = self.lin_model.ud2n(u)
                self.us.append(u_prev.copy())
                t_next_control += self.dt_control
            else:
                self.us.append(self.us[-1])

            self.bioreactor.step(self.dt, self.us[-1])
            step_i = len(self.xs)
            self.bioreactor.X = self.bioreactor.X + self._state_noise[step_i]
            outputs = self.bioreactor.outputs(self.us[-1])
            self.ys.append(outputs.copy())
            outputs = outputs.copy()
            outputs[self.lin_model.outputs] += self._meas_noise[step_i]
            self.ys_meas.append(outputs)
            self.xs.append(self.bioreactor.X.copy())
            # the filter's moments are cached between its updates
            est, cov = self.f.moments()
            self.ys_f.append(_host_outputs(_host(est)))
            self.covariance_point_size.append(float(cov))

        self.us = np.array(self.us)
        self.xs = np.array(self.xs)
        self.ys = np.array(self.ys)
        self.ys_meas = np.array(self.ys_meas)
        self.xs_f = np.array(self.xs_f)
        self.ys_f = np.array(self.ys_f)
        self.covariance_point_size = np.array(self.covariance_point_size)
        self.performance = performance(
            self.ys[:, self.lin_model.outputs], self.ys_f, self.ts
        )
        total = mpc_converged + mpc_no_converged
        self.mpc_frac = mpc_converged / total if total else None
