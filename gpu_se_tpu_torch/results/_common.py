"""Shared setup for the experiment modules.

Counterpart of the reference's ``results/_common.py``: every module
exposes ``simulate()`` / ``*_run_seq()`` / ``plot()`` entry points,
expensive results are memoized in the jar, and figures render headless
into this package's ``figures/``. matplotlib is imported by
:func:`save_fig` and the ``plot()`` functions, never at import.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from gpu_se_tpu_torch import sim
from gpu_se_tpu_torch.models import Bioreactor

RESULTS_DIR = os.path.dirname(os.path.abspath(__file__))
FIG_DIR = os.path.join(RESULTS_DIR, "figures")
ARTIFACT = os.path.join(RESULTS_DIR, "artifacts", "CAMPAIGN_H100.json")


def pyplot():
    """matplotlib's ``pyplot`` on the headless Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_fig(name: str) -> str:
    plt = pyplot()
    os.makedirs(FIG_DIR, exist_ok=True)
    path = os.path.join(FIG_DIR, name)
    plt.savefig(path, bbox_inches="tight", dpi=120)
    plt.close("all")
    print(f"figure -> {path}")
    return path


def card_label() -> str:
    """The legend of a figure's card leg: this host's card, else the card
    the committed campaign ran on. Raises where neither is known, so no
    figure puts CPU data under a card's name."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_name()
    try:
        with open(ARTIFACT) as fh:
            return json.load(fh)["card"]["name"]
    except (FileNotFoundError, KeyError) as e:
        raise RuntimeError("no CUDA card here and no campaign artifact "
                           f"naming one ({ARTIFACT})") from e


def device_label(device) -> str:
    """The name a memo of a run on ``device`` is labelled with: the
    card's name for a CUDA device, ``"CPU"`` for the CPU. Raises where
    ``device`` is a CUDA device and torch sees no card, so a missing card
    memo is never computed here."""
    device = torch.device(device)
    if device.type == "cpu":
        return "CPU"
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device} needs a CUDA card and torch sees none: the "
            "card's memo of this run is missing from the jar")
    return torch.cuda.get_device_name(device)


def host_array(t) -> np.ndarray:
    """A tensor (or array) as a float64 numpy array on the host."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=float)


def canonical_plant() -> Bioreactor:
    """The closed loop's plant at its steady state, as
    ``sim.get_parts`` builds it, without the controller."""
    return Bioreactor(
        X0=Bioreactor.find_SS(
            np.array([0.06, 0.2]),
            np.array([260 / 180, 640 / 24.6, 1000 / 116, 0, 0]),
        ),
        high_N=False,
    )


def openloop_staged_run(end_time, schedule, X0, noisy=True, clear_at=25.0,
                        high_N=True, seed=0):
    """Generic staged open-loop bioreactor run on the host.

    ``schedule``: list of ``(t_end, u)`` stages; the state partial-zero
    and the regime switch happen at ``clear_at``. The plant and
    measurement noise are drawn from CPU generators seeded ``seed + 11``
    and ``seed + 22``.
    """
    ts = np.linspace(0, end_time, int(end_time * 10))
    dt = ts[1]
    reactor = Bioreactor(X0=np.array(X0, dtype=float), high_N=high_N)
    state_pdf, measurement_pdf = sim.get_noise(device="cpu")
    state_pdf.generator.manual_seed(seed + 11)
    measurement_pdf.generator.manual_seed(seed + 22)
    select_outputs = [0, 2]

    us = [np.array([0.0, 0.0])]
    xs = [reactor.X.copy()]
    ys = [reactor.outputs(us[-1])]
    ys_meas = [reactor.outputs(us[-1])]

    not_cleared = True
    for t in ts[1:]:
        u = schedule[-1][1]
        for t_end, u_stage in schedule:
            if t < t_end:
                u = u_stage
                break
        if t >= clear_at and not_cleared:
            reactor.X[[0, 2, 3, 4]] = 0
            not_cleared = False
            reactor.high_N = False
        us.append(np.asarray(u, dtype=float))
        reactor.step(dt, us[-1])
        if noisy:
            reactor.X = reactor.X + host_array(state_pdf.draw()).squeeze()
        outputs = reactor.outputs(us[-1])
        ys.append(outputs.copy())
        if noisy:
            outputs = outputs.copy()
            outputs[select_outputs] += host_array(measurement_pdf.draw()).squeeze()
        ys_meas.append(outputs)
        xs.append(reactor.X.copy())

    return ts, np.array(us), np.array(xs), np.array(ys), np.array(ys_meas)
