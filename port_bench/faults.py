"""Faults planted under the timed path, for the tests that see the
comparison fail (and for the readings that set a limit's upper end).

Each replaces a function of the port for the duration of a run:

* ``unchanged``: the predict returns the state it was given;
* ``half_batch``: the update weighs only the first half of the batch and
  leaves the rest as it was;
* ``altered``: the resample's first output row is moved by one, and the
  closed loop's control by a thousandth of its scale.
"""
from __future__ import annotations

import contextlib
import dataclasses

FAULTS = ("none", "unchanged", "half_batch", "altered")


def _half(update):
    def half_update(state, *args, **kwargs):
        import torch

        new = update(state, *args, **kwargs)
        n = new.weights.shape[0]
        w = torch.cat([new.weights[: n // 2], state.weights[n // 2:]])
        return dataclasses.replace(new, weights=w)

    return half_update


def _moved_row(resample, field):
    def moved(state):
        new = resample(state)
        rows = getattr(new, field).clone()
        rows[0] = rows[0] + 1.0
        return dataclasses.replace(new, **{field: rows})

    return moved


def _moved_control(make_device_step):
    def make(mpc):
        consts, step = make_device_step(mpc)

        def moved(*args, **kwargs):
            ctrl, y_pred, sol = step(*args, **kwargs)
            return ctrl + 1e-3, y_pred, sol

        return consts, moved

    return make


@contextlib.contextmanager
def planted(name: str):
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
    if name == "none":
        yield
        return
    from gpu_se_tpu_torch.control import mpc
    from gpu_se_tpu_torch.filters import gs_ukf, particle

    patches = []
    if name == "unchanged":
        patches = [(m, "predict", lambda state, *a, **k: state)
                   for m in (particle, gs_ukf)]
    elif name == "half_batch":
        patches = [(m, "update", _half(m.update)) for m in (particle, gs_ukf)]
    elif name == "altered":
        patches = [(particle, "resample",
                    _moved_row(particle.resample, "particles")),
                   (gs_ukf, "resample", _moved_row(gs_ukf.resample, "means")),
                   (mpc, "make_device_step",
                    _moved_control(mpc.make_device_step))]
    saved = [(m, attr, getattr(m, attr)) for m, attr, _ in patches]
    try:
        for m, attr, fn in patches:
            setattr(m, attr, fn)
        yield
    finally:
        for m, attr, fn in saved:
            setattr(m, attr, fn)
