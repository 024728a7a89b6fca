"""PowerMeasurement: energy per run.

Counterpart of ``gpu_se_tpu/utils/power.py``. A sampler thread reads the
host CPU's busy share and the card's power draw every 0.2 s while the
wrapped function runs, once more when it returns, and the readings are
trapezoid-integrated into joules per run.

The probes:

* the card's power is ``nvidia-smi``'s ``power.draw`` of the card torch
  uses, selected by its UUID (``-i GPU-<uuid>``): without ``-i`` the
  query prints one line per card. The reference reads a sysfs hwmon
  sensor first; on a GPU host that is another sensor (the CPU package,
  the supply), so it is not read here;
* the CPU share is ``psutil.cpu_times()``'s busy time over its total
  between two samples, as ``psutil.cpu_percent()`` computes it, scaled
  by ``CPU_max_power`` watts.

A probe that gives no reading (no card, no ``nvidia-smi``, an ``[N/A]``
draw, CPU counters that do not advance) is recorded as ``NaN``, never as
0, and its energy comes out ``NaN``. The sampler is a thread, not a
forked process: forking a process whose CUDA context and torch threads
are running can deadlock the child.
"""
from __future__ import annotations

import subprocess
import threading
import time

import numpy as np
import psutil
import scipy.integrate
import torch

SAMPLE_S = 0.2


def _card_id():
    """``nvidia-smi``'s id of the card torch uses, or None without one."""
    if not torch.cuda.is_available():
        return None
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    return f"GPU-{props.uuid}"


def _read_nvidia_smi(card):
    try:
        out = subprocess.check_output(
            ["nvidia-smi", "-i", card, "--query-gpu=power.draw",
             "--format=csv,noheader,nounits"],
            stderr=subprocess.DEVNULL,
            timeout=2,
        )
        return float(out)
    except (OSError, ValueError, subprocess.SubprocessError):
        return None


def get_accelerator_power():
    """The card's power draw in watts, or ``None`` when there is no card
    or no reading (recorded as NaN by the sampler, never as 0)."""
    card = _card_id()
    return None if card is None else _read_nvidia_smi(card)


def accelerator_probe_available() -> bool:
    """True iff the card's power probe gives readings here."""
    return get_accelerator_power() is not None


def _busy_total(t):
    """``(busy, total)`` seconds of ``psutil.cpu_times()``, as
    ``psutil.cpu_percent`` counts them (guest time is in user time)."""
    total = sum(t) - getattr(t, "guest", 0.0) - getattr(t, "guest_nice", 0.0)
    return total - t.idle - getattr(t, "iowait", 0.0), total


class _CpuShare:
    """The CPU's busy share since the last call, from ``psutil``'s
    counters; NaN where they did not advance."""

    def __init__(self):
        self._last = _busy_total(psutil.cpu_times())

    def __call__(self) -> float:
        busy, total = _busy_total(psutil.cpu_times())
        (busy0, total0), self._last = self._last, (busy, total)
        return (busy - busy0) / (total - total0) if total > total0 \
            else float("nan")


def _sample(card, cpu_share, times, cpu, accel):
    times.append(time.time())
    cpu.append(cpu_share())
    watts = None if card is None else _read_nvidia_smi(card)
    accel.append(np.nan if watts is None else watts)


class PowerMeasurement:
    """Wrap ``f(N, t_run, ...)``; calling it returns ``(result, [E_cpu,
    E_accel])`` in joules. ``last_samples`` holds the readings of the
    last call: rows of times, CPU share and card watts."""

    def __init__(self, function, CPU_max_power=30.0):
        self.function = function
        self.CPU_max_power = CPU_max_power
        self.last_samples = None
        self.__name__ = getattr(function, "__name__", "power_measured")
        self.__code__ = getattr(function, "__code__", None)

    def __call__(self, N_particle, t_run, *args, **kwargs):
        card = _card_id()
        cpu_share = _CpuShare()
        times, cpu, accel = [], [], []
        stop = threading.Event()

        def sampler():
            while not stop.is_set():
                _sample(card, cpu_share, times, cpu, accel)
                stop.wait(SAMPLE_S)

        thread = threading.Thread(target=sampler, name="power-sampler",
                                  daemon=True)
        thread.start()
        try:
            res = self.function(N_particle, t_run, *args, **kwargs)
        finally:
            stop.set()
            thread.join()
        _sample(card, cpu_share, times, cpu, accel)
        samples = np.array([times, cpu, accel])
        self.last_samples = samples
        energy = scipy.integrate.trapezoid(samples[1:, :], samples[0], axis=1)
        energy[0] *= self.CPU_max_power
        return res, energy

    @staticmethod
    def measure(function, *args, **kwargs):
        return PowerMeasurement(function, *args, **kwargs)
