"""The card: its published peaks, least times, and what ``nvidia-smi``
reads.

The peaks are those of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W): a share of a roofline is stated against them,
with the card's power limit printed beside it. ``least_time`` is a
frozen copy of the port's smoke run's helper of the same name.
"""
from __future__ import annotations

import subprocess

PEAK_BYTES = 3.35e12        # HBM3, bytes/s
PEAK_F32_OPS = 67e12        # float32 outside the tensor cores, FLOP/s


def least_time(nbytes: float, ops: float) -> float:
    """The least seconds the card could take: the larger of the bytes
    over the memory rate and the float32 operations over their rate."""
    return max(nbytes / PEAK_BYTES, ops / PEAK_F32_OPS)


def smi(fields: str) -> list[str]:
    """One ``nvidia-smi`` query of card 0, its fields as strings; empty
    where the tool is missing or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", f"--query-gpu={fields}",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [v.strip() for v in out.strip().splitlines()[0].split(",")] \
        if out.strip() else []


def name_and_limit() -> str:
    vals = smi("name,power.limit")
    return f"{vals[0]}, {vals[1]} W" if len(vals) == 2 else "not read"


def clocks() -> dict:
    """The SM and memory clocks (MHz), temperature (C), power drawn (W)
    and the active clock-event reasons (a bit mask) now."""
    names = ("sm_clock_mhz", "mem_clock_mhz", "temperature_c", "power_w")
    vals = smi("clocks.sm,clocks.mem,temperature.gpu,power.draw")
    if len(vals) != len(names):
        return {}
    out = dict(zip(names, vals))
    reasons = smi("clocks_throttle_reasons.active")
    if reasons:
        out["clock_event_reasons"] = reasons[0]
    return out
