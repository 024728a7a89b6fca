"""The stream harness at a particle count that is a multiple of neither
4096 nor 256, on the route the card takes there: ``v4``'s ``compact`` and
``expand`` (their plain versions on the CPU), judged by the reference
with the limits of the PF stream cell whose count is such a one
(``pf_2p23.5_stream``, ``int(2 ** 23.5)`` particles). The CPU runs
``int(2 ** 14.5)`` = 23170 particles over a trajectory of 61 steps
(whatever the CPU's speed, so the same steps are checked) and checks 48 of
them, so the noise's moments are read from over a million draws (the
card's four checked steps hold 47 million); a sound run compares as
sound, and a broken one (a fault of ``faults.py``, or the control) fails
the number named."""
from __future__ import annotations

import pytest

from port_bench import manifest
from port_bench.test_bench_reference import _cpu_run

CELL = "pf_2p23.5_stream"
SIZES = {"n_log2": 14.5}
# the window outlasts the trajectory of 30 s at 2 steps a second
TRAFFIC = {"check_steps": 48, "max_steps_per_s": 2}
SECONDS = 30.0
N = int(2 ** SIZES["n_log2"])


def _run(monkeypatch, control="none", fault="none"):
    from gpu_se_tpu_torch.filters import resampling
    from gpu_se_tpu_torch.ops import resample_pallas4 as rp4

    counts, plain = [], rp4.compact_plain

    def compact_plain(ends, payload):
        counts.append(ends.shape[0])
        return plain(ends, payload)

    monkeypatch.setattr(rp4, "compact_plain", compact_plain)
    with resampling.impl("v4"):
        res = _cpu_run(CELL, SIZES, TRAFFIC, control=control, fault=fault,
                       seconds=SECONDS)
    return res, counts


def test_an_unaligned_count_on_the_v4_route_compares_as_sound(monkeypatch):
    assert N % 4096 and N % 256
    res, counts = _run(monkeypatch)
    # every step's resample compacted all N particles
    assert res["attempted"] == 61
    assert set(counts) == {N} and len(counts) >= res["attempted"]
    assert res["failed"] == 0
    limits = manifest.cell(CELL).limits
    got = {k: v["value"] for k, v in res["compared"].items()}
    assert set(got) == set(limits) - {"_readings"}
    for name, value in got.items():
        assert value <= limits[name]["limit"], (name, value)
    assert res["correct"] is True


@pytest.mark.parametrize("mode, number", [
    ("unchanged", "noise_moment_gap"),
    ("half_batch", "weight_gap"),
    ("altered", "rows_not_inherited"),
    ("reduced", "weight_gap"),
])
def test_a_broken_run_at_an_unaligned_count_is_not_correct(monkeypatch,
                                                          mode, number):
    control = "reduced" if mode == "reduced" else "none"
    fault = "none" if mode == "reduced" else mode
    res, _ = _run(monkeypatch, control, fault)
    limits = manifest.cell(CELL).limits
    over = {k for k, v in res["compared"].items()
            if v["value"] > limits[k]["limit"]}
    assert number in over, (number, res["compared"])
    assert res["correct"] is False
