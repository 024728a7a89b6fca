"""Runs of each cell at a size the CPU holds, the harness's look for a
card skipped, with the timed path broken underneath (a fault of
``faults.py``) or the comparison's control in the program's place: the
comparison has to come out false, the number named among those over the
cell's own limits."""
from __future__ import annotations

import pytest

from port_bench import manifest
from port_bench.test_bench_reference import _cpu_run, sizes_of

CASES = [
    # a step that returns its state unchanged
    ("pf_2p20_stream", "unchanged", "noise_moment_gap"),
    ("gsukf_2p18_stream", "unchanged", "noise_moment_gap"),
    ("pf_2p20_loop", "unchanged", "estimate_rms_gap"),
    ("gsukf_2p18_loop", "unchanged", "estimate_rms_gap"),
    # half of the batch left out of the update
    ("pf_2p20_stream", "half_batch", "weight_gap"),
    ("gsukf_2p18_stream", "half_batch", "weight_gap"),
    ("pf_2p20_loop", "half_batch", "estimate_rms_gap"),
    # (the GSUKF's local updates carry the estimate whatever the
    # weights: the weights show in the share of the bank each resample
    # keeps)
    ("gsukf_2p18_loop", "half_batch", "survivor_share_gap"),
    # an answer altered where it is produced
    ("pf_2p20_stream", "altered", "rows_not_inherited"),
    ("gsukf_2p18_stream", "altered", "rows_not_inherited"),
    ("pf_2p20_loop", "altered", "control_gap"),
    ("gsukf_2p18_loop", "altered", "control_gap"),
    # the control: the reference in the program's place, in TF32 and
    # bfloat16
    ("pf_2p20_stream", "reduced", "weight_gap"),
    ("gsukf_2p18_stream", "reduced", "mean_gap"),
    ("pf_2p20_loop", "reduced", "plant_gap"),
    ("gsukf_2p18_loop", "reduced", "plant_gap"),
]


@pytest.mark.parametrize("cell, mode, number", CASES)
def test_a_broken_run_is_not_correct(cell, mode, number):
    sizes, traffic = sizes_of(cell)
    control = "reduced" if mode == "reduced" else "none"
    fault = "none" if mode == "reduced" else mode
    res = _cpu_run(cell, sizes, traffic, control=control, fault=fault)
    limits = manifest.cell(cell).limits
    over = {k for k, v in res["compared"].items()
            if v["value"] > limits[k]["limit"]}
    assert number in over, (number, res["compared"])
    assert res["correct"] is False
