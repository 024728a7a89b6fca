"""On the card, at sizes a test run holds: a sound run of each stream cell
compares within its limits, and the comparison's control (the reference
in the program's place, in TF32 and bfloat16) fails it, in the streams
and in the closed loops, and the GSUKF loop sees its weights left out.
Skipped without a card; decided inside each test."""
from __future__ import annotations

import time

import pytest
import torch

from port_bench import manifest, run
from port_bench.session import Session

SIZES = {"pf_2p20_stream": 16, "gsukf_2p18_stream": 14}
# the closed loops: two short episodes, the MPC at dt_control 0.5
LOOPS = {"pf_2p20_loop": 16, "gsukf_2p18_loop": 14}


def _card_run(cell, control, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = manifest.cell(cell)
    sizes, traffic = {"n_log2": SIZES.get(cell) or LOOPS[cell]}, {}
    if cell in LOOPS:
        sizes["mpc"] = {**c.config["mpc"], "dt_control": 0.5}
        traffic = {"pool": [0, 1], "end_time": 10.0}
    s = Session(cell=c, seed=seed, seconds=1.0, trace=False,
                device=torch.device("cuda", 0), process_start=time.time(),
                control=control, sizes=sizes, traffic_sizes=traffic)
    return run.execute(s)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(SIZES))
@pytest.mark.parametrize("seed", [3300000001, 3300000002, 3300000003])
def test_the_control_fails_on_the_card(cell, seed):
    res = _card_run(cell, "reduced", seed)
    assert res["correct"] is False
    over = [k for k, v in res["compared"].items()
            if v["limit"] is not None and v["value"] > v["limit"]]
    assert "weight_gap" in over or "mean_gap" in over


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(SIZES))
def test_a_sound_small_run_stays_within_the_exact_limits(cell):
    res = _card_run(cell, "none", 3300000011)
    assert res["failed"] == 0
    assert res["compared"]["rows_not_inherited"]["value"] == 0
    assert res["compared"]["weight_gap"]["value"] <= \
        res["compared"]["weight_gap"]["limit"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(LOOPS))
@pytest.mark.parametrize("seed", [3300000001, 3300000002, 3300000003])
def test_the_loop_control_fails_on_the_card(cell, seed):
    res = _card_run(cell, "reduced", seed)
    assert res["correct"] is False
    over = [k for k, v in res["compared"].items()
            if v["limit"] is not None and v["value"] > v["limit"]]
    assert "plant_gap" in over and "measurement_gap" in over


@pytest.mark.gpu
def test_the_gsukf_loop_sees_weights_left_out_on_the_card():
    """Half of the bank's weights left out of the update: the GSUKF's
    local updates carry its estimate, the share of the bank each
    resample keeps shows the fault."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = manifest.cell("gsukf_2p18_loop")
    s = Session(cell=c, seed=3300000021, seconds=1.0, trace=False,
                device=torch.device("cuda", 0), process_start=time.time(),
                fault="half_batch",
                sizes={"n_log2": LOOPS["gsukf_2p18_loop"],
                       "mpc": {**c.config["mpc"], "dt_control": 0.5}},
                traffic_sizes={"pool": [0, 1], "end_time": 10.0})
    res = run.execute(s)
    got = res["compared"]["survivor_share_gap"]
    assert got["value"] > got["limit"]
    assert res["correct"] is False
