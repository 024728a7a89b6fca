"""A stream window compares a step of every resample route it took: a
route taken once in the window is among the checked steps, however few
``check_steps`` the reservoir keeps."""
from __future__ import annotations

from port_bench.test_bench_reference import STREAM_SIZES, _cpu_run


def test_a_rare_route_is_checked(monkeypatch, capsys):
    from gpu_se_tpu_torch import graphs
    from gpu_se_tpu_torch.filters import particle

    def rare():
        """A stand-in kernel that the tenth resample launches once."""

    rare.launches = 0
    calls = []
    plain = particle.resample

    def resample(state):
        calls.append(1)
        if len(calls) == 10:
            rare.launches += 1
        return plain(state)

    monkeypatch.setattr(graphs, "KERNELS", (rare,))
    monkeypatch.setattr(particle, "resample", resample)
    res = _cpu_run("pf_2p20_stream", STREAM_SIZES, seconds=2.0)
    assert res["attempted"] > 10
    err = capsys.readouterr().err
    checked = next(line for line in err.splitlines()
                   if line.startswith("checked steps"))
    assert "{'rare': 1}" in checked
    assert "none" in checked
    assert res["compared"]["rows_not_inherited"]["value"] == 0
