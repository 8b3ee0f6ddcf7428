"""Throughput micro-benchmark (eval/throughput.py) runs and reports sane
numbers on tiny inputs (the real measurement sizes run via phi-throughput)."""

import json

from phi_tpu.eval.throughput import bench_join, bench_sketch, main


def test_bench_sketch_and_join_tiny():
    s = bench_sketch(200_000, repeats=1)
    assert s["bases_per_s"] > 0 and s["kmers_per_s"] > 0
    assert 0 < s["spectrum"] <= 200_000
    j = bench_join(200_000, repeats=1)
    assert j["bases_per_s"] > 0
    # the spectrum was sampled from the same sequence -> hits must exist
    assert j["hits"] > 0


def test_cli_json_lines(capsys):
    assert main(["--mbases", "0.2", "--repeats", "1"]) == 0
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    assert len(lines) == 2
    for l in lines:
        row = json.loads(l)
        assert {"metric", "bases_per_s", "kmers_per_s", "backend"} <= set(row)


def test_roofline_peak_table():
    """Peaks come from the table keyed by device_kind: none on the host,
    the published bandwidth on an H100, an error for an unknown card."""
    import types

    import pytest

    from phi_tpu.eval.throughput import _roofline
    assert _roofline(types.SimpleNamespace(platform="cpu"), 1e9) == {}
    h100 = types.SimpleNamespace(platform="gpu",
                                 device_kind="NVIDIA H100 80GB HBM3")
    r = _roofline(h100, 1.34e12)
    assert r["mem_roofline_bases_per_s"] == round(3.35e12 / 0.25)
    assert r["mem_roofline_fraction"] == 0.1
    with pytest.raises(ValueError, match="no published peak"):
        _roofline(types.SimpleNamespace(platform="gpu",
                                         device_kind="Unknown card"), 1.0)
