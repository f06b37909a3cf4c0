"""Benchmark harness smoke (SURVEY.md §4.6: each bench config runs at
reduced size in CI mode). Runs bench.py's measurement functions on the
CPU backend with tiny shapes — validates the harness plumbing (config
construction, timing protocol, EPE stage); `main` itself refuses to
report a number from anything but a GPU."""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


def test_bench_fused_pipeline_smoke():
    import bench
    fps, extra = bench.bench_fused_pipeline(64, 64, t=4, num_tracks=16,
                                            state_dim=4,
                                            flow_method="farneback",
                                            repeats=2, fast_warp=4)
    assert np.isfinite(fps) and fps > 0
    assert extra["fps_median_of"] == 2
    assert extra["fps_spread_pct"] >= 0


def test_bench_epe_smoke():
    import bench
    epe = bench.bench_epe(64, 64, fast_warp=4)
    # the accuracy contract at bench scale (BASELINE.json:5: < 0.5 px)
    assert np.isfinite(epe) and epe < 0.5


def test_bench_main_refuses_cpu_backend(capsys):
    import bench
    assert bench.main(["--quick"]) == 2
    out = capsys.readouterr().out
    assert not any(line.startswith("{") for line in out.splitlines())


def test_bench_device_info_names_the_backend():
    import bench
    info = bench.device_info()
    assert info["platform"] == "cpu"
    assert info["device_count"] >= 1
    json.dumps(info)
