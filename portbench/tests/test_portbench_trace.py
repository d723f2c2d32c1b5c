"""Device time is attributed to the vfast range its launch lay in, and
busy time, gaps and the breakdown come out of a trace."""

import json

import pytest

from portbench import trace


def _ev(cat, name, ts, dur, corr=None, ph="X"):
    e = {"ph": ph, "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_attribution_busy_and_gaps(tmp_path):
    ev = [
        _ev("user_annotation", "portbench.window", 0.0, 1000.0),
        _ev("user_annotation", "vfast.twin_second", 10.0, 20.0),
        _ev("user_annotation", "vfast.gulp_search", 40.0, 310.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 12.0, 1.0, corr=1),
        _ev("cuda_driver", "cuLaunchKernel", 15.0, 1.0, corr=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 45.0, 1.0, corr=3),
        _ev("cuda_runtime", "cudaLaunchKernel", 400.0, 1.0, corr=4),
        _ev("kernel", "dft", 20.0, 100.0, corr=1),
        _ev("kernel", "ema", 120.0, 50.0, corr=2),
        _ev("gpu_memcpy", "copy", 300.0, 100.0, corr=3),
        _ev("kernel", "other", 600.0, 100.0, corr=4),
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    a = trace.analyse(p)
    assert a["window_s"] == 1000e-6
    assert abs(a["busy_s"] - 350e-6) < 1e-12
    assert a["by_range"]["vfast.twin_second"] == (pytest.approx(150e-6), 1)
    assert a["by_range"]["vfast.gulp_search"] == (pytest.approx(100e-6), 1)
    assert abs(a["unattributed"] - 100e-6) < 1e-12
    assert a["device_ops"][0] == ["dft", 100e-6]
    assert a["idle_gaps"][0] == ["outside vfast ranges", pytest.approx(300e-6)]
    assert a["idle_gaps"][2] == ["vfast.gulp_search", pytest.approx(130e-6)]
    assert len(a["idle_gaps"]) == 4
