"""A run of a tiny cell in a process of its own: its last line has the
contract's keys, the comparison comes last, and the process loads no
module of jax, jaxlib, flax or the JAX package."""

import json
import subprocess
import sys

from portbench import spec

SCRIPT = """
import json, sys, time
t = time.time()
from portbench import run
from portbench.tests._tiny import tiny_cell
out = run.execute(tiny_cell(), 2 ** 31 + 7, 1.0, False, "cpu", t)
run.emit(out)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_last_line_and_no_jax():
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = res.stdout.strip().splitlines()
    out, modules = json.loads(lines[-2]), json.loads(lines[-1])
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "compared"]
    assert out["correct"] is True
    assert set(out["metrics"]) == {"antennas_per_card",
                                   "gulp_latency_p95_ms", "setup_s"}
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in out["compared"].values():
        assert set(c) == {"value", "limit"}
    assert not set(modules) & {"jax", "jaxlib", "flax", "vlite_fast_tpu"}
    assert "vlite_fast_tpu_torch" in modules
    # the comparison also closes standard error
    tail = res.stderr.strip().splitlines()[-len(out["compared"]):]
    assert all(line.startswith("compared ") for line in tail)


def test_no_card_no_result():
    res = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "station_fft.noise", "--seed", "1", "--seconds", "1"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert res.returncode != 0
    assert res.stdout.strip() == ""
