"""On a card: each cell runs a short window at its production size, and
its comparison with the reference holds; the control fails it.  Skips
without a card (the benchmark's kernels have no CPU mode)."""

import json
import subprocess
import sys

import pytest

from portbench import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_is_correct(card, cell):
    res = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell,
         "--seed", str(2 ** 31 + 5), "--seconds", "3", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"], out["compared"]
    assert out["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_fails(card, cell):
    from portbench import control
    c = spec.load_cell(cell)
    vals = control.control_numbers(c, 2 ** 31 + 6, "cuda")
    assert any(vals[n] > c.limits[n] for n in vals), vals
