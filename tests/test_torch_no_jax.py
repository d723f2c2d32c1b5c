"""The port imports and runs with jax absent (the GPU machine has no jax).

A subprocess blocks jax (sys.modules['jax'] = None makes any import of it
fail), imports vlite_fast_tpu_torch with every submodule, and runs one
tiny second through the armed program and through each chain kernel's
entry point (the relayout, chain_second in its three modes,
chain_second_v4), resolves every twin program, and runs one tiny gulp
search, all on the CPU.
"""

import os
import subprocess
import sys

SCRIPT = r"""
import sys
sys.modules["jax"] = None
import importlib, pkgutil
import numpy as np
import torch
torch.set_num_threads(1)
import vlite_fast_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from vlite_fast_tpu_torch import PipelineConfig, SearchConfig
from vlite_fast_tpu_torch.models import baseband_dsp as dsp
from vlite_fast_tpu_torch.models import search
cfg = PipelineConfig.tiny(nbit=2)
rng = np.random.default_rng(0)
raw = np.clip(rng.standard_normal((2, cfg.sample_rate)) / 0.05914 + 128.5,
              0, 255).astype(np.uint8)
out, st = dsp.process_second(cfg, torch.from_numpy(raw), dsp.init_state(cfg))
assert out.packed_kur.shape == (cfg.seg_per_sec * cfg.out_samps_per_seg, 48)
from vlite_fast_tpu_torch.ops import megakernel as mk
t = torch.from_numpy(raw)
bp = torch.zeros((2, 2, cfg.nchan))
xs = mk.pallas_pretranspose(t, cfg.nfft, 2, cfg.seg_per_sec, torch.bfloat16)
assert xs.shape == (cfg.seg_per_sec, 2 * cfg.ffts_per_seg * 128, 128)
for mode in mk.PRETRANSPOSE:
    got = mk.chain_second(t, bp, cfg, pretranspose=mode)
    assert torch.equal(got[1], out.packed_kur)
got = mk.chain_second_v4(t, bp, cfg, pre_dtype="bf16")
assert torch.equal(got[1], out.packed_kur)
import dataclasses
for twin in ("auto", "same") + dsp.MEGAKERNELS:
    c = dataclasses.replace(cfg, inject_frb=True, twin_chain_impl=twin)
    dsp.twin_program(c)(dsp.twin_config(c), t, dsp.init_state(c))
eng = search.SinglePulseSearch(SearchConfig.tiny(), cfg.tsamp,
                               cfg.freqs_mhz(), nsub=64, nbatch=64)
rows = SearchConfig.tiny().gulp_samps + eng.overlap
reps = rows // out.packed_kur.shape[0] + 1
packed = np.tile(out.packed_kur.numpy(), (reps, 1))[:rows]
cands = eng.search_gulp_packed(packed, 2)
loaded = {m.split(".")[0] for m, mod in sys.modules.items() if mod is not None}
assert "jax" not in loaded
print("OK", len(names))
"""


def test_port_runs_without_jax():
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("OK")
    assert int(res.stdout.split()[1]) >= 15     # every submodule imported
