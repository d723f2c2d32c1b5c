"""The port imports and runs with jax and the JAX package absent (the GPU
machine has no jax, and the port keeps its own copies of the package's
host modules).

A subprocess blocks jax and vlite_fast_tpu (sys.modules[name] = None
makes any import of either fail), imports vlite_fast_tpu_torch with every
submodule, and runs one tiny second through the armed program and
through each chain kernel's entry point (the relayout, chain_second in
its three modes, chain_second_v4), resolves every twin program, runs the
staged chain's stages A and B and the roll+select dedispersion, runs
one tiny gulp search, runs two tiny antennas with their rings through
ArrayPipeline.run_streaming, runs the CLI's synth, process and localize
(three tiny dumps) at a tiny rate, one StationDaemon file: observation,
and a one-rank tiny sharded array step (gloo), all on the CPU.
"""

import os
import subprocess
import sys

SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["vlite_fast_tpu"] = None
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
out, st = dsp.process_second(cfg, torch.from_numpy(raw), dsp.init_state(cfg, 'cpu'))
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
    _, prog, pc = dsp.second_program(c, -1)
    prog(pc, t, dsp.init_state(c, 'cpu'))
eng = search.SinglePulseSearch(SearchConfig.tiny(), cfg.tsamp,
                               cfg.freqs_mhz(), nsub=64, nbatch=64,
                               device="cpu")
rows = SearchConfig.tiny().gulp_samps + eng.overlap
reps = rows // out.packed_kur.shape[0] + 1
packed = np.tile(out.packed_kur.numpy(), (reps, 1))[:rows]
cands = eng.search_gulp_packed(packed, 2)
nfft, ffts, nseg = 2048, 4, 2
u8 = torch.from_numpy(rng.integers(1, 256, (2, nfft * ffts * nseg),
                                   dtype=np.uint8))
power = mk.dft_detect_power(u8, nfft, 2, nseg)
assert power.shape == (nseg, 2 * ffts, nfft // 2 + 1)
packed_b, bp_b = mk.chain_second_plain(u8, torch.zeros((2, nfft // 2 + 1)),
                                       nfft, 2, nseg, 4, 0.02, 101, 612)
assert packed_b.shape == (nseg * ffts // 4, 128) and bool((bp_b > 0).all())
from vlite_fast_tpu_torch.ops import dedisperse as dd
from vlite_fast_tpu_torch.ops import dedisperse_pallas as ddp
freqs = np.linspace(400.0, 350.0, 64)
plan = dd.make_plan(dd.dm_grid(0.0, 100.0, 16), freqs, 2e-3, nsub=8,
                    nbatch=4, device="cpu")
fb = torch.from_numpy(rng.standard_normal((200 + plan.max_delay, 64))
                      .astype(np.float32))
dmt = ddp.dedisperse_pallas_rollsel(fb, plan, 200)
assert torch.allclose(dmt, dd.dedisperse(fb, plan, 200), rtol=1e-5, atol=1e-4)
assert mk.LAUNCHES["dft_detect_power"] == mk.LAUNCHES["chain_second_plain"] \
    == ddp.ROLLSEL_LAUNCHES == 0
import os, tempfile
from vlite_fast_tpu_torch.config import ArrayConfig
from vlite_fast_tpu_torch.runtime.pipeline import (ArrayPipeline,
                                                   ObservationDocument)
acfg = ArrayConfig.tiny(nant=2)
with tempfile.TemporaryDirectory() as out_dir:
    ap = ArrayPipeline(acfg, out_dir=out_dir, device="cpu")
    shm = ["/dev/shm" + st.ring.name for st in ap.stations]
    try:
        res = ap.run_streaming(
            {a.station_id: [(1.7e9 + k, raw) for k in range(3)]
             for a in acfg.antennas},
            ObservationDocument(name="NOJAX", start_time=1.7e9),
            coincide_every_s=1)
        assert all(os.path.exists(p) for p in shm)
    finally:
        ap.close()
    assert not any(os.path.exists(p) for p in shm)
    assert [(p.seconds, p.dropped) for p in res["products"].values()] == \
        [(3, 0), (3, 0)]
    assert ap.coadd.gulps >= 1
    import contextlib, io, json
    from vlite_fast_tpu_torch import cli
    vdif = os.path.join(out_dir, "synth.vdif")
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["synth", "-t", "2", "-d", "300", "-p", "0.05", "-k", "16",
                  "-a", "0.4", "--rate", "1000000", "--bandwidth", "0.5",
                  "--buflen", "250000", "-o", vdif])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["--device", "cpu", "process", vdif, "--rate", "1000000",
                  "--freq-top", "320.5", "--bandwidth", "0.5", "--ndm", "61",
                  "-o", out_dir])
    got = json.loads(buf.getvalue())
    assert got["seconds"] == 2 and got["candidates"]
    from vlite_fast_tpu_torch.runtime.control import Command
    from vlite_fast_tpu_torch.runtime.station_main import StationDaemon
    d = StationDaemon(3, PipelineConfig.tiny(freq_top_mhz=320.5,
                                             bandwidth_mhz=0.5),
                      SearchConfig.tiny(), out_dir, command_port=None,
                      coincidencer=None, trigger_port=None, device="cpu")
    d._pending_cmds = [(Command.START, None)]
    try:
        d.serve("file:" + vdif, poll_s=0.01, max_observations=1)
    finally:
        d.shutdown()
    assert d.summary["seconds"] == 2
    from vlite_fast_tpu_torch.utils import vdif as tvdif
    dumps = os.path.join(out_dir, "offline")
    os.makedirs(dumps)
    common = rng.standard_normal(100_000 + 64)
    for k in range(3):
        x = np.stack([common[4 * k:4 * k + 100_000]] * 2) \
            + 0.5 * rng.standard_normal((2, 100_000))
        tvdif.streams_to_frames(
            np.clip(x * 12.8 + 128.5, 0, 255).astype(np.uint8), 40, 9,
            station_id=k + 1, sample_rate=1_000_000).tofile(
            os.path.join(dumps, f"a{k}.vdif"))
    pos = os.path.join(out_dir, "pos.json")
    with open(pos, "w") as fh:
        json.dump({"1": [0, 0, 0], "2": [900, 0, 0], "3": [0, 900, 0]}, fh)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["--device", "cpu", "localize", dumps, "--positions", pos,
                  "--nfft", "500", "--sample-rate", "1000000"])
    assert json.loads(buf.getvalue().splitlines()[-1])["n_baselines"] == 3
import torch.distributed as dist
from vlite_fast_tpu_torch.parallel.distributed import init_distributed
from vlite_fast_tpu_torch.parallel.mesh import make_mesh
from vlite_fast_tpu_torch.parallel import sharded_pipeline as sp
assert init_distributed(device="cpu")["process_count"] == 1
acfg1 = dataclasses.replace(ArrayConfig.tiny(nant=2),
                            pipeline=PipelineConfig.tiny(sample_rate=100_000))
mesh = make_mesh()
step_fn, make_inputs, plan, info = sp.build_array_step(acfg1, mesh,
                                                       nsec_per_call=2)
out, state = step_fn(*make_inputs(seed=0))
full = sp.gather_step_output(out, mesh)
assert full.packed_kur.shape == (2, info.T, 192)
sp.extract_candidates(full, info, acfg1.search)
dist.destroy_process_group()
loaded = {m.split(".")[0] for m, mod in sys.modules.items() if mod is not None}
assert not loaded & {"jax", "vlite_fast_tpu"}, loaded
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
    assert int(res.stdout.split()[1]) >= 65     # every submodule imported
