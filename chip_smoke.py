"""End-to-end smoke of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing a line:
  0. device: requires CUDA; the card's name and power limit (nvidia-smi);
  1. build: both CUDA kernels from vlite_fast_tpu_torch/csrc with nvcc;
  2. the chain kernel (ops/megakernel.chain_second_v2) against its plain
     version on the card: two consecutive full-geometry seconds
     (PipelineConfig(), rfi_mode 2) of Gaussian 8-bit noise with a
     sinusoidal burst in one pol;
  3. the dedispersion kernel (ops/dedisperse_pallas.dedisperse_pallas)
     against its plain version on one production gulp with the
     tolerance-grid plan;
  4. the main path: StationPipeline over 40 s of one antenna
     (PipelineConfig(inject_frb=True), SearchConfig()), the injected FRB
     recovered, every twin second through the chain kernel and every
     gulp through the dedispersion kernel (launch counts);
then one JSON line of per-kernel results, and last
{"ok": true, "device": {...}}.  Any failure exits non-zero before that.
Imports no jax.  Data comes from seeded numpy generators.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    """A failed check ends the run (not an assert: -O would drop it)."""
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def noise_uint8(nsamp: int, seed: int, npol: int = 2) -> np.ndarray:
    """Flag-free Gaussian 8-bit voltages (models/synthesis.
    white_noise_uint8 of the JAX package)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((npol, nsamp)).astype(np.float32)
    return np.clip(x / 0.02957 / 2 + 128.5, 0, 255).astype(np.uint8)


def with_burst(raw: np.ndarray, at: int) -> np.ndarray:
    """A sinusoidal burst in pol 0 so that the kurtosis gates fire."""
    t = np.arange(3000)
    out = raw.astype(np.int16)
    out[0, at:at + 3000] += (60 * np.sin(0.3 * t)).astype(np.int16)
    return np.clip(out, 0, 255).astype(np.uint8)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call over `reps` calls (after one
    warm call), timed with CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_wall(fn):
    """(fn(), wall milliseconds) with the device synchronised around it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def levels(packed: torch.Tensor) -> np.ndarray:
    from vlite_fast_tpu_torch.ops import quantize as q
    return q.unpack_bits(packed.cpu(), 2).numpy().astype(np.int16)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[0] device: {smi}")
    log(f"[0] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} "
        f"device_count {torch.cuda.device_count()}")
    return smi


def phase_build() -> None:
    from vlite_fast_tpu_torch import _build
    t0 = time.perf_counter()
    for name in ("chain", "dedisperse"):
        _build.load(name)
    took = {n: (f"{s:.1f} s" if s else "already built")
            for n, s in _build.BUILD_SECONDS.items()}
    log(f"[1] build: chain {took['chain']}, dedisperse {took['dedisperse']}"
        f" (total {time.perf_counter() - t0:.1f} s, nvcc sm_90a)")


def phase_chain(dev) -> dict:
    from vlite_fast_tpu.config import PipelineConfig
    from vlite_fast_tpu_torch.ops import megakernel as mk
    cfg = PipelineConfig()
    raws = [torch.from_numpy(with_burst(noise_uint8(cfg.sample_rate, s),
                                        40_000_000)).to(dev)
            for s in (5, 6)]
    bp_k = torch.zeros((2, 2, cfg.nchan), device=dev)
    bp_p = bp_k.clone()
    worst = {"agree": 1.0, "dlev": 0, "bp_rel": 0.0, "dag": 0.0}
    t_plain = []
    for sec, raw in enumerate(raws):
        want, ms_plain = timed_wall(
            lambda: mk.chain_second_v2_plain(raw, bp_p, cfg))
        t_plain.append(ms_plain)
        got = mk.chain_second_v2(raw, bp_k, cfg)
        torch.cuda.synchronize()
        for g, w in zip(got[:2], want[:2]):
            lg, lw = levels(g), levels(w)
            agree = float((lg == lw).mean())
            worst["agree"] = min(worst["agree"], agree)
            worst["dlev"] = max(worst["dlev"], int(np.abs(lg - lw).max()))
            check(agree >= 0.9999, f"second {sec}: 2-bit agreement {agree}")
        check(torch.equal(got[2], want[2]), f"second {sec}: weights differ")
        check(float(got[2].mean()) < 1.0, "the kurtosis gates did not fire")
        dag = float((got[3] - want[3]).abs().max())
        worst["dag"] = max(worst["dag"], dag)
        check(dag <= 1e-6, f"second {sec}: dag_frac off by {dag}")
        bw = want[4]
        rel = float(((got[4] - bw).abs() / bw.abs().clamp(min=1e-6)).max())
        worst["bp_rel"] = max(worst["bp_rel"], rel)
        check(rel < 1e-4, f"second {sec}: bandpass off by {rel} relative")
        bp_k, bp_p = got[4], want[4]
    ms = cuda_ms(lambda: mk.chain_second_v2(raws[0], bp_k, cfg), 5)
    log(f"[2] chain kernel vs plain, 2 full-geometry seconds: 2-bit "
        f"agreement >= {worst['agree']:.6f} (bar 0.9999), max level diff "
        f"{worst['dlev']}, weights equal, dag_frac diff {worst['dag']:.2e}, "
        f"bandpass rel diff {worst['bp_rel']:.2e}; kernel {ms:.2f} ms per "
        f"data-second (CUDA events, 5 reps), plain "
        f"{t_plain[0]:.0f} / {t_plain[1]:.0f} ms (wall)")
    return {"name": "chain_second_v2", "route": "cuda",
            "source": "vlite_fast_tpu_torch/csrc/chain.cu",
            "replaces": "vlite_fast_tpu/ops/megakernel.py:1602",
            "max_abs_err": worst["dlev"], "agree_2bit": worst["agree"],
            "bp_rel_err": worst["bp_rel"], "ms": ms,
            "plain_ms": min(t_plain)}


def phase_dedisperse(dev) -> dict:
    from vlite_fast_tpu.config import PipelineConfig, SearchConfig
    from vlite_fast_tpu_torch.models import search
    from vlite_fast_tpu_torch.ops import dedisperse as dd
    from vlite_fast_tpu_torch.ops import dedisperse_pallas as ddp
    cfg, scfg = PipelineConfig(), SearchConfig()
    eng = search.SinglePulseSearch(scfg, cfg.tsamp, cfg.freqs_mhz(),
                                   nsub=128, nbatch=128, device=dev)
    plan = eng.plan
    full = scfg.gulp_samps + eng.overlap
    ntime_out = full - plan.max_delay
    rng = np.random.default_rng(11)
    fb = torch.from_numpy(rng.standard_normal(
        (full, cfg.nchanout)).astype(np.float32)).to(dev)
    got = ddp.dedisperse_pallas(fb, plan, ntime_out)
    want, plain_ms = timed_wall(lambda: dd.dedisperse(fb, plan, ntime_out))
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=1e-5, atol=1e-3),
          f"dedispersion kernel differs from plain: max abs {err}")
    ms = cuda_ms(lambda: ddp.dedisperse_pallas(fb, plan, ntime_out), 3)
    ndm = len(plan.dms)
    log(f"[3] dedispersion kernel vs plain, production gulp ({full} x "
        f"{cfg.nchanout}, {ndm} tol-grid trials, nsub {plan.nsub}, "
        f"per_batch {ndm // plan.rel_delays.shape[0]}): max abs diff "
        f"{err:.3e} (allclose rtol 1e-5 atol 1e-3); kernel {ms:.2f} ms "
        f"(CUDA events, 3 reps), plain {plain_ms:.0f} ms (wall)")
    return {"name": "dedisperse_pallas", "route": "cuda",
            "source": "vlite_fast_tpu_torch/csrc/dedisperse.cu",
            "replaces": "vlite_fast_tpu/ops/dedisperse_pallas.py:333",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_main_path(dev) -> dict:
    from vlite_fast_tpu import constants as C
    from vlite_fast_tpu.config import PipelineConfig, SearchConfig
    from vlite_fast_tpu_torch.models import baseband_dsp as dsp
    from vlite_fast_tpu_torch.ops import dedisperse_pallas as ddp
    from vlite_fast_tpu_torch.ops import megakernel as mk
    from vlite_fast_tpu_torch.runtime.pipeline import (ObservationDocument,
                                                       StationPipeline)
    cfg, scfg = PipelineConfig(inject_frb=True), SearchConfig()
    rng = np.random.default_rng(0)
    staged = [torch.from_numpy(np.clip(
        rng.standard_normal((cfg.npol_in, cfg.sample_rate)) / 0.05914
        + 128.5, 0, 255).astype(np.uint8)).to(dev) for _ in range(3)]
    out_dir = tempfile.mkdtemp(prefix="vfast_smoke_")
    n_sec = 40
    try:
        pipe = StationPipeline(1, cfg, scfg, out_dir=out_dir,
                               keep_ring=False, write_cands=False,
                               device=dev)
        od = ObservationDocument(name="SMOKE", start_time=1.7e9)
        mk.LAUNCHES = 0
        ddp.LAUNCHES = 0
        t0 = time.perf_counter()
        prod = pipe.run_observation(
            ((1.7e9 + s, staged[s % 3]) for s in range(n_sec)), od,
            write_fil=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"chain_second_v2": mk.LAUNCHES,
                    "dedisperse_pallas": ddp.LAUNCHES}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    armed, twin = pipe.feed_seconds["armed"], pipe.feed_seconds["twin"]
    gulps = int(pipe.metrics.get("vfast_gulps_searched"))
    check(prod.seconds == n_sec, f"{prod.seconds} seconds processed")
    check(len(armed) == dsp.inject_window_seconds(cfg),
          f"{len(armed)} armed seconds")
    check(launches["chain_second_v2"] == len(twin) == n_sec - len(armed),
          f"chain kernel launches {launches} vs {len(twin)} twin seconds")
    check(gulps >= 1 and launches["dedisperse_pallas"] == gulps,
          f"dedispersion launches {launches} vs {gulps} gulps")
    near = [c for c in prod.candidates
            if abs(c.dm - C.INJECT_DM) <= 0.1 * C.INJECT_DM]
    best = max(near, key=lambda c: c.snr) if near else None
    top = max(prod.candidates, key=lambda c: c.snr) \
        if prod.candidates else None
    check(best is not None and best.snr >= 10.0,
          f"injected FRB not recovered: best near DM 80 {best}, top {top}")
    log(f"[4] main path: {prod.seconds} s of one antenna in {wall:.1f} s "
        f"wall, real-time factor {n_sec / wall:.3f}; per data-second "
        f"armed {1e3 * np.mean(armed):.0f} ms x{len(armed)}, twin "
        f"{1e3 * np.mean(twin):.1f} ms x{len(twin)} (median "
        f"{1e3 * np.median(twin):.1f}); {gulps} gulps; FRB at DM "
        f"{best.dm:.2f} S/N {best.snr:.2f} (top candidate DM {top.dm:.2f} "
        f"S/N {top.snr:.2f}, {len(prod.candidates)} candidates); launches "
        f"{launches}")
    for c in sorted(prod.candidates, key=lambda c: -c.snr)[:5]:
        log(f"[4]   candidate DM {c.dm:.2f} S/N {c.snr:.2f} at "
            f"{c.peak_time:.3f} s, width 2^{c.tfilt}, {c.ngiant} crossings")
    return launches


def main() -> None:
    smi = phase_device()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    k1 = phase_chain(dev)
    k2 = phase_dedisperse(dev)
    launches = phase_main_path(dev)
    k1["launches"] = launches["chain_second_v2"]
    k2["launches"] = launches["dedisperse_pallas"]
    print(json.dumps({"kernels": [k1, k2]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
