"""End-to-end smoke of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing a line:
  0. device: requires CUDA; the card's name and power limit (nvidia-smi);
  1. build: every CUDA library from vlite_fast_tpu_torch/csrc, one nvcc
     each, all started together;
  2. the chain kernel (ops/megakernel.chain_second_v2) against its plain
     version on the card: two consecutive full-geometry seconds
     (PipelineConfig(), rfi_mode 2) of Gaussian 8-bit noise with a
     sinusoidal burst in one pol;
  3. the dedispersion kernel (ops/dedisperse_pallas.dedisperse_pallas)
     against its plain version on one production gulp with the
     tolerance-grid plan;
  4. the main path: StationPipeline over 40 s of one antenna
     (PipelineConfig(inject_frb=True), SearchConfig()), the injected FRB
     recovered, every twin second through the chain kernel, every armed
     second through the RFI front and both EMA kernels, and every gulp
     through the dedispersion kernel (launch counts); peak device memory;
  5. the RFI front kernel (ops/rfi_pallas.rfi_front) against its plain
     version on one full-geometry second with the burst;
  6. both EMA kernels (ops/pallas_kernels) against their plain versions
     on a full second's (2, 10240, 6251) power block, time_tile 32;
  7. one armed full-geometry second and the next (PipelineConfig(
     inject_frb=True), armed at the first) through process_second, the
     three kernels, against process_second_plain on torch ops;
then one JSON line of per-kernel results, and last
{"ok": true, "device": {...}}.  Any failure exits non-zero before that.
Imports no jax.  Data comes from seeded numpy and torch generators.
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
    _build.load_all()
    took = ", ".join(f"{n} {s:.1f} s" if s else f"{n} already built"
                     for n, s in _build.BUILD_SECONDS.items())
    log(f"[1] build: {took} (in parallel, total "
        f"{time.perf_counter() - t0:.1f} s, nvcc sm_90a)")


def levels_check(got, want, worst: dict, what: str) -> None:
    """The chain bar on (packed, packed_kur, weights, dag_frac, bp):
    >= 0.9999 of 2-bit levels agree, none off by more than one, weights
    equal, dag_frac within 1e-6, bandpass within 1e-4 relative."""
    for g, w in zip(got[:2], want[:2]):
        lg, lw = levels(g), levels(w)
        agree = float((lg == lw).mean())
        worst["agree"] = min(worst["agree"], agree)
        worst["dlev"] = max(worst["dlev"], int(np.abs(lg - lw).max()))
        check(agree >= 0.9999, f"{what}: 2-bit agreement {agree}")
        check(int(np.abs(lg - lw).max()) <= 1, f"{what}: level off by > 1")
    check(torch.equal(got[2], want[2]), f"{what}: weights differ")
    check(float(got[2].mean()) < 1.0, f"{what}: the kurtosis gates did "
          "not fire")
    dag = float((got[3] - want[3]).abs().max())
    worst["dag"] = max(worst["dag"], dag)
    check(dag <= 1e-6, f"{what}: dag_frac off by {dag}")
    for g, w in zip(got[4], want[4]):
        rel = float(((g - w).abs() / w.abs().clamp(min=1e-6)).max())
        worst["bp_rel"] = max(worst["bp_rel"], rel)
        check(rel < 1e-4, f"{what}: bandpass off by {rel} relative")


def phase_chain(dev, raws) -> dict:
    from vlite_fast_tpu_torch import PipelineConfig
    from vlite_fast_tpu_torch.ops import megakernel as mk
    cfg = PipelineConfig()
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
        levels_check(got, want, worst, f"chain second {sec}")
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
    from vlite_fast_tpu_torch import PipelineConfig, SearchConfig
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


def _counts() -> dict:
    from vlite_fast_tpu_torch.ops import dedisperse_pallas as ddp
    from vlite_fast_tpu_torch.ops import megakernel as mk
    from vlite_fast_tpu_torch.ops import pallas_kernels as pk
    from vlite_fast_tpu_torch.ops import rfi_pallas
    return {"chain_second_v2": mk.LAUNCHES,
            "dedisperse_pallas": ddp.LAUNCHES,
            "rfi_front": rfi_pallas.LAUNCHES, **pk.LAUNCHES}


def _zero_counts() -> None:
    from vlite_fast_tpu_torch.ops import dedisperse_pallas as ddp
    from vlite_fast_tpu_torch.ops import megakernel as mk
    from vlite_fast_tpu_torch.ops import pallas_kernels as pk
    from vlite_fast_tpu_torch.ops import rfi_pallas
    mk.LAUNCHES = ddp.LAUNCHES = rfi_pallas.LAUNCHES = 0
    pk.LAUNCHES.update(dict.fromkeys(pk.LAUNCHES, 0))


ARMED_KERNELS = ("rfi_front", "normalize_ema_pallas",
                 "normalize_ema_weighted_pallas")


def phase_main_path(dev) -> dict:
    from vlite_fast_tpu_torch import PipelineConfig, SearchConfig
    from vlite_fast_tpu_torch.models import baseband_dsp as dsp
    from vlite_fast_tpu_torch.runtime.pipeline import (ObservationDocument,
                                                       StationPipeline)
    cfg, scfg = PipelineConfig(inject_frb=True), SearchConfig()
    rng = np.random.default_rng(0)
    staged = [torch.from_numpy(np.clip(
        rng.standard_normal((cfg.npol_in, cfg.sample_rate)) / 0.05914
        + 128.5, 0, 255).astype(np.uint8)).to(dev) for _ in range(3)]
    out_dir = tempfile.mkdtemp(prefix="vfast_smoke_")
    n_sec = 40
    per_sec = []                # kernel launches in each fed second
    try:
        pipe = StationPipeline(1, cfg, scfg, out_dir=out_dir,
                               keep_ring=False, write_cands=False,
                               device=dev)
        od = ObservationDocument(name="SMOKE", start_time=1.7e9)
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_counts()
        t0 = time.perf_counter()
        pipe.begin_observation(od, write_fil=False)
        for sec in range(n_sec):
            before = _counts()
            pipe.feed_second(1.7e9 + sec, staged[sec % 3])
            per_sec.append({k: v - before[k] for k, v in _counts().items()})
        prod = pipe.end_observation()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts()
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    armed, twin = pipe.feed_seconds["armed"], pipe.feed_seconds["twin"]
    gulps = int(pipe.metrics.get("vfast_gulps_searched"))
    window = dsp.inject_window_seconds(cfg)
    check(prod.seconds == n_sec, f"{prod.seconds} seconds processed")
    check(len(armed) == window, f"{len(armed)} armed seconds")
    for sec, n in enumerate(per_sec):
        if sec < window:        # armed at second 0
            ok = n["chain_second_v2"] == 0 and all(
                n[k] == 1 for k in ARMED_KERNELS)
        else:
            ok = n["chain_second_v2"] == 1 and not any(
                n[k] for k in ARMED_KERNELS)
        check(ok, f"second {sec} ({'armed' if sec < window else 'twin'}) "
              f"launched {n}")
    check(launches["chain_second_v2"] == len(twin) == n_sec - len(armed),
          f"chain kernel launches {launches} vs {len(twin)} twin seconds")
    check(all(launches[k] == len(armed) for k in ARMED_KERNELS),
          f"armed kernel launches {launches} vs {len(armed)} armed seconds")
    check(gulps >= 1 and launches["dedisperse_pallas"] == gulps,
          f"dedispersion launches {launches} vs {gulps} gulps")
    near = [c for c in prod.candidates
            if abs(c.dm - cfg.inject_dm) <= 0.1 * cfg.inject_dm]
    best = max(near, key=lambda c: c.snr) if near else None
    top = max(prod.candidates, key=lambda c: c.snr) \
        if prod.candidates else None
    check(best is not None and best.snr >= 10.0,
          f"injected FRB not recovered: best near DM 80 {best}, top {top}")
    log(f"[4] main path: {prod.seconds} s of one antenna in {wall:.1f} s "
        f"wall, real-time factor {n_sec / wall:.3f}; per data-second "
        f"armed {', '.join(f'{1e3 * a:.1f}' for a in armed)} ms, twin "
        f"{1e3 * np.mean(twin):.1f} ms x{len(twin)} (median "
        f"{1e3 * np.median(twin):.1f}); {gulps} gulps; FRB at DM "
        f"{best.dm:.2f} S/N {best.snr:.2f} (top candidate DM {top.dm:.2f} "
        f"S/N {top.snr:.2f}, {len(prod.candidates)} candidates); peak "
        f"device memory {peak:.2f} GiB; launches {launches} (each armed "
        f"second: rfi_front and both EMA kernels once; each twin second: "
        f"the chain kernel once)")
    for c in sorted(prod.candidates, key=lambda c: -c.snr)[:5]:
        log(f"[4]   candidate DM {c.dm:.2f} S/N {c.snr:.2f} at "
            f"{c.peak_time:.3f} s, width 2^{c.tfilt}, {c.ngiant} crossings")
    return launches


def phase_rfi_front(dev, raw) -> dict:
    from vlite_fast_tpu_torch import PipelineConfig
    from vlite_fast_tpu_torch.ops import rfi_pallas
    cfg = PipelineConfig()
    args = (cfg.nkurto, cfg.nfft, cfg.dag_thresh, cfg.dag_fb_thresh)
    got = rfi_pallas.rfi_front(raw, *args)
    want, plain_ms = timed_wall(lambda: rfi_pallas.rfi_front_plain(raw,
                                                                   *args))
    check(torch.equal(got[0], want[0]), "rfi_front: masked voltages differ")
    check(torch.equal(got[1], want[1]), "rfi_front: weights differ")
    flags = got[2] >= cfg.dag_thresh
    check(torch.equal(flags, want[2] >= cfg.dag_thresh),
          "rfi_front: fine-window flags differ")
    err = float((got[2] - want[2]).abs().max())
    check(err <= 1e-5, f"rfi_front: TS off by {err}")
    nflag, wmin = int(flags.sum()), float(got[1].min())
    check(nflag > 0 and wmin < 1.0, "rfi_front: the gates did not fire")
    del got, want
    ms = cuda_ms(lambda: rfi_pallas.rfi_front(raw, *args), 5)
    log(f"[5] rfi_front kernel vs plain, one full-geometry second "
        f"({tuple(raw.shape)} u8, nkurto {cfg.nkurto}, nfft {cfg.nfft}): "
        f"masked voltages, weights and flags equal ({nflag} windows "
        f"flagged, min weight {wmin:.3f}), TS max abs diff {err:.2e} "
        f"(bar 1e-5); kernel {ms:.3f} ms (CUDA events, 5 reps), plain "
        f"{plain_ms:.0f} ms (wall)")
    return {"name": "rfi_front", "route": "cuda",
            "source": "vlite_fast_tpu_torch/csrc/rfi_front.cu",
            "replaces": "vlite_fast_tpu/ops/rfi_pallas.py:133",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_ema(dev) -> list:
    from vlite_fast_tpu_torch import PipelineConfig
    from vlite_fast_tpu_torch.ops import normalize as norm_ops
    from vlite_fast_tpu_torch.ops import pallas_kernels as pk
    cfg = PipelineConfig()
    npol, ntime, tt = 2, cfg.seg_per_sec * cfg.ffts_per_seg, cfg.ffts_per_seg
    gen = torch.Generator(device=dev).manual_seed(7)
    shape = (npol, ntime, cfg.nchan)
    # chi-square power with 2 degrees of freedom, a dead spectrum, a
    # clipped one and a 10x step one segment long
    power = (torch.randn(shape, generator=gen, device=dev) ** 2
             + torch.randn(shape, generator=gen, device=dev) ** 2)
    power[:, 100] = 0.0
    power[0, 200] *= 400.0
    power[:, 3200:3232] *= 10.0
    weights = torch.ones((npol, ntime), device=dev)
    weights[:, 300] = 0.0
    weights[1, 500:520] = 0.5
    bp = torch.zeros((npol, cfg.nchan), device=dev)
    s = cfg.bp_scale
    cases = [("normalize_ema_pallas", ":102",
              lambda: pk.normalize_ema_pallas(power, bp, s, time_tile=tt),
              lambda: norm_ops.normalize_ema(power, bp, s, tt)),
             ("normalize_ema_weighted_pallas", ":189",
              lambda: pk.normalize_ema_weighted_pallas(
                  power, weights, bp, s, time_tile=tt),
              lambda: norm_ops.normalize_ema_weighted(
                  power, weights, bp, s, time_tile=tt))]
    rows = []
    for name, line, kernel, plain in cases:
        got = kernel()
        want, plain_ms = timed_wall(plain)
        err, bitwise = 0.0, True
        for g, w in zip(got, want):
            err = max(err, float((g - w).abs().max()))
            bitwise = bitwise and torch.equal(g, w)
            check(torch.allclose(g, w, rtol=2e-6, atol=2e-6),
                  f"{name}: differs from plain by {err}")
        del got, want
        ms = cuda_ms(kernel, 5)
        log(f"[6] {name} kernel vs plain, {shape} f32, time_tile {tt}: max "
            f"abs diff {err:.2e} (allclose rtol 2e-6 atol 2e-6), bit-equal "
            f"{bitwise}; kernel {ms:.2f} ms (CUDA events, 5 reps), plain "
            f"{plain_ms:.0f} ms (wall)")
        rows.append({"name": name, "route": "cuda",
                     "source": "vlite_fast_tpu_torch/csrc/ema.cu",
                     "replaces": "vlite_fast_tpu/ops/pallas_kernels.py"
                                 + line,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    return rows


def phase_armed(dev, raws) -> None:
    from vlite_fast_tpu_torch import PipelineConfig
    from vlite_fast_tpu_torch.models import baseband_dsp as dsp
    cfg = PipelineConfig(inject_frb=True)
    st_k = st_p = dsp.init_state(cfg, dev)
    worst = {"agree": 1.0, "dlev": 0, "bp_rel": 0.0, "dag": 0.0}
    t_kern, t_plain = [], []
    for sec, raw in enumerate(raws):
        arm = sec == 0
        (got, nst_k), ms_k = timed_wall(
            lambda: dsp.process_second(cfg, raw, st_k, arm))
        (want, nst_p), ms_p = timed_wall(
            lambda: dsp.process_second_plain(cfg, raw, st_p, arm))
        t_kern.append(ms_k)
        t_plain.append(ms_p)
        levels_check(
            (got.packed, got.packed_kur, got.weights, got.dag_frac,
             (nst_k.bp, nst_k.bp_kur)),
            (want.packed, want.packed_kur, want.weights, want.dag_frac,
             (nst_p.bp, nst_p.bp_kur)), worst, f"armed second {sec}")
        check(nst_k.segs_since_inject == nst_p.segs_since_inject,
              "armed: injection clock differs")
        st_k, st_p = nst_k, nst_p
    ms = cuda_ms(lambda: dsp.process_second(cfg, raws[0], st_k, True), 3)
    log(f"[7] armed program (process_second: rfi_front, torch.matmul "
        f"channelize, both EMA kernels) vs process_second_plain, 2 "
        f"full-geometry seconds armed at the first: 2-bit agreement >= "
        f"{worst['agree']:.6f} (bar 0.9999), max level diff "
        f"{worst['dlev']}, weights equal, dag_frac diff {worst['dag']:.2e}, "
        f"bandpass rel diff {worst['bp_rel']:.2e}; kernel path "
        f"{t_kern[0]:.1f} / {t_kern[1]:.1f} ms (wall), {ms:.1f} ms per "
        f"second (CUDA events, 3 reps), plain {t_plain[0]:.0f} / "
        f"{t_plain[1]:.0f} ms (wall)")


def main() -> None:
    smi = phase_device()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    from vlite_fast_tpu_torch import PipelineConfig
    nsamp = PipelineConfig().sample_rate
    raws = [torch.from_numpy(with_burst(noise_uint8(nsamp, s),
                                        40_000_000)).to(dev) for s in (5, 6)]
    k_chain = phase_chain(dev, raws)
    k_dedisp = phase_dedisperse(dev)
    torch.cuda.empty_cache()
    launches = phase_main_path(dev)
    k_rfi = phase_rfi_front(dev, raws[0])
    k_ema = phase_ema(dev)
    torch.cuda.empty_cache()
    phase_armed(dev, raws)
    kernels = [k_chain, k_dedisp, k_rfi, *k_ema]
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
