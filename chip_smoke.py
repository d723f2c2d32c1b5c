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
  8. the relayout kernel (ops/megakernel.pallas_pretranspose) against its
     plain version on one full-geometry second: u8 tiles byte-equal, bf16
     tiles value-equal;
  9. the pretransposed chain kernels on phase 2's two seconds against
     phase 2's plain results: chain_second in its three pretranspose
     modes (byte-identical to each other) and chain_second_v4 on u8 and
     bf16 tiles, timed with the relayout counted in;
 10. phase 4's main path once for each twin_chain_impl of the
     pretransposed programs (megakernel, megakernel3, megakernel3f,
     megakernel4): the FRB recovered, and every twin second launching the
     kernels of its program and never chain_second_v2;
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


def _chain_row(name: str, source: str, line: str, worst: dict, ms: float,
               plain_ms: float, **extra) -> dict:
    return {"name": name, "route": "cuda",
            "source": f"vlite_fast_tpu_torch/csrc/{source}",
            "replaces": f"vlite_fast_tpu/ops/megakernel.py:{line}",
            "max_abs_err": worst["dlev"], "agree_2bit": worst["agree"],
            "bp_rel_err": worst["bp_rel"], "ms": ms, "plain_ms": plain_ms,
            **extra}


def phase_chain(dev, raws) -> dict:
    from vlite_fast_tpu_torch import PipelineConfig
    from vlite_fast_tpu_torch.ops import megakernel as mk
    cfg = PipelineConfig()
    bp_k = torch.zeros((2, 2, cfg.nchan), device=dev)
    bp_p = bp_k.clone()
    worst = {"agree": 1.0, "dlev": 0, "bp_rel": 0.0, "dag": 0.0}
    t_plain, gots, wants = [], [], []
    for sec, raw in enumerate(raws):
        want, ms_plain = timed_wall(
            lambda: mk.chain_second_v2_plain(raw, bp_p, cfg))
        t_plain.append(ms_plain)
        got = mk.chain_second_v2(raw, bp_k, cfg)
        torch.cuda.synchronize()
        levels_check(got, want, worst, f"chain second {sec}")
        bp_k, bp_p = got[4], want[4]
        gots.append(got)
        wants.append(want)
    ms = cuda_ms(lambda: mk.chain_second_v2(raws[0], bp_k, cfg), 5)
    log(f"[2] chain kernel vs plain, 2 full-geometry seconds: 2-bit "
        f"agreement >= {worst['agree']:.6f} (bar 0.9999), max level diff "
        f"{worst['dlev']}, weights equal, dag_frac diff {worst['dag']:.2e}, "
        f"bandpass rel diff {worst['bp_rel']:.2e}; kernel {ms:.2f} ms per "
        f"data-second (CUDA events, 5 reps), plain "
        f"{t_plain[0]:.0f} / {t_plain[1]:.0f} ms (wall)")
    return (_chain_row("chain_second_v2", "chain.cu", "1602", worst, ms,
                       min(t_plain)), gots, wants)


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


def phase_pretranspose(dev, raw) -> dict:
    from vlite_fast_tpu_torch import PipelineConfig
    from vlite_fast_tpu_torch.ops import megakernel as mk
    cfg = PipelineConfig()
    args = (raw, cfg.nfft, cfg.npol_in, cfg.seg_per_sec)
    res = {}
    for dtype, what in ((torch.uint8, "u8"), (torch.bfloat16, "bf16")):
        got = mk.pallas_pretranspose(*args, dtype)
        want, plain_ms = timed_wall(
            lambda: mk.pallas_pretranspose_plain(*args, dtype))
        check(got.dtype == dtype and torch.equal(got, want),
              f"pallas_pretranspose {what}: differs from plain")
        shape = tuple(got.shape)
        del got, want
        res[what] = (cuda_ms(lambda: mk.pallas_pretranspose(*args, dtype),
                             5), plain_ms)
    log(f"[8] pallas_pretranspose kernel vs plain, one full-geometry second "
        f"({tuple(raw.shape)} u8 -> {shape} tiles): u8 byte-equal, bf16 "
        f"value-equal; kernel {res['u8'][0]:.3f} ms u8, {res['bf16'][0]:.3f} "
        f"ms bf16 (CUDA events, 5 reps), plain {res['u8'][1]:.0f} / "
        f"{res['bf16'][1]:.0f} ms (wall)")
    return {"name": "pallas_pretranspose", "route": "cuda",
            "source": "vlite_fast_tpu_torch/csrc/pretranspose.cu",
            "replaces": "vlite_fast_tpu/ops/megakernel.py:221",
            "max_abs_err": 0.0, "ms": res["u8"][0], "plain_ms": res["u8"][1],
            "ms_bf16": res["bf16"][0], "plain_ms_bf16": res["bf16"][1]}


def phase_ct_chains(dev, raws, v2_gots, wants, plain_ms) -> list:
    """Kernels B and C on phase 2's seconds, each carrying its own
    bandpass, against phase 2's plain results."""
    from vlite_fast_tpu_torch import PipelineConfig
    from vlite_fast_tpu_torch.ops import megakernel as mk
    cfg = PipelineConfig()
    programs = [(f"chain_second[{m}]",
                 lambda raw, bp, m=m: mk.chain_second(raw, bp, cfg,
                                                      pretranspose=m))
                for m in mk.PRETRANSPOSE]
    programs += [(f"chain_second_v4[{d}]",
                  lambda raw, bp, d=d: mk.chain_second_v4(raw, bp, cfg,
                                                          pre_dtype=d))
                 for d in ("u8", "bf16")]
    outs, worst, ms = {}, {}, {}
    for name, fn in programs:
        bp = torch.zeros((2, 2, cfg.nchan), device=dev)
        w = worst.setdefault(name.split("[")[0], {
            "agree": 1.0, "dlev": 0, "bp_rel": 0.0, "dag": 0.0})
        outs[name] = []
        for sec, raw in enumerate(raws):
            got = fn(raw, bp)
            torch.cuda.synchronize()
            levels_check(got, wants[sec], w, f"{name} second {sec}")
            outs[name].append(got)
            bp = got[4]
        ms[name] = cuda_ms(lambda: fn(raws[0], bp), 5)
    b_modes = [f"chain_second[{m}]" for m in mk.PRETRANSPOSE]
    for name in b_modes[1:]:
        check(all(torch.equal(a, b) for sec in range(len(raws))
                  for a, b in zip(outs[b_modes[0]][sec], outs[name][sec])),
              f"{name} differs from {b_modes[0]}")
    same_v2 = all(torch.equal(a, b) for sec in range(len(raws))
                  for a, b in zip(outs[b_modes[0]][sec], v2_gots[sec]))
    wb, wc = worst["chain_second"], worst["chain_second_v4"]
    log(f"[9] chain_second kernel vs plain, phase 2's 2 seconds: the three "
        f"pretranspose modes byte-identical (and bit-equal to "
        f"chain_second_v2: {same_v2}); 2-bit agreement >= {wb['agree']:.6f}, "
        f"max level diff {wb['dlev']}, weights equal, dag_frac diff "
        f"{wb['dag']:.2e}, bandpass rel diff {wb['bp_rel']:.2e}; per "
        f"data-second with the relayout (CUDA events, 5 reps): "
        + ", ".join(f"{m} {ms[f'chain_second[{m}]']:.2f} ms"
                    for m in mk.PRETRANSPOSE))
    log(f"[9] chain_second_v4 kernel vs plain, same seconds: 2-bit agreement "
        f">= {wc['agree']:.6f}, max level diff {wc['dlev']}, weights equal, "
        f"dag_frac diff {wc['dag']:.2e}, bandpass rel diff "
        f"{wc['bp_rel']:.2e}; per data-second with the relayout (CUDA "
        f"events, 5 reps): u8 {ms['chain_second_v4[u8]']:.2f} ms, bf16 "
        f"{ms['chain_second_v4[bf16]']:.2f} ms; plain {plain_ms:.0f} ms")
    return [_chain_row("chain_second", "chain.cu", "961", wb,
                       ms["chain_second[pallas]"], plain_ms,
                       ms_by_pretranspose={m: ms[f"chain_second[{m}]"]
                                           for m in mk.PRETRANSPOSE}),
            _chain_row("chain_second_v4", "chain_v4.cu", "2048", wc,
                       ms["chain_second_v4[u8]"], plain_ms,
                       ms_bf16=ms["chain_second_v4[bf16]"])]


def _counts() -> dict:
    from vlite_fast_tpu_torch.ops import dedisperse_pallas as ddp
    from vlite_fast_tpu_torch.ops import megakernel as mk
    from vlite_fast_tpu_torch.ops import pallas_kernels as pk
    from vlite_fast_tpu_torch.ops import rfi_pallas
    return {**mk.LAUNCHES, "dedisperse_pallas": ddp.LAUNCHES,
            "rfi_front": rfi_pallas.LAUNCHES, **pk.LAUNCHES}


def _zero_counts() -> None:
    from vlite_fast_tpu_torch.ops import dedisperse_pallas as ddp
    from vlite_fast_tpu_torch.ops import megakernel as mk
    from vlite_fast_tpu_torch.ops import pallas_kernels as pk
    from vlite_fast_tpu_torch.ops import rfi_pallas
    ddp.LAUNCHES = rfi_pallas.LAUNCHES = 0
    for counts in (mk.LAUNCHES, pk.LAUNCHES):
        counts.update(dict.fromkeys(counts, 0))


ARMED_KERNELS = ("rfi_front", "normalize_ema_pallas",
                 "normalize_ema_weighted_pallas")
CHAIN_KERNELS = ("chain_second_v2", "pallas_pretranspose", "chain_second",
                 "chain_second_v4")
# the kernels each twin second launches once, by twin_chain_impl
TWIN_KERNELS = {"auto": ("chain_second_v2",),
                "megakernel": ("chain_second",),
                "megakernel3": ("pallas_pretranspose", "chain_second"),
                "megakernel3f": ("pallas_pretranspose", "chain_second"),
                "megakernel4": ("pallas_pretranspose", "chain_second_v4")}


def phase_main_path(dev, twin: str = "auto", tag: str = "[4]",
                    n_sec: int = 40) -> dict:
    from vlite_fast_tpu_torch import PipelineConfig, SearchConfig
    from vlite_fast_tpu_torch.models import baseband_dsp as dsp
    from vlite_fast_tpu_torch.runtime.pipeline import (ObservationDocument,
                                                       StationPipeline)
    cfg = PipelineConfig(inject_frb=True, twin_chain_impl=twin)
    scfg = SearchConfig()
    rng = np.random.default_rng(0)
    staged = [torch.from_numpy(np.clip(
        rng.standard_normal((cfg.npol_in, cfg.sample_rate)) / 0.05914
        + 128.5, 0, 255).astype(np.uint8)).to(dev) for _ in range(3)]
    out_dir = tempfile.mkdtemp(prefix="vfast_smoke_")
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
    armed = pipe.feed_seconds["armed"]
    gulps = int(pipe.metrics.get("vfast_gulps_searched"))
    window = dsp.inject_window_seconds(cfg)
    check(prod.seconds == n_sec, f"{prod.seconds} seconds processed")
    check(len(armed) == window, f"{len(armed)} armed seconds")
    twin_kernels = TWIN_KERNELS[twin]
    for sec, n in enumerate(per_sec):
        if sec < window:        # armed at second 0
            ok = not any(n[k] for k in CHAIN_KERNELS) and all(
                n[k] == 1 for k in ARMED_KERNELS)
        else:
            ok = all(n[k] == (k in twin_kernels) for k in CHAIN_KERNELS) \
                and not any(n[k] for k in ARMED_KERNELS)
        check(ok, f"{tag} second {sec} "
              f"({'armed' if sec < window else 'twin'}) launched {n}")
    twin_s = pipe.feed_seconds["twin"]
    check(len(twin_s) == n_sec - len(armed) and all(
        launches[k] == (len(twin_s) if k in twin_kernels else 0)
        for k in CHAIN_KERNELS),
        f"chain kernel launches {launches} vs {len(twin_s)} twin seconds")
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
    log(f"{tag} main path, twin_chain_impl={twin!r}: {prod.seconds} s of "
        f"one antenna in {wall:.1f} s wall, real-time factor "
        f"{n_sec / wall:.3f}; per data-second armed "
        f"{', '.join(f'{1e3 * a:.1f}' for a in armed)} ms, twin "
        f"{1e3 * np.mean(twin_s):.1f} ms x{len(twin_s)} (median "
        f"{1e3 * np.median(twin_s):.1f}); {gulps} gulps; FRB at DM "
        f"{best.dm:.2f} S/N {best.snr:.2f} (top candidate DM {top.dm:.2f} "
        f"S/N {top.snr:.2f}, {len(prod.candidates)} candidates); peak "
        f"device memory {peak:.2f} GiB; launches {launches} (each armed "
        f"second: rfi_front and both EMA kernels once; each twin second: "
        f"{' and '.join(twin_kernels)} once)")
    for c in sorted(prod.candidates, key=lambda c: -c.snr)[:5]:
        log(f"{tag}   candidate DM {c.dm:.2f} S/N {c.snr:.2f} at "
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
    k_chain, v2_gots, wants = phase_chain(dev, raws)
    k_dedisp = phase_dedisperse(dev)
    torch.cuda.empty_cache()
    launches = phase_main_path(dev)
    k_rfi = phase_rfi_front(dev, raws[0])
    k_ema = phase_ema(dev)
    torch.cuda.empty_cache()
    phase_armed(dev, raws)
    torch.cuda.empty_cache()
    k_pre = phase_pretranspose(dev, raws[0])
    k_ct = phase_ct_chains(dev, raws, v2_gots, wants, k_chain["plain_ms"])
    del v2_gots, wants
    torch.cuda.empty_cache()
    # the pretransposed programs' kernels count in their own main paths
    for twin in ("megakernel", "megakernel3", "megakernel3f", "megakernel4"):
        got = phase_main_path(dev, twin, "[10]")
        for k in ("pallas_pretranspose", "chain_second", "chain_second_v4"):
            launches[k] += got[k]
        torch.cuda.empty_cache()
    kernels = [k_chain, k_dedisp, k_rfi, *k_ema, k_pre, *k_ct]
    for k in kernels:
        k["launches"] = launches[k["name"]]
        check(k["launches"] > 0, f"{k['name']} never launched on a main "
              "path")
    print(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
