"""End-to-end smoke of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing a line:
  0. device: requires CUDA; the card's name and power limit (nvidia-smi);
  1. build: every CUDA library from vlite_fast_tpu_torch/csrc, one nvcc
     each, all started together;
  2. the chain kernel (ops/megakernel.chain_second_v2: the front, the
     tensor-core DFT of every frame and of the kurtosis stream's blocks
     flagged in part, the two-phase EMA) against its plain version on the
     card: two consecutive full-geometry seconds (PipelineConfig(),
     rfi_mode 2) of Gaussian 8-bit noise with a sinusoidal burst in one
     pol; its launches' device times from a profiler trace and the share
     of kurtosis frames it transformed;
  3. the dedispersion kernel (csrc/dedisperse.cu) against its plain
     version on one production gulp with the tolerance-grid plan, through
     both entries: ops/dedisperse_pallas.dedisperse_pallas on an f32
     filterbank and dedisperse_pallas_packed on packed 2-bit rows (against
     dequantize, then the plain version);
  4. the main path: StationPipeline over 40 s of one antenna
     (PipelineConfig(inject_frb=True), SearchConfig()), prewarmed, the
     injected FRB recovered, every twin second through the chain kernel,
     every armed second through the RFI front and both EMA kernels, and
     every gulp through the dedispersion kernel's packed entry (launch
     counts); the first armed second within 2x of the second, the 'auto'
     twin's median span per second (CUDA events) within 1.3x of phase 2's
     device time per data-second; peak device memory; then one gulp's
     device time by pass (profiler), and the armed program (not armed)
     against the twin on 10 seconds of the smoke's noise, one seed each,
     both carrying their bandpass: 2-bit agreement >= 0.9999 each;
  5. the RFI front kernel (ops/rfi_pallas.rfi_front) against its plain
     version on one full-geometry second with the burst, and on a
     geometry whose blocks are not 16-byte aligned and whose output
     float4s straddle windows (nkurto 45, nfft 630); its TS bit-equal to
     the kernel's first design (stored digests);
  6. both EMA kernels (ops/pallas_kernels) against their plain versions
     on a full second's (2, 10240, 6251) power block, time_tile 32, each
     bit-equal;
  7. one armed full-geometry second and the next (PipelineConfig(
     inject_frb=True), armed at the first) through process_second, the
     three kernels, against process_second_plain on torch ops;
  8. the relayout kernel (ops/megakernel.pallas_pretranspose) against its
     plain version on one full-geometry second: u8 tiles byte-equal, bf16
     tiles value-equal; both timed beside their bounds, the u8 tiles
     beside one PyTorch call that gives them (F.pad of the permuted view);
  9. the pretransposed chain kernels (csrc/chain.cu on the CT-major
     tiles, the same tensor-core DFT as phase 2's) on phase 2's two
     seconds: chain_second in its three pretranspose modes and
     chain_second_v4 on u8 and bf16 tiles, every output bit-identical to
     phase 2's chain_second_v2 and at the chain bar against phase 2's
     plain results, each timed with the relayout counted in;
 10. phase 4's main path once for each twin_chain_impl of the
     pretransposed programs (megakernel, megakernel3, megakernel3f,
     megakernel4): the FRB recovered, every twin second launching the
     kernels of its program and never chain_second_v2, and each
     program's real-time factor;
 11. the staged chain's stage A (ops/megakernel.dft_detect_power, the
     split-plane bf16 DFT on the tensor cores, wgmma fed by bulk copies):
     its path, two production seconds (PipelineConfig(rfi_mode=0,
     dft_exact_input=True)); one against dft_detect_oracle on the card
     (relative error, floor 1e-3, bar 2e-3), timed beside torch.fft.rfft +
     |X|^2 of the same frames;
 12. stage B (ops/megakernel.chain_second_plain): its path, the same two
     seconds with the bandpass carried, against chain_second_plain_oracle
     (2-bit agreement >= 0.9999, bandpass within 1e-4 relative); then the
     JAX package's benchmarks/bench_megakernel_tpu.py: B against
     chain_second_v2 at rfi_mode 0 from a fresh bandpass (the same
     tensor-core DFT on both sides), both timed;
 13. the roll+select dedispersion (ops/dedisperse_pallas.
     dedisperse_pallas_rollsel): phase 3's gulp against its plain version
     (bit-equal: the same adds in the same order) and against phase 3's
     kernel (allclose on every output); then its path, the JAX package's
     benchmarks/bench_ddp_fold_tpu.py A/B on the linear 1024-trial grid,
     both kernels timed;
 14. the tile-transpose microbenchmark (benchmarks/transpose_prims:
     csrc/tile_bench.cu, the JAX package's
     benchmarks/bench_transpose_prims_tpu.py): its path, the script's
     three modes at its shapes (320 steps x 128 tiles), each equal to its
     plain version and timed beside its bound (the adds; for 'mxu' the
     identity products it prescribes, at the bf16 peak);
then the run's wall time, one JSON line of per-kernel results (each with
its time, its plain version's, its bound from this run's shapes, the
library call's time where one PyTorch call computes the function, and
its launches on its path: [4] and [10] for kernels 1-8, [11]-[14] for
the staged chain, the roll+select engine and tile_bench), the card's name
and power
limit, and last
{"ok": true, "device": {...}}.  Any failure exits non-zero before that.
Imports nothing of jax or of the JAX package (checked at the end).  Data
comes from seeded numpy and torch generators.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
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


# the least time the card could take (NVIDIA H100 SXM data sheet, 700 W):
# bytes over the memory rate, operations over the peak for their type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "bf16": 989e12}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved: int, ops: float, kind: str = "f32") -> dict:
    """bound_ms / bound_by for a function that moves `moved` bytes (each
    input read once, each output written once) and does `ops` operations
    of type `kind` (a multiply-add counts two, an add or a compare one)."""
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def tc_dft_ops(cfg, frames: int) -> float:
    """The bf16 products the tensor-core DFT (csrc/dft_tc.cuh) issues for
    `frames` frames, padding included: stage 1 four W1 planes of (64 nwg)
    x (32 npass) x (8 kb1), stage 2 twelve of (64 nwg) x 64 x (32 npass)."""
    from vlite_fast_tpu_torch.ops import megakernel as mk
    g = mk.tc_geometry(cfg.nfft)
    rows, cols = 64 * g.nwg, 32 * g.npass
    return frames * 2 * (4 * rows * cols * 8 * g.kb1 + 12 * rows * 64 * cols)


def chain_bound(cfg, raw, outs) -> dict:
    """The chain's bound: the raw second in and the outputs out, and the
    f32 operations the function needs on this second: a real FFT of each
    frame (2.5 nfft log2 nfft), and ~8 operations per spectrum element
    for detect and EMA in each stream the rfi_mode computes.  In rfi_mode
    2 the kurtosis stream needs a transform of its own only in the frames
    whose mask zeroed a window (weight < 1)."""
    frames = cfg.npol_in * cfg.seg_per_sec * cfg.ffts_per_seg
    nstreams = 2 if cfg.rfi_mode == 2 else 1
    w = outs[2]
    masked = int((w < 1).sum()) if cfg.rfi_mode == 2 else 0
    ops = (frames + masked) * 2.5 * cfg.nfft * math.log2(cfg.nfft) \
        + nstreams * frames * 8 * cfg.nchan
    return bound(nbytes(raw, *outs), ops)


def dft_as_written_ms(cfg, outs) -> float:
    """The chain kernels' own DFT at the bf16 peak, for the log only (a
    count, not a measurement): the tensor-core DFT's padded bf16 products
    on every frame and on the frames of the blocks flagged in part (0 <
    weight < 1)."""
    frames = cfg.npol_in * cfg.seg_per_sec * cfg.ffts_per_seg
    w = outs[2]
    partial = int(((w > 0) & (w < 1)).sum()) if cfg.rfi_mode else 0
    return tc_dft_ops(cfg, frames + partial) / PEAK_OPS_PER_S["bf16"] * 1e3


def kernel_times(fn) -> dict:
    """Device milliseconds of each kernel one call of fn launches, from a
    torch.profiler trace (after a warm call), by the kernel's name; empty
    where the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "device_time_total", None)
            us = e.cuda_time_total if us is None else us
            out[e.key] = out.get(e.key, 0.0) + us / 1e3
    return out


def pick(times: dict, word: str) -> str:
    """The summed device ms of the kernels whose name holds `word`."""
    hit = [v for k, v in times.items() if word in k]
    return f"{sum(hit):.2f} ms" if hit else "not measured"


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
    cb = chain_bound(cfg, raws[0], gots[0])
    written = dft_as_written_ms(cfg, gots[0])
    kt = kernel_times(lambda: mk.chain_second_v2(raws[0], bp_k, cfg))
    w = torch.cat([g[2] for g in gots], dim=1)
    share = float(((w > 0) & (w < 1)).float().mean())
    log(f"[2] chain kernel vs plain, 2 full-geometry seconds: 2-bit "
        f"agreement >= {worst['agree']:.6f} (bar 0.9999), max level diff "
        f"{worst['dlev']}, weights equal, dag_frac diff {worst['dag']:.2e}, "
        f"bandpass rel diff {worst['bp_rel']:.2e}; kernel {ms:.2f} ms per "
        f"data-second (CUDA events, 5 reps): front_kernel "
        f"{pick(kt, 'front_kernel')}, dft_tc_kernel (tensor cores) "
        f"{pick(kt, 'dft_tc_kernel')}, bandpass_kernel "
        f"{pick(kt, 'bandpass_kernel')}, ema_kernel {pick(kt, 'ema_kernel')}"
        f" (profiler); kurtosis frames "
        f"transformed: {100 * share:.2f}% of "
        f"the second's frames (blocks flagged in part, 0 < weight < 1); "
        f"bound {cb['bound_ms']:.3f} ms ({cb['bound_by']}; the tensor-core "
        f"DFT's padded bf16 products {written:.2f} ms at "
        f"the bf16 peak), plain {t_plain[0]:.0f} / {t_plain[1]:.0f} ms "
        f"(wall)")
    return (_chain_row("chain_second_v2", "chain.cu", "1602", worst, ms,
                       min(t_plain), library_ms=None, **cb,
                       kurtosis_frames_share=share,
                       kernel_ms={k[:60]: v for k, v in kt.items()}),
            gots, wants)


def phase_dedisperse(dev) -> dict:
    from vlite_fast_tpu_torch import PipelineConfig, SearchConfig
    from vlite_fast_tpu_torch.models import search
    from vlite_fast_tpu_torch.ops import dedisperse as dd
    from vlite_fast_tpu_torch.ops import dedisperse_pallas as ddp
    from vlite_fast_tpu_torch.ops import quantize as q
    cfg, scfg = PipelineConfig(), SearchConfig()
    eng = search.SinglePulseSearch(scfg, cfg.tsamp, cfg.freqs_mhz(),
                                   nsub=128, nbatch=128, device=dev)
    plan = eng.plan
    full = scfg.gulp_samps + eng.overlap
    ntime_out = full - plan.max_delay
    nchan = cfg.nchanout
    rng = np.random.default_rng(11)
    fb = torch.from_numpy(rng.standard_normal(
        (full, nchan)).astype(np.float32)).to(dev)
    got = ddp.dedisperse_pallas(fb, plan, ntime_out)
    want, plain_ms = timed_wall(lambda: dd.dedisperse(fb, plan, ntime_out))
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=1e-5, atol=1e-3),
          f"dedispersion kernel (f32 entry) differs from plain: max abs {err}")
    del got, want
    # the gulp's own input: packed 2-bit rows, as the chain writes them
    packed = torch.from_numpy(rng.integers(
        0, 256, (full, nchan // 4), dtype=np.uint8)).to(dev)
    got = ddp.dedisperse_pallas_packed(packed, 2, nchan, plan, ntime_out)
    want, plain_packed_ms = timed_wall(
        lambda: ddp.dedisperse_packed_plain(packed, 2, nchan, plan,
                                            ntime_out))
    err_packed = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=1e-5, atol=1e-3),
          f"dedispersion kernel (packed entry) differs from dequantize + "
          f"plain: max abs {err_packed}")
    del got, want
    ms = cuda_ms(lambda: ddp.dedisperse_pallas(fb, plan, ntime_out), 3)
    ms_packed = cuda_ms(lambda: ddp.dedisperse_pallas_packed(
        packed, 2, nchan, plan, ntime_out), 3)
    kt = kernel_times(lambda: ddp.dedisperse_pallas_packed(
        packed, 2, nchan, plan, ntime_out))
    b = dedisp_bound(packed, plan, ntime_out)
    b_f32 = dedisp_bound(fb, plan, ntime_out)
    ndm = len(plan.dms)
    log(f"[3] dedispersion kernel vs plain, production gulp ({full} x "
        f"{nchan}, {ndm} tol-grid trials, nsub {plan.nsub}, per_batch "
        f"{ndm // plan.rel_delays.shape[0]}, sub_spread {plan.sub_spread}): "
        f"max abs diff f32 entry {err:.3e}, packed entry {err_packed:.3e} "
        f"(allclose rtol 1e-5 atol 1e-3); kernel {ms_packed:.2f} ms packed "
        f"(stage1_kernel {pick(kt, 'stage1_kernel')}, stage2_kernel "
        f"{pick(kt, 'stage2_kernel')}, profiler), {ms:.2f} ms f32 (CUDA "
        f"events, 3 reps); bound {b['bound_ms']:.3f} ms ({b['bound_by']}); "
        f"plain {plain_packed_ms:.0f} / {plain_ms:.0f} ms (wall)")
    return {"name": "dedisperse_pallas", "route": "cuda",
            "source": "vlite_fast_tpu_torch/csrc/dedisperse.cu",
            "replaces": "vlite_fast_tpu/ops/dedisperse_pallas.py:333",
            "max_abs_err": max(err, err_packed), "ms": ms_packed,
            "plain_ms": plain_packed_ms, "library_ms": None, **b,
            "ms_f32_entry": ms, "plain_ms_f32_entry": plain_ms,
            "bound_ms_f32_entry": b_f32["bound_ms"],
            "kernel_ms": {k[:60]: v for k, v in kt.items()}}


def dedisp_bound(fb, plan, ntime_out) -> dict:
    """The two-stage shift-and-sum's bound: the input (an f32 filterbank or
    packed rows), the plan's tables and the DM-time plane once each; one add per stage-1 term
    (nbatch x nchan x (ntime_out + max_sub_delay)) and per stage-2 term
    (ndm x nsub x ntime_out)."""
    nbatch, nchan = plan.rel_delays.shape
    ndm, nsub = plan.sub_delays.shape
    ops = nbatch * nchan * (ntime_out + plan.max_sub_delay) \
        + ndm * nsub * ntime_out
    return bound(nbytes(fb, plan.rel_delays, plan.sub_delays,
                        plan.chan_weights) + 4 * ndm * ntime_out, ops)


def phase_pretranspose(dev, raw) -> dict:
    from vlite_fast_tpu_torch import PipelineConfig
    from vlite_fast_tpu_torch.ops import channelize as ch_ops
    from vlite_fast_tpu_torch.ops import megakernel as mk
    cfg = PipelineConfig()
    args = (raw, cfg.nfft, cfg.npol_in, cfg.seg_per_sec)
    n1, n2 = ch_ops._ct_split(cfg.nfft)
    # one PyTorch call for the u8 tiles: pad the permuted view
    library = lambda: torch.nn.functional.pad(
        raw.reshape(cfg.npol_in, cfg.seg_per_sec, -1, n1, n2)
        .permute(1, 0, 2, 4, 3), (0, mk.LANE - n1, 0, mk.LANE - n2))
    res, bounds = {}, {}
    for dtype, what in ((torch.uint8, "u8"), (torch.bfloat16, "bf16")):
        got = mk.pallas_pretranspose(*args, dtype)
        bounds[what] = bound(nbytes(raw, got), 0)
        if dtype == torch.uint8:
            check(torch.equal(library().reshape(got.shape), got),
                  "pallas_pretranspose u8: differs from the padded view")
            lib_ms = cuda_ms(library, 5)
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
        f"value-equal; kernel {res['u8'][0]:.3f} ms u8 (bound "
        f"{bounds['u8']['bound_ms']:.3f} ms, {bounds['u8']['bound_by']}), "
        f"{res['bf16'][0]:.3f} ms bf16 (bound "
        f"{bounds['bf16']['bound_ms']:.3f} ms, {bounds['bf16']['bound_by']}) "
        f"(CUDA events, 5 reps), plain {res['u8'][1]:.0f} / "
        f"{res['bf16'][1]:.0f} ms (wall), F.pad of the permuted view (u8, "
        f"equal) {lib_ms:.3f} ms (CUDA events)")
    return {"name": "pallas_pretranspose", "route": "cuda",
            "source": "vlite_fast_tpu_torch/csrc/pretranspose.cu",
            "replaces": "vlite_fast_tpu/ops/megakernel.py:221",
            "max_abs_err": 0.0, "ms": res["u8"][0], "plain_ms": res["u8"][1],
            "library_ms": lib_ms, **bounds["u8"],
            "ms_bf16": res["bf16"][0], "plain_ms_bf16": res["bf16"][1],
            "bound_ms_bf16": bounds["bf16"]["bound_ms"]}


def phase_ct_chains(dev, raws, v2_gots, wants, plain_ms) -> list:
    """chain_second in its three pretranspose modes and chain_second_v4 on
    u8 and bf16 tiles, on phase 2's seconds, each carrying its own
    bandpass: every output bit-identical to phase 2's chain_second_v2 (the
    same tensor-core DFT on the same bf16 frames), and at the chain bar
    against phase 2's plain results; each timed with its relayout."""
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
    worst, ms = {}, {}
    for name, fn in programs:
        bp = torch.zeros((2, 2, cfg.nchan), device=dev)
        w = worst.setdefault(name.split("[")[0], {
            "agree": 1.0, "dlev": 0, "bp_rel": 0.0, "dag": 0.0})
        for sec, raw in enumerate(raws):
            got = fn(raw, bp)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, v2_gots[sec])),
                  f"{name} second {sec}: outputs differ from "
                  f"chain_second_v2's")
            levels_check(got, wants[sec], w, f"{name} second {sec}")
            bp = got[4]
        ms[name] = cuda_ms(lambda: fn(raws[0], bp), 5)
    wb, wc = worst["chain_second"], worst["chain_second_v4"]
    log(f"[9] chain_second (CT-major tiles, tensor-core DFT), phase 2's 2 "
        f"seconds: the three pretranspose modes bit-identical to "
        f"chain_second_v2 (all five outputs); vs plain 2-bit agreement >= "
        f"{wb['agree']:.6f}, max level diff {wb['dlev']}, weights equal, "
        f"dag_frac diff {wb['dag']:.2e}, bandpass rel diff "
        f"{wb['bp_rel']:.2e}; per data-second with the relayout (CUDA "
        f"events, 5 reps): "
        + ", ".join(f"{m} {ms[f'chain_second[{m}]']:.3f} ms"
                    for m in mk.PRETRANSPOSE))
    log(f"[9] chain_second_v4, same seconds: u8 and bf16 tiles "
        f"bit-identical to chain_second_v2; vs plain 2-bit agreement >= "
        f"{wc['agree']:.6f}, max level diff {wc['dlev']}, weights equal, "
        f"dag_frac diff {wc['dag']:.2e}, bandpass rel diff "
        f"{wc['bp_rel']:.2e}; per data-second with the relayout (CUDA "
        f"events, 5 reps): u8 {ms['chain_second_v4[u8]']:.3f} ms, bf16 "
        f"{ms['chain_second_v4[bf16]']:.3f} ms; plain {plain_ms:.0f} ms")
    cb = chain_bound(cfg, raws[0], wants[0])
    log(f"[9] chain_second / chain_second_v4 bound {cb['bound_ms']:.3f} ms "
        f"({cb['bound_by']}); the tensor-core DFT's padded bf16 products "
        f"{dft_as_written_ms(cfg, v2_gots[0]):.2f} ms at the bf16 peak")
    return [_chain_row("chain_second", "chain.cu", "961", wb,
                       ms["chain_second[pallas]"], plain_ms,
                       library_ms=None, **cb, bit_identical_to_v2=True,
                       ms_by_pretranspose={m: ms[f"chain_second[{m}]"]
                                           for m in mk.PRETRANSPOSE}),
            _chain_row("chain_second_v4", "chain.cu", "2048", wc,
                       ms["chain_second_v4[u8]"], plain_ms,
                       library_ms=None, **cb, bit_identical_to_v2=True,
                       ms_bf16=ms["chain_second_v4[bf16]"])]


def _counts() -> dict:
    from vlite_fast_tpu_torch.benchmarks import transpose_prims as tp
    from vlite_fast_tpu_torch.ops import dedisperse_pallas as ddp
    from vlite_fast_tpu_torch.ops import megakernel as mk
    from vlite_fast_tpu_torch.ops import pallas_kernels as pk
    from vlite_fast_tpu_torch.ops import rfi_pallas
    return {**mk.LAUNCHES, "dedisperse_pallas": ddp.LAUNCHES,
            "dedisperse_pallas_packed": ddp.PACKED_LAUNCHES,
            "dedisperse_pallas_rollsel": ddp.ROLLSEL_LAUNCHES,
            "rfi_front": rfi_pallas.LAUNCHES, **pk.LAUNCHES,
            "tile_bench": tp.LAUNCHES}


def _zero_counts() -> None:
    from vlite_fast_tpu_torch.benchmarks import transpose_prims as tp
    from vlite_fast_tpu_torch.ops import dedisperse_pallas as ddp
    from vlite_fast_tpu_torch.ops import megakernel as mk
    from vlite_fast_tpu_torch.ops import pallas_kernels as pk
    from vlite_fast_tpu_torch.ops import rfi_pallas
    ddp.LAUNCHES = ddp.PACKED_LAUNCHES = ddp.ROLLSEL_LAUNCHES = 0
    rfi_pallas.LAUNCHES = tp.LAUNCHES = 0
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
                    n_sec: int = 40, twin_device_ms: float = None) -> tuple:
    """The main path (twin_device_ms: the twin program's device ms per
    data-second, from phase 2, to hold the twin's spans against): its
    kernel launches and its real-time factor."""
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
        t_pre = time.perf_counter()
        pipe.prewarm()                      # set-up: its launches not counted
        t_pre = time.perf_counter() - t_pre
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
    check(gulps >= 1 and launches["dedisperse_pallas"] == gulps
          and launches["dedisperse_pallas_packed"] == gulps,
          f"dedispersion launches {launches} vs {gulps} gulps (each through "
          f"the packed entry)")
    twin_med = 1e3 * float(np.median(twin_s))
    if twin_device_ms is not None:
        check(armed[0] <= 2.0 * armed[1], f"{tag} first armed second "
              f"{1e3 * armed[0]:.1f} ms > 2x the second {1e3 * armed[1]:.1f}")
        check(twin_med <= 1.3 * twin_device_ms,
              f"{tag} twin median span {twin_med:.2f} ms per second > 1.3x "
              f"its device time {twin_device_ms:.2f} ms")
    near = [c for c in prod.candidates
            if abs(c.dm - cfg.inject_dm) <= 0.1 * cfg.inject_dm]
    best = max(near, key=lambda c: c.snr) if near else None
    top = max(prod.candidates, key=lambda c: c.snr) \
        if prod.candidates else None
    check(best is not None and best.snr >= 10.0,
          f"injected FRB not recovered: best near DM 80 {best}, top {top}")
    vs = f" ({twin_med / twin_device_ms:.3f}x phase 2's " \
        f"{twin_device_ms:.2f} ms)" if twin_device_ms else ""
    log(f"{tag} main path, twin_chain_impl={twin!r}: {prod.seconds} s of "
        f"one antenna in {wall:.1f} s wall ({1e3 * wall / n_sec:.1f} ms per "
        f"second; prewarm {t_pre:.2f} s before it), real-time factor "
        f"{n_sec / wall:.3f}, {wall / (sum(armed) + sum(twin_s)):.3f}x the "
        f"seconds' summed spans; span per data-second (CUDA events) armed "
        f"{', '.join(f'{1e3 * a:.1f}' for a in armed)} ms, twin "
        f"{1e3 * np.mean(twin_s):.2f} ms x{len(twin_s)} (median "
        f"{twin_med:.2f}{vs}); {gulps} gulps; FRB at DM "
        f"{best.dm:.2f} S/N {best.snr:.2f} (top candidate DM {top.dm:.2f} "
        f"S/N {top.snr:.2f}, {len(prod.candidates)} candidates); peak "
        f"device memory {peak:.2f} GiB; launches {launches} (each armed "
        f"second: rfi_front and both EMA kernels once; each twin second: "
        f"{' and '.join(twin_kernels)} once; each gulp: the dedispersion "
        f"kernel's packed entry once)")
    for c in sorted(prod.candidates, key=lambda c: -c.snr)[:5]:
        log(f"{tag}   candidate DM {c.dm:.2f} S/N {c.snr:.2f} at "
            f"{c.peak_time:.3f} s, width 2^{c.tfilt}, {c.ngiant} crossings")
    return launches, n_sec / wall


def phase_gulp_passes(dev) -> None:
    """One production gulp search from packed rows on the device (seeded
    2-bit rows): its device time by pass, each pass timed alone with CUDA
    events on the gulp's own intermediates, and the whole search's wall."""
    from vlite_fast_tpu_torch import PipelineConfig, SearchConfig
    from vlite_fast_tpu_torch.models import search
    from vlite_fast_tpu_torch.ops import dedisperse as dd
    from vlite_fast_tpu_torch.ops import dedisperse_pallas as ddp
    cfg, scfg = PipelineConfig(), SearchConfig()
    eng = search.SinglePulseSearch(scfg, cfg.tsamp, cfg.freqs_mhz(),
                                   device=dev)
    plan, full = eng.plan, scfg.gulp_samps + eng.overlap
    ntime_out = full - plan.max_delay
    rng = np.random.default_rng(12)
    packed = torch.from_numpy(rng.integers(
        0, 256, (full, cfg.nchanout // 4), dtype=np.uint8)).to(dev)
    nchan, k = cfg.nchanout, scfg.topk or min(16 * scfg.max_candidates,
                                                 20000)
    gulp = lambda: search._device_gulp(
        packed, plan, widths=eng.widths, k=k, nbit=cfg.nbit, nchan=nchan,
        nbands=eng.nbands, thresh=float(scfg.snr_thresh))
    torch.cuda.reset_peak_memory_stats(dev)
    total = cuda_ms(gulp, 3)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    _, wall = timed_wall(lambda: eng.search_gulp_device(
        packed, cfg.nbit, 0, scfg.gulp_samps))
    dmt = ddp.dedisperse_pallas_packed(packed, cfg.nbit, nchan, plan,
                                       ntime_out)
    snr = dd.boxcar_snr(dmt, plan.nchan_eff, eng.widths)
    by = {"dedispersion": cuda_ms(lambda: ddp.dedisperse_pallas_packed(
              packed, cfg.nbit, nchan, plan, ntime_out), 3),
          "boxcar S/N": cuda_ms(lambda: dd.boxcar_snr(
              dmt, plan.nchan_eff, eng.widths), 3),
          "banded top-k": cuda_ms(lambda: search.pack_topk_banded(
              snr, k, eng.nbands, float(scfg.snr_thresh)), 3)}
    del dmt, snr
    log(f"[4] one production gulp ({full} packed rows): device "
        f"{total:.2f} ms (CUDA events, 3 reps): "
        + ", ".join(f"{n} {v:.2f} ms" for n, v in by.items())
        + f" (each alone); search_gulp_device wall {wall:.1f} ms; peak "
        f"device memory {peak:.2f} GiB")


def phase_twin_agreement(dev, nseeds: int = 10) -> None:
    """bench.py's A/B of the host gating: the armed program (never armed)
    against the twin on the same seconds, one second of the smoke's noise
    (made on the card) per seed, each program carrying its own bandpass;
    the 2-bit agreement of both streams per second."""
    from vlite_fast_tpu_torch import PipelineConfig
    from vlite_fast_tpu_torch.models import baseband_dsp as dsp
    cfg = PipelineConfig(inject_frb=True)
    twin, twin_cfg = dsp.twin_program(cfg), dsp.twin_config(cfg)
    st_a = st_t = dsp.init_state(cfg, dev)
    agree, dlev = [], 0
    for seed in range(nseeds):
        gen = torch.Generator(device=dev).manual_seed(seed)
        raw = (torch.randn((cfg.npol_in, cfg.sample_rate), generator=gen,
                           device=dev) / 0.05914 + 128.5).clamp(0, 255) \
            .to(torch.uint8)
        out_a, st_a = dsp.process_second(cfg, raw, st_a, False)
        out_t, st_t = twin(twin_cfg, raw, st_t, False)
        res = [agreement(getattr(out_a, f), getattr(out_t, f))
               for f in ("packed", "packed_kur")]
        agree.append(min(r[0] for r in res))
        dlev = max(dlev, *(r[1] for r in res))
        del raw, out_a, out_t
    worst = min(agree)
    check(worst >= 0.9999, f"twin agreement over seeds {agree} (bar 0.9999)")
    log(f"[4] twin agreement, armed program (not armed) vs the "
        f"{twin_cfg.chain_impl!r} twin over {nseeds} seeds, bandpass "
        f"carried: min {worst:.6f}, spread {max(agree) - worst:.2e} (max "
        f"{max(agree):.6f}; bar 0.9999), max level diff {dlev}")


# sha-256 of the fine TS (f32 bytes) that the first design of
# csrc/rfi_front.cu (one byte per lane from device memory, the gates on one
# thread) gave on an H100 for phase 5's two inputs: the redesign keeps
# every sum's order, so its TS are these bits
RFI_TS_SHA256 = {
    "production":
        "31d7033ffd4ccf5a0bb4284c4456ac225a9368d92d1e14bd14003142387de3ce",
    "straddle":
        "d2ff14f1776f71ca77471230bec0003377a025ad28442f7ef40af68a65db0a7f"}


def rfi_inputs(raw) -> list:
    """Phase 5's inputs: (what, u8 second, nkurto, nfft): the production
    second, and its first 203174 blocks of 630 samples at nkurto 45 (7 in
    8 blocks not 16-byte aligned in either array, float4s of the output
    straddling two windows)."""
    from vlite_fast_tpu_torch import PipelineConfig
    cfg = PipelineConfig()
    n = raw.shape[1] // 630 * 630
    return [("production", raw, cfg.nkurto, cfg.nfft),
            ("straddle", raw[:, :n].contiguous(), 45, 630)]


def phase_rfi_front(dev, raw) -> dict:
    from vlite_fast_tpu_torch import PipelineConfig
    from vlite_fast_tpu_torch.ops import rfi_pallas
    cfg = PipelineConfig()
    res = {}
    for what, u, nkurto, nfft in rfi_inputs(raw):
        args = (nkurto, nfft, cfg.dag_thresh, cfg.dag_fb_thresh)
        got = rfi_pallas.rfi_front(u, *args)
        want, plain_ms = timed_wall(
            lambda: rfi_pallas.rfi_front_plain(u, *args))
        check(torch.equal(got[0], want[0]),
              f"rfi_front {what}: masked voltages differ")
        check(torch.equal(got[1], want[1]), f"rfi_front {what}: weights differ")
        flags = got[2] >= cfg.dag_thresh
        check(torch.equal(flags, want[2] >= cfg.dag_thresh),
              f"rfi_front {what}: fine-window flags differ")
        err = float((got[2] - want[2]).abs().max())
        check(err <= 1e-5, f"rfi_front {what}: TS off by {err}")
        digest = hashlib.sha256(got[2].cpu().numpy().tobytes()).hexdigest()
        check(digest == RFI_TS_SHA256[what], f"rfi_front {what}: TS not "
              f"bit-equal to the first design's ({digest})")
        nflag, wmin = int(flags.sum()), float(got[1].min())
        check(nflag > 0 and wmin < 1.0,
              f"rfi_front {what}: the gates did not fire")
        # convert, square, square again and two sums per sample
        rb = bound(nbytes(u, *got), 5 * u.numel())
        del got, want
        res[what] = (cuda_ms(lambda: rfi_pallas.rfi_front(u, *args), 5),
                     plain_ms, rb, err, nflag, wmin)
    ms, plain_ms, rb, err, nflag, wmin = res["production"]
    ms_s, _, rb_s, err_s, nflag_s, _ = res["straddle"]
    log(f"[5] rfi_front kernel vs plain, one full-geometry second "
        f"({tuple(raw.shape)} u8, nkurto {cfg.nkurto}, nfft {cfg.nfft}): "
        f"masked voltages, weights and flags equal ({nflag} windows "
        f"flagged, min weight {wmin:.3f}), TS max abs diff {err:.2e} "
        f"(bar 1e-5), bit-equal to the first design's; kernel {ms:.3f} ms "
        f"(CUDA events, 5 reps), bound {rb['bound_ms']:.3f} ms "
        f"({rb['bound_by']}), plain {plain_ms:.0f} ms (wall); nkurto 45, "
        f"nfft 630 on its first {raw.shape[1] // 630 * 630} samples "
        f"(16-byte misaligned, windows straddling float4s): equal, "
        f"{nflag_s} flagged, TS diff {err_s:.2e}, bit-equal to the first "
        f"design's; kernel {ms_s:.3f} ms, bound {rb_s['bound_ms']:.3f} ms")
    return {"name": "rfi_front", "route": "cuda",
            "source": "vlite_fast_tpu_torch/csrc/rfi_front.cu",
            "replaces": "vlite_fast_tpu/ops/rfi_pallas.py:133",
            "max_abs_err": max(err, err_s), "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, **rb, "ms_straddle": ms_s}


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
    # per element: the EMA's multiply-add pair and the divide and
    # subtract (4); weighted, the divide by the weight and the clip
    # compare besides (6)
    cases = [("normalize_ema_pallas", ":102", (power, bp), 4,
              lambda: pk.normalize_ema_pallas(power, bp, s, time_tile=tt),
              lambda: norm_ops.normalize_ema(power, bp, s, tt)),
             ("normalize_ema_weighted_pallas", ":189", (power, weights, bp),
              6, lambda: pk.normalize_ema_weighted_pallas(
                  power, weights, bp, s, time_tile=tt),
              lambda: norm_ops.normalize_ema_weighted(
                  power, weights, bp, s, time_tile=tt))]
    rows = []
    for name, line, ins, per_elem, kernel, plain in cases:
        got = kernel()
        eb = bound(nbytes(*ins, *got), per_elem * power.numel())
        want, plain_ms = timed_wall(plain)
        err = 0.0
        for g, w in zip(got, want):
            err = max(err, float((g - w).abs().max()))
            check(torch.equal(g, w), f"{name}: not bit-equal to its plain "
                  f"version (max abs diff {err})")
        del got, want
        ms = cuda_ms(kernel, 5)
        log(f"[6] {name} kernel vs plain, {shape} f32, time_tile {tt}: "
            f"bit-equal; kernel {ms:.2f} ms (CUDA events, 5 reps), bound "
            f"{eb['bound_ms']:.3f} ms ({eb['bound_by']}), plain "
            f"{plain_ms:.0f} ms (wall)")
        rows.append({"name": name, "route": "cuda",
                     "source": "vlite_fast_tpu_torch/csrc/ema.cu",
                     "replaces": "vlite_fast_tpu/ops/pallas_kernels.py"
                                 + line,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": None, **eb})
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


def rel_err(got: torch.Tensor, want: torch.Tensor, floor: float) -> float:
    return float(((got - want).abs() / want.abs().clamp(min=floor)).max())


def agreement(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(share of equal 2-bit levels, largest level difference)."""
    la, lb = levels(a), levels(b)
    check(la.shape == lb.shape, f"packed shapes {la.shape} vs {lb.shape}")
    return float((la == lb).mean()), int(np.abs(la - lb).max())


def staged_inputs(dev):
    """The staged chain's configuration and two production seconds of
    uniform bytes 1..255 (the JAX package's tests and GO/NO-GO bench)."""
    from vlite_fast_tpu_torch import PipelineConfig
    cfg = PipelineConfig(rfi_mode=0, dft_exact_input=True)
    rng = np.random.default_rng(5)
    raws = [torch.from_numpy(rng.integers(
        1, 256, size=(cfg.npol_in, cfg.sample_rate), dtype=np.uint8)).to(dev)
        for _ in range(2)]
    return cfg, raws


def phase_stage_a(dev) -> dict:
    """Kernel A: its path (two seconds), then one second against the
    oracle, timed beside torch.fft.rfft."""
    from vlite_fast_tpu_torch.ops import channelize as ch_ops
    from vlite_fast_tpu_torch.ops import megakernel as mk
    from vlite_fast_tpu_torch.ops import unpack as unpack_ops
    cfg, raws = staged_inputs(dev)
    args = (cfg.nfft, cfg.npol_in, cfg.seg_per_sec)
    _zero_counts()
    got = [mk.dft_detect_power(raw, *args) for raw in raws]
    torch.cuda.synchronize()
    launches = mk.LAUNCHES["dft_detect_power"]
    want, plain_ms = timed_wall(lambda: mk.dft_detect_oracle(raws[0], *args))
    check(got[0].shape == want.shape, f"stage A shape {tuple(got[0].shape)}")
    check(bool(torch.isfinite(got[0]).all()), "stage A: non-finite power")
    err = rel_err(got[0], want, 1e-3)
    abs_err = float((got[0] - want).abs().max())
    check(err < 2e-3, f"stage A: relative error {err} (bar 2e-3)")
    n1, n2 = ch_ops._ct_split(cfg.nfft)
    n2o, frames = cfg.nfft // 2 // n1 + 1, got[0].shape[0] * got[0].shape[1]
    # stage 1: 4 real products (n2 x n1 x n1); stage 2: 6 (2 n2o x n2 x n1)
    ops = frames * 2 * (4 * n2 * n1 * n1 + 6 * 2 * n2o * n2 * n1)
    b = bound(nbytes(raws[0], got[0]), ops, "bf16")
    del got, want
    ms = cuda_ms(lambda: mk.dft_detect_power(raws[0], *args), 5)
    x = unpack_ops.convert_uint8(raws[0]).reshape(-1, cfg.nfft)
    lib_ms = cuda_ms(lambda: torch.fft.rfft(x).abs().square(), 5)
    del x
    padded_ms = tc_dft_ops(cfg, frames) / PEAK_OPS_PER_S["bf16"] * 1e3
    log(f"[11] dft_detect_power kernel (wgmma, split-plane bf16) vs "
        f"dft_detect_oracle, one production second ({frames} frames of "
        f"{cfg.nfft}, uniform bytes): max relative error {err:.3e} (floor "
        f"1e-3, bar 2e-3); kernel {ms:.3f} ms (CUDA events, 5 reps), bound "
        f"{b['bound_ms']:.3f} ms ({b['bound_by']}), plain {plain_ms:.0f} ms "
        f"(wall), torch.fft.rfft + |X|^2 {lib_ms:.3f} ms (CUDA events); "
        f"its padded products at the bf16 peak {padded_ms:.3f} ms; "
        f"{launches} launches on its path (2 seconds)")
    return {"name": "dft_detect_power", "route": "cuda",
            "source": "vlite_fast_tpu_torch/csrc/stage_ab.cu",
            "replaces": "vlite_fast_tpu/ops/megakernel.py:349",
            "launches": launches, "max_abs_err": abs_err, "max_rel_err": err,
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, **b}


def phase_stage_b(dev) -> dict:
    """Kernel B: its path (two seconds, bandpass carried) against the
    oracle, then bench_megakernel_tpu.py's A/B against chain_second_v2."""
    from vlite_fast_tpu_torch.ops import megakernel as mk
    cfg, raws = staged_inputs(dev)
    args = (cfg.nfft, cfg.npol_in, cfg.seg_per_sec, cfg.nscrunch,
            float(cfg.bp_scale), cfg.chanmin, cfg.chanmax)
    bp0 = torch.zeros((cfg.npol_in, cfg.nchan), device=dev)
    _zero_counts()
    got, bp = [], bp0
    for raw in raws:
        packed, bp = mk.chain_second_plain(raw, bp, *args)
        got.append((packed, bp))
    torch.cuda.synchronize()
    launches = mk.LAUNCHES["chain_second_plain"]
    worst, dlev, bp_rel, plain_ms, bp_p = 1.0, 0, 0.0, [], bp0
    for sec, raw in enumerate(raws):
        (want, bp_p), ms_p = timed_wall(
            lambda: mk.chain_second_plain_oracle(raw, bp_p, *args))
        plain_ms.append(ms_p)
        a, d = agreement(got[sec][0], want)
        worst, dlev = min(worst, a), max(dlev, d)
        bp_rel = max(bp_rel, rel_err(got[sec][1], bp_p, 1e-6))
    check(worst >= 0.9999, f"stage B: 2-bit agreement {worst}")
    check(bp_rel < 1e-4, f"stage B: bandpass off by {bp_rel} relative")
    ms = cuda_ms(lambda: mk.chain_second_plain(raws[0], bp, *args), 5)
    # benchmarks/bench_megakernel_tpu.py: fresh bandpass on both sides
    pk, _ = mk.chain_second_plain(raws[0], bp0, *args)
    bp2 = torch.zeros((2, cfg.npol_in, cfg.nchan), device=dev)
    v2 = mk.chain_second_v2(raws[0], bp2, cfg)
    torch.cuda.synchronize()
    ab_agree, ab_dlev = agreement(pk, v2[0])
    check(ab_agree >= 0.9999, f"stage B vs chain_second_v2: 2-bit agreement "
          f"{ab_agree}")
    v2_ms = cuda_ms(lambda: mk.chain_second_v2(raws[0], bp2, cfg), 5)
    from vlite_fast_tpu_torch.ops import channelize as ch_ops
    n1, n2 = ch_ops._ct_split(cfg.nfft)
    n2o = cfg.nfft // 2 // n1 + 1
    frames = cfg.npol_in * cfg.seg_per_sec * cfg.ffts_per_seg
    ops = frames * 2 * (4 * n2 * n1 * n1 + 6 * 2 * n2o * n2 * n1)
    b = bound(nbytes(raws[0], bp0, *got[0]), ops, "bf16")
    log(f"[12] chain_second_plain kernel (stage A's DFT + chain.cuh's EMA "
        f"in rfi_mode 0) vs chain_second_plain_oracle, 2 production seconds, "
        f"bandpass carried: 2-bit agreement >= {worst:.6f} (bar 0.9999), max "
        f"level diff {dlev}, bandpass rel diff {bp_rel:.2e} (bar 1e-4); "
        f"kernel {ms:.2f} ms per data-second (CUDA events, 5 reps), bound "
        f"{b['bound_ms']:.3f} ms ({b['bound_by']}), plain "
        f"{plain_ms[0]:.0f} / {plain_ms[1]:.0f} ms (wall); "
        f"bench_megakernel_tpu.py A/B from a fresh bandpass: agreement with "
        f"chain_second_v2 (rfi_mode 0, the same tensor-core DFT) "
        f"{ab_agree:.6f} (bar 0.9999, "
        f"max level diff {ab_dlev}), stage B {ms:.2f} ms vs chain_second_v2 "
        f"{v2_ms:.2f} ms per data-second; {launches} launches on its path")
    return {"name": "chain_second_plain", "route": "cuda",
            "source": "vlite_fast_tpu_torch/csrc/stage_ab.cu",
            "replaces": "vlite_fast_tpu/ops/megakernel.py:516",
            "launches": launches, "max_abs_err": dlev, "agree_2bit": worst,
            "bp_rel_err": bp_rel, "ms": ms, "plain_ms": min(plain_ms),
            "library_ms": None, **b, "agree_2bit_vs_chain_second_v2": ab_agree,
            "chain_second_v2_rfi0_ms": v2_ms}


def phase_rollsel(dev) -> dict:
    """Kernels C1/C2 on phase 3's gulp against the plain version and the
    fold kernel, then the A/B of bench_ddp_fold_tpu.py as their path."""
    from vlite_fast_tpu_torch import PipelineConfig, SearchConfig
    from vlite_fast_tpu_torch import constants as C
    from vlite_fast_tpu_torch.models import search
    from vlite_fast_tpu_torch.ops import dedisperse as dd
    from vlite_fast_tpu_torch.ops import dedisperse_pallas as ddp
    cfg, scfg = PipelineConfig(), SearchConfig()
    eng = search.SinglePulseSearch(scfg, cfg.tsamp, cfg.freqs_mhz(),
                                   nsub=128, nbatch=128, device=dev)
    plan = eng.plan
    full = scfg.gulp_samps + eng.overlap
    ntime_out = full - plan.max_delay
    rng = np.random.default_rng(11)                       # phase 3's gulp
    fb = torch.from_numpy(rng.standard_normal(
        (full, cfg.nchanout)).astype(np.float32)).to(dev)
    got = ddp.dedisperse_pallas_rollsel(fb, plan, ntime_out)
    want, plain_ms = timed_wall(
        lambda: ddp.dedisperse_rollsel_plain(fb, plan, ntime_out))
    bit_equal = torch.equal(got, want)
    err = float((got - want).abs().max())
    check(bit_equal, f"rollsel kernel differs from its plain version: max "
          f"abs {err}")
    fold = ddp.dedisperse_pallas(fb, plan, ntime_out)
    fold_err = float((got - fold).abs().max())
    check(torch.allclose(got, fold, rtol=1e-5, atol=1e-4),
          f"rollsel kernel differs from the fold kernel: max abs {fold_err}")
    del got, want, fold
    # benchmarks/bench_ddp_fold_tpu.py: the linear 1024-trial grid
    lin = dataclasses.replace(scfg, dm_grid_mode="linear", ndm=1024)
    freqs = C.channel_freqs_mhz()[C.CHANMIN:C.CHANMAX + 1]
    lplan = dd.make_plan(dd.dm_grid(lin.dm_min, lin.dm_max, lin.ndm), freqs,
                         cfg.tsamp, nsub=128, nbatch=128,
                         zap_ranges=lin.zap_ranges, device=dev)
    rng = np.random.default_rng(1)
    lfb = torch.from_numpy(rng.standard_normal(
        (lin.gulp_samps + lplan.max_delay, C.NCHANOUT)).astype(
            np.float32)).to(dev)
    _zero_counts()
    a = ddp.dedisperse_pallas_rollsel(lfb, lplan, lin.gulp_samps)
    torch.cuda.synchronize()
    launches = ddp.ROLLSEL_LAUNCHES
    b_ = ddp.dedisperse_pallas(lfb, lplan, lin.gulp_samps)
    ab_err = float((a - b_).abs().max())
    check(torch.allclose(a, b_, rtol=1e-5, atol=1e-4),
          f"linear grid: rollsel vs fold kernel max abs {ab_err}")
    ab_equal = torch.equal(a, b_)
    lb = dedisp_bound(lfb, lplan, lin.gulp_samps)
    del a, b_
    ms_r = cuda_ms(lambda: ddp.dedisperse_pallas_rollsel(
        lfb, lplan, lin.gulp_samps), 3)
    ms_f = cuda_ms(lambda: ddp.dedisperse_pallas(lfb, lplan, lin.gulp_samps),
                   3)
    ms = cuda_ms(lambda: ddp.dedisperse_pallas_rollsel(fb, plan, ntime_out),
                 3)
    b = dedisp_bound(fb, plan, ntime_out)
    ndm = len(plan.dms)
    log(f"[13] dedisperse_pallas_rollsel kernels (C1 shared-memory subband "
        f"tiles, C2 trials in registers) vs plain, phase 3's gulp ({full} x "
        f"{cfg.nchanout}, {ndm} tol-grid trials): bit-equal {bit_equal}; vs "
        f"phase 3's fold kernel max abs diff {fold_err:.3e} (allclose rtol "
        f"1e-5 atol 1e-4); kernel {ms:.2f} ms (CUDA events, 3 reps), bound "
        f"{b['bound_ms']:.3f} ms ({b['bound_by']}), plain {plain_ms:.0f} ms "
        f"(wall); bench_ddp_fold_tpu.py A/B, linear 1024 trials, {lin.gulp_samps}"
        f"-sample gulp: rollsel {ms_r:.2f} ms vs fold {ms_f:.2f} ms per gulp "
        f"(bound {lb['bound_ms']:.3f} ms), max abs diff {ab_err:.3e}, "
        f"bit-equal {ab_equal}; {launches} launch on its path")
    return {"name": "dedisperse_pallas_rollsel", "route": "cuda",
            "source": "vlite_fast_tpu_torch/csrc/dedisperse_rollsel.cu",
            "replaces": "vlite_fast_tpu/ops/dedisperse_pallas.py:129",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None, **b,
            "max_abs_err_vs_fold": fold_err, "linear_1024_ms": ms_r,
            "linear_1024_fold_ms": ms_f}


def phase_tile_bench(dev) -> dict:
    """Its path: the benchmark entry's tile_bench for each mode (the
    script's input order from default_rng(7)); then each sum against its
    plain version on the card."""
    from vlite_fast_tpu_torch.benchmarks import transpose_prims as tp
    rng = np.random.default_rng(7)
    _zero_counts()
    runs = {impl: tp.tile_bench(impl, dev, 10, rng) for impl in tp.IMPLS}
    torch.cuda.synchronize()
    launches = tp.LAUNCHES
    plain_ms = {}
    for impl, (x, y, _) in runs.items():
        want, plain_ms[impl] = timed_wall(lambda: tp.tile_sum_plain(x, impl))
        check(torch.equal(y, want), f"tile_bench[{impl}]: differs from plain")
    x, y, _ = runs["xlu"]
    # the adds of the sums; 'mxu' the identity products it prescribes
    tiles = tp.REPS * tp.NB
    b = {impl: bound(nbytes(x, y), tiles * tp.LANE ** 2) for impl in
         ("none", "xlu")}
    b["mxu"] = bound(nbytes(x, y), tiles * 2 * tp.LANE ** 3, "bf16")
    ms = {impl: r[2] for impl, r in runs.items()}
    log(f"[14] tile_bench kernel (csrc/tile_bench.cu) vs plain, the script's "
        f"shapes ({tp.REPS} steps x {tp.NB} tiles of 128 x 128 f32): all "
        f"three modes equal; "
        + ", ".join(f"{k} {v:.3f} ms (bound {b[k]['bound_ms']:.4f} ms, "
                    f"{b[k]['bound_by']})" for k, v in ms.items())
        + " (CUDA events, 10 reps), plain "
        + " / ".join(f"{v:.0f}" for v in plain_ms.values())
        + f" ms (wall); {launches} launches on its path")
    return {"name": "tile_bench", "route": "cuda",
            "source": "vlite_fast_tpu_torch/csrc/tile_bench.cu",
            "replaces": "benchmarks/bench_transpose_prims_tpu.py:87",
            "launches": launches, "max_abs_err": 0.0, "ms": ms["xlu"],
            "plain_ms": plain_ms["xlu"], "library_ms": None, **b["xlu"],
            "ms_by_impl": ms,
            "bound_ms_by_impl": {k: v["bound_ms"] for k, v in b.items()}}


def main() -> None:
    t_start = time.perf_counter()
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
    launches, _ = phase_main_path(dev, twin_device_ms=k_chain["ms"])
    torch.cuda.empty_cache()
    phase_gulp_passes(dev)
    phase_twin_agreement(dev)
    torch.cuda.empty_cache()
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
    rtf = {}
    for twin in ("megakernel", "megakernel3", "megakernel3f", "megakernel4"):
        got, rtf[twin] = phase_main_path(dev, twin, "[10]")
        for k in ("pallas_pretranspose", "chain_second", "chain_second_v4"):
            launches[k] += got[k]
        torch.cuda.empty_cache()
    log("[10] real-time factors: " + ", ".join(
        f"{t} {f:.3f}" for t, f in rtf.items()))
    for k in (k_chain, k_dedisp, k_rfi, *k_ema, k_pre, *k_ct):
        k["launches"] = launches[k["name"]]
    # the staged chain and the roll+select engine count on their own paths
    staged = [phase_stage_a(dev)]
    torch.cuda.empty_cache()
    staged.append(phase_stage_b(dev))
    torch.cuda.empty_cache()
    staged.append(phase_rollsel(dev))
    torch.cuda.empty_cache()
    staged.append(phase_tile_bench(dev))
    kernels = [k_chain, k_dedisp, k_rfi, *k_ema, k_pre, *k_ct, *staged]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} never launched on its path")
    jax_mods = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "vlite_fast_tpu"))
    check(not jax_mods, f"imported {jax_mods}")
    log(f"[total] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
