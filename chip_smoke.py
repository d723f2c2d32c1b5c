"""End-to-end smoke of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing a line:
  0. device: requires CUDA; the card's name and power limit (nvidia-smi);
  1. build: every CUDA library from vlite_fast_tpu_torch/csrc, one nvcc
     each, and the baseband ring's host library (g++), all started
     together;
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
     injected FRB recovered within 0.2 of DM 80 at S/N 28-32 with no
     candidate below DM 20 in the first 0.5 s (the bandpass seeded from
     0.25 s, baseband_dsp.seed_bandpass, timed; rfi_front once more on
     second 0 for it, and at that shape held against rfi_front_plain,
     the kernel's seed against the plain front's within 1e-6 relative),
     every armed second (one the injected track reaches: the arming
     second) through the RFI front and both EMA kernels, every twin
     second through the chain kernel, and every gulp through the
     dedispersion kernel's packed entry (launch counts); the first
     armed second within 2x of the armed program's device time, the 'auto'
     twin's median span per second (CUDA events) within 1.3x of phase 2's
     device time per data-second with the .fil files written (the drain
     waits only for the previous second's copy), each of the right size
     and the primary's rows equal to the blocks a tap received; the
     host's ms a second by part; peak device memory; then one gulp's
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
     inject_frb=True, twin_chain_impl='xla'), armed at the first, so that
     neither is handed to a chain kernel) through process_second, the
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
     dedisperse_pallas_rollsel, csrc/dedisperse.cu's two stages with its
     zero tail and chunked sums; ptxas's registers and spills of its
     kernels first): phase 3's gulp against its plain version (bit-equal:
     the same adds in the same order) and against phase 3's kernel
     (allclose on every output), timed in all and by stage (C1, C2); then
     its path, the JAX package's benchmarks/bench_ddp_fold_tpu.py A/B on
     the linear 1024-trial grid, both kernels timed;
 14. the tile-transpose microbenchmark (benchmarks/transpose_prims:
     csrc/tile_bench.cu, the JAX package's
     benchmarks/bench_transpose_prims_tpu.py): its path, the script's
     three modes at its shapes (320 steps x 128 tiles), each equal to its
     plain version and timed beside its bound (the adds; for 'mxu' the
     identity products it prescribes, at the bf16 peak);
 15. the array path: ArrayPipeline.run_streaming over N stations of host
     seconds (N = 4 where /dev/shm and memory hold four 40-s rings with a
     quarter to spare, else 2; both readings printed), 46 s so that the
     rings wrap after the first trigger: the FRB in every beam, the coadd
     candidate above every beam's, a trigger near DM 80 before the wrap
     with one dump a station equal to the staged seconds it lists, no
     other trigger (none from the last gulp, searched over its own
     rows), every
     dump equal to its seconds, each .fil of the right size, nothing
     dropped, and the launches (the chain kernel once a second off the
     injected track, the armed kernels once a second on it, the
     dedispersion's packed entry
     once a station gulp and its f32 entry once a coadd gulp); the
     real-time factor, the wall a data-second before and after the wrap,
     the host's ms a station-second by part, peak device memory;
 16. the entry points a deployment starts, each in processes of its own,
     on one 24-s VDIF file at the reference geometry (three noise seconds
     from torch seeds, framed by the port's utils/vdif, cycled by the
     header's second): [16a] `python -m vlite_fast_tpu_torch.cli process
     FILE -i`, the FRB and a .fil of 24 s, its replay's wall; [16b] `cli
     launch --fake` of two station daemons on the same file: both
     connect, a trigger near DM 80 and no other, each station's .fil and
     dumps equal to the file's seconds, each daemon's wall a data-second
     and peak
     device memory; [16c] one daemon on live UDP, the leader in this
     process, 12 s of the file's frames restamped to the wall clock and
     blasted by the port's netcap udp_blast at the wire rate (51,200
     frames/s), the pace halved after an abort (the wall-clock check off
     below the wire rate): the sender exits 0 having sent every frame
     (no fewer than the daemon received and skipped), no abort, >= 10
     whole seconds, the FRB among the candidates the leader received;
     the frames sent, received and skipped, the socket's buffer, the
     host's ms a second by part (median and largest);
 17. the options one station honours beside the main path: [17a]
     PipelineConfig(channelizer='pfb', inject_frb=True, do_histo=True)
     (the streaming WOLA polyphase channelizer on the armed program's
     kernels, DOHISTO) and SearchConfig() over 72 staged seconds through
     StationPipeline.run_observation(profile_dir=...) after prewarm, with
     .fils: every second through rfi_front and both EMA kernels and each
     gulp through the dedispersion kernel (rfi_front once more for the
     bandpass seed), the FRBs armed at seconds 0 and 60 near DM 80 at
     S/N >= 20 and no candidate below DM 20 in the first 0.5 s, the
     first two seconds (the pipeline's rows and process_second in full,
     from the kernel's and the plain front's seeds, each held against
     the other as in [4]) against process_second_plain at the chain
     bar, the _histo.npz
     equal to numpy's bincount of the staged seconds, the trace holding
     the pipeline's ranges (and whether the CUDA libraries' kernels are in
     it); one second's device ms by part, the real-time factor, peak
     device memory (the fused WOLA kernel twice a twin second); [17a']
     that kernel (ops/megakernel.wola_dft_detect_power) at production
     shapes, one stream and both, against its bound, its plain version
     (within 1e-4 of the mean power) and the torch passes it replaces,
     with ptxas's registers of every dft_tc_kernel instantiation;
     [17b] the 'fourier' search engine on [17a]'s gulps
     and [3]'s production gulp: the FRB at the fold kernel's trial +-1
     with its S/N within 2%, the DM-time planes' difference, the gulp's
     time and peak memory; [17c] the config matrix (config.CONFIG_MATRIX,
     the JAX package's benchmarks/smoke_config_matrix_tpu.py VARIANTS) at
     the reference geometry, one second each through the port's program
     (the twin for an injection-free variant) against
     process_second_plain at the chain bar;
 18. the array on a mesh and the offline follow-up, on a one-rank NCCL
     process group (a 1x1 mesh: every collective through NCCL on the
     card): [18a] the sharded array step (parallel/sharded_pipeline) at
     the JAX package's benchmarks/validate_fullgeom_mesh.py settings
     (PipelineConfig(inject_frb=True), the linear 1024-trial DM grid,
     20-s calls, the FRB armed at second 2; benchmarks/fullgeom_mesh's
     pieces), 8 antennas where the card's free memory holds their 41 GB
     of raw with a quarter to spare, else 4, two calls with the state
     carried, the first after 9 s of each antenna's noise through
     process_second (its bandpasses and last halo rows): the FRB near DM
     80 (4 trials) in every beam and in the coadd on both calls, the
     coadd above every beam, antenna 0's rows of
     call 1 equal to process_second second by second, and each call's
     launches (rfi_front and both EMA kernels once an antenna's arming
     second, chain_second_v2 once each of its other seconds, the
     dedispersion's f32 entry once a beam and once for the coadd); the
     f32 entry against its plain version on call 1's beam-0 span and
     coadd window, outside the counted window (allclose as [3]); each
     call's wall, antenna-seconds a second, device ms by part (CUDA
     events) and peak memory; before call 0, the first call with no
     history (the JAX step's random bytes are none in the port) from zero
     bandpasses, as the JAX script starts it (the port seeds them from
     each antenna's first second), and from the warm-up's: the FRB in
     every beam and in the coadd from both, no DM band's top-k saturated
     from either, the crossings from zero bandpasses within 1.5x of the
     warm ones', each start's crossings beside call 0's;
     [18b] coherent_dedisperse_sharded at 128
     MS/s, a 64 MHz band, DM 30, 2 s of two-pol voltages dispersed by one
     chirp: equal to the unsharded ops/coherent path (1e-4 of its rms)
     and within the JAX test's round-trip bar (on a 1x1 mesh both halos
     are zeros: the chirp's time and round trip, not the exchange); [18c] the offline
     follow-up at 128 MS/s: four stations' 1-s dumps made on the card
     (ragged starts, one station in two fragments, known geometric
     delays), `cli join-dumps`, `cli unwrap` of a rotated dump, `cli
     localize --positions` (az/el within 0.1 rad), filterbank,
     correlation_matrix and beamform_toward on the card against
     device='cpu' on the dumps' first 8,000,000 samples, `cli waterfall`
     of a .fil of one dump's filterbank; each step timed;
 19. the port's headline bench, `python -m vlite_fast_tpu_torch.cli bench`
     (vlite_fast_tpu_torch/bench.py) in a process of its own at the
     reference geometry: exit 0 and one JSON line on its stdout holding
     every key of BENCH_KEYS, the FRB recovered in both loops (within
     0.2 of DM 80 at S/N 28-32 on the linear grid), no candidate below
     DM 20 in
     an observation's first 0.5 s,
     twin_agreement >= 0.9999, every utilization share in (0, 100],
     value_tolgrid <= 1.02 x value, and the main path's kernels launched
     in its integrated loops; the line and the phase's seconds printed;
then the run's wall time, one JSON line of per-kernel results (each with
its time, its plain version's, its bound from this run's shapes
(utils/perf), the library call's time where one PyTorch call computes
the function, and its launches on its path: [4], [10], [15], [16], [17],
[18] and [19] for kernels 1-8, [11]-[14] for the staged chain, the
roll+select engine and tile_bench),
the card's name
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

from vlite_fast_tpu_torch import bench
from vlite_fast_tpu_torch import launches as kernel_launches
from vlite_fast_tpu_torch.utils import perf


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def chain_bound(cfg, raw, outs) -> dict:
    """The chain's bound on this second (perf.chain_bound): its masked
    frames (weight < 1) counted from the outputs, and perf's byte count
    held to the bytes of the second and of the outputs."""
    check(perf.chain_bytes(cfg) == nbytes(raw, *outs),
          f"perf.chain_bytes {perf.chain_bytes(cfg)} != the chain's "
          f"{nbytes(raw, *outs)} bytes")
    masked = int((outs[2] < 1).sum()) if cfg.rfi_mode == 2 else 0
    return perf.chain_bound(cfg, masked)


def dft_as_written_ms(cfg, outs) -> float:
    """The chain kernels' own DFT at the bf16 peak, for the log only (a
    count, not a measurement): the tensor-core DFT's padded bf16 products
    on every frame and on the frames of the blocks flagged in part (0 <
    weight < 1)."""
    frames = cfg.npol_in * cfg.seg_per_sec * cfg.ffts_per_seg
    w = outs[2]
    partial = int(((w > 0) & (w < 1)).sum()) if cfg.rfi_mode else 0
    return perf.tc_dft_ops(cfg, frames + partial) \
        / perf.PEAK_OPS_PER_S["bf16"] * 1e3


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


def levels(packed: torch.Tensor, nbit: int = 2) -> np.ndarray:
    from vlite_fast_tpu_torch.ops import quantize as q
    return q.unpack_bits(packed.cpu(), nbit).numpy().astype(np.int16)


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
    _build.load_all(_build.LIBRARIES + _build.HOST_LIBRARIES)
    took = ", ".join(f"{n} {s:.1f} s" if s else f"{n} already built"
                     for n, s in _build.BUILD_SECONDS.items())
    log(f"[1] build: {took} (in parallel, total "
        f"{time.perf_counter() - t0:.1f} s, nvcc sm_90a; the ring g++)")


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
    packed rows), the plan's tables and the DM-time plane once each, and
    perf.dedisp_fold_cost's adds (one per term of each stage)."""
    ndm = plan.sub_delays.shape[0]
    adds = perf.dedisp_fold_cost(plan, plan.rel_delays.shape[1],
                                 ntime_out)["adds"]
    return perf.bound(nbytes(fb, plan.rel_delays, plan.sub_delays,
                             plan.chan_weights) + 4 * ndm * ntime_out, adds)


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
        bounds[what] = perf.bound(nbytes(raw, got), 0)
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


ARMED_KERNELS = ("rfi_front", "normalize_ema_pallas",
                 "normalize_ema_weighted_pallas")
# an observation's first bench.START_S seconds raise no candidate below
# bench.START_MAX_DM at the search's threshold (bench.start_transient):
# the bandpass is seeded from the EMA's own length of spectra
# (baseband_dsp.seed_bandpass), where the tile seed's start-up transient
# gave a DM-2.00, S/N-29.81 candidate at 0.049 s on an H100
# the FRB (DM 80) is found within FRB_DM_TOL of its DM, at S/N 28-32: at
# DM 80.04 on the linear grid ([19]), at 79.90 or 80.04 on the tolerance
# grid ([4])
FRB_DM_TOL = 0.2
FRB_SNR = (28.0, 32.0)
CHAIN_KERNELS = ("chain_second_v2", "pallas_pretranspose", "chain_second",
                 "chain_second_v4")
# each gulp's search: the boxcar pass and the top-k pass, once each
SEARCH_KERNELS = ("boxcar_snr_stats", "topk_banded_select")
# the kernels each twin second launches once, by twin_chain_impl
TWIN_KERNELS = {"auto": ("chain_second_v2",),
                "megakernel": ("chain_second",),
                "megakernel3": ("pallas_pretranspose", "chain_second"),
                "megakernel3f": ("pallas_pretranspose", "chain_second"),
                "megakernel4": ("pallas_pretranspose", "chain_second_v4")}


def on_track(cfg, n_sec: int) -> list:
    """For each second of a station's observation (armed every
    INJECT_PERIOD_S from its second 0), whether it runs the armed program
    (baseband_dsp.second_program); every other second runs the twin."""
    from vlite_fast_tpu_torch import constants as C
    from vlite_fast_tpu_torch.models import baseband_dsp as dsp
    return [dsp.second_program(
        cfg, s % C.INJECT_PERIOD_S * cfg.seg_per_sec)[0] == "armed"
        for s in range(n_sec)]


def check_fil(path: str, nrows: int, row_bytes: int, digest: str = None,
              what: str = "") -> None:
    """A .fil file holds its header and nrows rows of row_bytes, whose
    sha-256 (when given) is digest."""
    import os
    from vlite_fast_tpu_torch.utils import sigproc
    h = hashlib.sha256()
    with open(path, "rb") as fp:
        sigproc.read_header(fp)
        header = fp.tell()
        while chunk := fp.read(1 << 24):
            h.update(chunk)
    size = os.path.getsize(path)
    check(size == header + nrows * row_bytes,
          f"{what} {path}: {size} bytes, not {header} + {nrows} x "
          f"{row_bytes}")
    check(digest is None or h.hexdigest() == digest,
          f"{what} {path}: its rows differ from the blocks the taps got")


_MAIN_PATH_SECONDS = []


def seed_check(dev, cfg, raw, tag: str) -> tuple:
    """The bandpass seed on the card against its plain version: rfi_front
    against rfi_front_plain on the seed's slice of `raw` (its first
    seed_spectra(cfg) spectra, the shape an observation's first second
    launches it at), masked voltages, weights and flags equal and the TS
    within 1e-5; then baseband_dsp.seed_bandpass through the kernel
    against it through the plain front, from a fresh state: every entry
    seeded, bandpasses within 1e-6 relative.  Returns (the kernel's
    seeded state, the plain front's, a note for the log)."""
    from vlite_fast_tpu_torch.models import baseband_dsp as dsp
    from vlite_fast_tpu_torch.ops import rfi_pallas
    n = dsp.seed_spectra(cfg)
    u = raw[:, :n * cfg.nfft].contiguous()
    args = (cfg.nkurto, cfg.nfft, cfg.dag_thresh, cfg.dag_fb_thresh)
    got = rfi_pallas.rfi_front(u, *args)
    want = rfi_pallas.rfi_front_plain(u, *args)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"{tag} rfi_front on the seed's {tuple(u.shape)}: masked voltages "
          f"or weights differ from rfi_front_plain")
    flags = got[2] >= cfg.dag_thresh
    check(torch.equal(flags, want[2] >= cfg.dag_thresh),
          f"{tag} rfi_front on the seed's slice: fine-window flags differ")
    ts = float((got[2] - want[2]).abs().max())
    check(ts <= 1e-5, f"{tag} rfi_front on the seed's slice: TS off by {ts}")
    nflag = int(flags.sum())
    del got, want
    st0 = dsp.init_state(cfg, dev)
    st_k = dsp.seed_bandpass(cfg, raw, st0)
    st_p = dsp.seed_bandpass(cfg, raw, st0, front=rfi_pallas.rfi_front_plain)
    fields = ("bp", "bp_kur")
    check(all(bool((getattr(st, f) > 0).all()) for st in (st_k, st_p)
              for f in fields), f"{tag} the seed left a zero bandpass entry")
    rel = max(rel_err(getattr(st_k, f), getattr(st_p, f), 1e-6)
              for f in fields)
    check(rel <= 1e-6, f"{tag} the kernel's seed off the plain front's by "
          f"{rel} relative")
    same = all(torch.equal(getattr(st_k, f), getattr(st_p, f))
               for f in fields)
    return st_k, st_p, (
        f"the seed's rfi_front on {tuple(u.shape)} u8 equal to "
        f"rfi_front_plain (masked voltages, weights, {nflag} windows "
        f"flagged; TS diff {ts:.2e}, bar 1e-5), its bandpasses against the "
        f"plain front's rel {rel:.2e} (bar 1e-6; bit-equal: {same})")


def main_path_seconds(dev, cfg) -> list:
    """The main path's three staged seconds (seeded numpy noise), made on
    the first call and kept on the card for the later runs."""
    if not _MAIN_PATH_SECONDS:
        rng = np.random.default_rng(0)
        _MAIN_PATH_SECONDS.extend(torch.from_numpy(np.clip(
            rng.standard_normal((cfg.npol_in, cfg.sample_rate)) / 0.05914
            + 128.5, 0, 255).astype(np.uint8)).to(dev) for _ in range(3))
    return _MAIN_PATH_SECONDS


def phase_main_path(dev, twin: str = "auto", tag: str = "[4]",
                    n_sec: int = 40, twin_device_ms: float = None,
                    write_fil: bool = False) -> tuple:
    """The main path (twin_device_ms: the twin program's device ms per
    data-second, from phase 2, to hold the twin's spans against): its
    kernel launches and its real-time factor.  With write_fil, the .fil
    files are written (production's default) and checked: their size, and
    the primary's rows against the blocks a tap received."""
    from vlite_fast_tpu_torch import PipelineConfig, SearchConfig
    from vlite_fast_tpu_torch.models import baseband_dsp as dsp
    from vlite_fast_tpu_torch.runtime.pipeline import (HOST_PARTS,
                                                       ObservationDocument,
                                                       StationPipeline)
    cfg = PipelineConfig(inject_frb=True, twin_chain_impl=twin)
    scfg = SearchConfig()
    staged = main_path_seconds(dev, cfg)
    out_dir = tempfile.mkdtemp(prefix="vfast_smoke_")
    per_sec = []                # kernel launches in each fed second
    try:
        pipe = StationPipeline(1, cfg, scfg, out_dir=out_dir,
                               keep_ring=False, write_cands=False,
                               device=dev)
        rows = n_sec * cfg.seg_per_sec * cfg.out_samps_per_seg
        row_bytes = cfg.nchanout * cfg.nbit // 8
        tapped = {"rows": 0,
                  "copy": np.empty((rows, row_bytes), np.uint8)}

        def tap(sid, offset, block):    # a copy now, the digest after
            check(offset == tapped["rows"], f"{tag} tap offset {offset}")
            tapped["copy"][offset:offset + block.shape[0]] = block
            tapped["rows"] += block.shape[0]
        if write_fil:
            pipe.block_taps.append(tap)
        t_pre = time.perf_counter()
        pipe.prewarm()                      # set-up: its launches not counted
        t_pre = time.perf_counter() - t_pre
        od = ObservationDocument(name="SMOKE", start_time=1.7e9)
        torch.cuda.reset_peak_memory_stats(dev)
        kernel_launches.zero()
        t0 = time.perf_counter()
        pipe.begin_observation(od, write_fil=write_fil)
        for sec in range(n_sec):
            before = kernel_launches.counts()
            pipe.feed_second(1.7e9 + sec, staged[sec % 3])
            per_sec.append(kernel_launches.since(before))
        prod = pipe.end_observation()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_launches.counts()
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        host = {k: (1e3 * float(np.median(v)), 1e3 * float(np.max(v)))
                for k, v in pipe.host_seconds.items()}
        log(f"{tag} host ms per data-second (median, max): " + ", ".join(
            f"{k} {host[k][0]:.3f} {host[k][1]:.3f}" for k in HOST_PARTS)
            + f"; .fil written: {write_fil}")
        fil_note = ""
        if write_fil:
            check(tapped["rows"] == rows, f"{tag} taps got {tapped['rows']} "
                  f"rows, not {rows}")
            check_fil(prod.fil_path, rows, row_bytes, hashlib.sha256(
                tapped["copy"]).hexdigest(), tag)
            check_fil(prod.fil_path.replace(".fil", "_plain.fil"), rows,
                      row_bytes, what=tag)
            fil_note = (f"; .fil and _plain.fil written ({rows} rows each, "
                        f"the .fil's rows sha-256-equal to the tapped "
                        f"blocks)")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    armed = pipe.feed_seconds["armed"]
    gulps = int(pipe.metrics.get("vfast_gulps_searched"))
    track = on_track(cfg, n_sec)      # armed at second 0: second 0 alone
    check(prod.seconds == n_sec, f"{prod.seconds} seconds processed")
    check(len(armed) == sum(track), f"{len(armed)} armed seconds")
    twin_kernels = TWIN_KERNELS[twin]
    for sec, n in enumerate(per_sec):
        # second 0 also seeds the bandpass: one more rfi_front launch
        want = {k: int(track[sec]) + (sec == 0 and k == "rfi_front")
                for k in ARMED_KERNELS}
        if track[sec]:
            ok = not any(n[k] for k in CHAIN_KERNELS)
        else:
            ok = all(n[k] == (k in twin_kernels) for k in CHAIN_KERNELS)
        ok = ok and all(n[k] == want[k] for k in ARMED_KERNELS)
        check(ok, f"{tag} second {sec} "
              f"({'armed' if track[sec] else 'twin'}) launched {n}")
    twin_s = pipe.feed_seconds["twin"]
    check(len(twin_s) == n_sec - len(armed) and all(
        launches[k] == (len(twin_s) if k in twin_kernels else 0)
        for k in CHAIN_KERNELS),
        f"chain kernel launches {launches} vs {len(twin_s)} twin seconds")
    check(all(launches[k] == len(armed) + (k == "rfi_front")
              for k in ARMED_KERNELS),
          f"armed kernel launches {launches} vs {len(armed)} armed seconds "
          f"and one bandpass seed")
    check(gulps >= 1 and launches["dedisperse_pallas"] == gulps
          and launches["dedisperse_pallas_packed"] == gulps,
          f"dedispersion launches {launches} vs {gulps} gulps (each through "
          f"the packed entry)")
    check(all(launches[k] == gulps for k in SEARCH_KERNELS),
          f"boxcar and top-k launches {launches} vs {gulps} gulps (each "
          f"pass once a gulp)")
    twin_med = 1e3 * float(np.median(twin_s))
    # the armed program alone on a warm card (the track ends inside the
    # arming second: it is the observation's only armed second)
    armed_ms = cuda_ms(lambda: dsp.process_second(
        cfg, staged[0], dsp.init_state(cfg, dev), True), 3)
    if twin_device_ms is not None:
        check(1e3 * armed[0] <= 2.0 * armed_ms, f"{tag} first armed second "
              f"{1e3 * armed[0]:.1f} ms > 2x the armed program's "
              f"{armed_ms:.1f}")
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
    # the observation starts from a settled bandpass: no start-up
    # transient, and the FRB armed at second 0 at its own S/N
    early = bench.start_transient(prod.candidates, scfg)
    check(not early, f"{tag} candidates below DM {bench.START_MAX_DM:g} in "
          f"the first {bench.START_S:g} s: {early}")
    check(abs(best.dm - cfg.inject_dm) < FRB_DM_TOL
          and FRB_SNR[0] <= best.snr <= FRB_SNR[1],
          f"{tag} the FRB at DM {best.dm:.2f} S/N {best.snr:.2f}, not within "
          f"{FRB_DM_TOL} of DM {cfg.inject_dm:g} at S/N {FRB_SNR}")
    seed_ms = cuda_ms(lambda: dsp.seed_bandpass(
        cfg, staged[0], dsp.init_state(cfg, dev)), 3)
    _, _, seed_note = seed_check(dev, cfg, staged[0], tag)
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
        f"S/N {top.snr:.2f}, {len(prod.candidates)} candidates; none below "
        f"DM {bench.START_MAX_DM:g} in the first {bench.START_S:g} s); "
        f"bandpass seed "
        f"(seed_bandpass, {dsp.seed_spectra(cfg)} spectra) {seed_ms:.2f} "
        f"ms (CUDA events, 3 reps), armed second 0 - the armed program "
        f"{1e3 * armed[0] - armed_ms:.2f} ms ({armed_ms:.2f} ms, CUDA "
        f"events, 3 reps), {seed_note}; peak "
        f"device memory {peak:.2f} GiB; launches {launches} (each second "
        f"on the track: rfi_front and both EMA kernels once, second 0 "
        f"rfi_front once more for the seed; each other second: "
        f"{' and '.join(twin_kernels)} once; each gulp: the dedispersion "
        f"kernel's packed entry, the boxcar pass and the top-k pass "
        f"once){fil_note}")
    for c in sorted(prod.candidates, key=lambda c: -c.snr)[:5]:
        log(f"{tag}   candidate DM {c.dm:.2f} S/N {c.snr:.2f} at "
            f"{c.peak_time:.3f} s, width 2^{c.tfilt}, {c.ngiant} crossings")
    return launches, n_sec / wall


def phase_gulp_passes(dev) -> dict:
    """One production gulp search from packed rows on the device (seeded
    2-bit rows): its device time by pass, each pass timed alone with CUDA
    events on the gulp's own intermediates, and the whole search's wall.
    The boxcar and top-k launches (ops/boxcar_topk) against the torch
    passes they replace on the same plane (boxcar_snr's cube, then
    pack_topk_banded, and torch.topk on the banded cube alone as the
    library's yardstick), their bound, and the peak device memory of the
    search with and without the cube.  Returns the launches' row."""
    from vlite_fast_tpu_torch import PipelineConfig, SearchConfig
    from vlite_fast_tpu_torch.models import search
    from vlite_fast_tpu_torch.ops import boxcar_topk as bt
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
    thresh, nw = float(scfg.snr_thresh), len(eng.widths)
    gulp = lambda: search._device_gulp(
        packed, plan, widths=eng.widths, k=k, nbit=cfg.nbit, nchan=nchan,
        nbands=eng.nbands, thresh=thresh)
    plain_gulp = lambda: search.pack_topk_banded(dd.boxcar_snr(
        ddp.dedisperse_pallas_packed(packed, cfg.nbit, nchan, plan,
                                     ntime_out), plan.nchan_eff,
        eng.widths), k, eng.nbands, thresh)
    peak = {}
    for name, fn in (("launches", gulp), ("torch passes", plain_gulp)):
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        fn()
        torch.cuda.synchronize(dev)
        peak[name] = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30
    total = cuda_ms(gulp, 3)
    _, wall = timed_wall(lambda: eng.search_gulp_device(packed, cfg.nbit))
    dmt = ddp.dedisperse_pallas_packed(packed, cfg.nbit, nchan, plan,
                                       ntime_out)
    ndm = dmt.shape[0]
    kb = max(1, min(k // eng.nbands, nw * (ndm // eng.nbands) * ntime_out))
    launch = bt.Launch(dmt, plan.nchan_eff, eng.widths, eng.nbands, kb,
                       thresh, "measured", 0)
    boxcar_ms = cuda_ms(launch.boxcar, 5)
    both_ms = cuda_ms(lambda: (launch.boxcar(), launch.topk()), 5)
    got = launch.out.clone()
    snr = dd.boxcar_snr(dmt, plan.nchan_eff, eng.widths)
    want = search.pack_topk_banded(snr, k, eng.nbands, thresh)
    # crossings within 1e-5 of the threshold may fall either way
    near = int(((snr - thresh).abs() <= 1e-5 * thresh).sum())
    banded = snr.reshape(nw, eng.nbands, -1, ntime_out).transpose(0, 1) \
        .reshape(eng.nbands, -1)
    by = {"dedispersion": cuda_ms(lambda: ddp.dedisperse_pallas_packed(
              packed, cfg.nbit, nchan, plan, ntime_out), 3),
          "boxcar S/N (torch)": cuda_ms(lambda: dd.boxcar_snr(
              dmt, plan.nchan_eff, eng.widths), 3),
          "banded top-k (torch)": cuda_ms(lambda: search.pack_topk_banded(
              snr, k, eng.nbands, thresh), 3)}
    library_ms = cuda_ms(lambda: torch.topk(banded, kb, dim=1), 3)
    del snr, banded
    g, w = got.cpu().numpy(), want.cpu().numpy()
    shape = (nw, ndm, ntime_out)
    dg = search.decode_crossings(g, *shape, eng.nbands, thresh)
    dw = search.decode_crossings(w, *shape, eng.nbands, thresh)
    hg = {tuple(h): v for h, v in zip(dg[1].tolist(), dg[0].tolist())}
    hw = {tuple(h): v for h, v in zip(dw[1].tolist(), dw[0].tolist())}
    check(abs(dg[2] - dw[2]) <= near and dg[3] == dw[3] == 0
          and all(abs(hg[h] - hw[h]) <= 1e-5 * hw[h] for h in hg.keys()
                  & hw.keys())
          and all(abs(hg.get(h, hw.get(h)) - thresh) <= 1e-5 * thresh
                  for h in hg.keys() ^ hw.keys()),
          f"[4] the gulp's launches' crossings {dg[2]} (saturated "
          f"{dg[3]}) vs the torch passes' {dw[2]} ({dw[3]}; {near} within "
          f"1e-5 of the threshold)")
    # one read of the DM-time plane, the crossings out; per DM-time
    # element the mean and the running sum, per width a difference, a
    # scale and a compare (portbench/work/counts.py's count)
    b = perf.bound(4 * ndm * ntime_out + g.nbytes,
                   ndm * ntime_out * (2 + 3 * nw))
    log(f"[4] one production gulp ({full} packed rows): device "
        f"{total:.2f} ms (CUDA events, 3 reps): "
        + ", ".join(f"{n} {v:.2f} ms" for n, v in by.items())
        + f" (each alone); search_gulp_device wall {wall:.1f} ms; peak "
        f"device memory of a gulp's search above what it was given: "
        + ", ".join(f"{n} {v:.2f} GiB" for n, v in peak.items()))
    log(f"[4] boxcar + top-k launches ({ndm} x {ntime_out}, {nw} widths, "
        f"{eng.nbands} bands of {kb}): pass 1 {boxcar_ms:.3f} ms, pass 2 "
        f"{both_ms - boxcar_ms:.3f} ms, both {both_ms:.3f} ms (CUDA events, "
        f"5 reps; {dg[2]} crossings, equal to the torch passes'); bound "
        f"{b['bound_ms']:.3f} ms ({b['bound_by']}); torch passes "
        f"{by['boxcar S/N (torch)'] + by['banded top-k (torch)']:.2f} ms; "
        f"torch.topk on the banded cube alone {library_ms:.2f} ms")
    return {"name": "topk_banded_select", "with": "boxcar_snr_stats",
            "route": "cuda", "kernel_ms": both_ms,
            "pass1_ms": boxcar_ms, **b, "library_ms": library_ms,
            "plain_ms": by["boxcar S/N (torch)"]
            + by["banded top-k (torch)"]}


def phase_twin_agreement(dev, nseeds: int = 10) -> None:
    """The A/B of the routing over more seconds than bench.py's: the armed
    program (never armed; twin 'xla', so that process_second keeps its own
    torch program on the card) against the twin second_program gives an
    un-armed second, one second of the smoke's noise (made on the card)
    per seed, each program carrying its own bandpass; the 2-bit agreement
    of both streams per second."""
    from vlite_fast_tpu_torch import PipelineConfig
    from vlite_fast_tpu_torch.models import baseband_dsp as dsp
    cfg = PipelineConfig(inject_frb=True)
    cfg_a = dataclasses.replace(cfg, twin_chain_impl="xla")
    _, twin, twin_cfg = dsp.second_program(cfg, -1)
    check(twin is dsp.twin_second, f"[4] the production twin is "
          f"{twin.__name__}, not the chain kernel")
    st_a = st_t = dsp.init_state(cfg, dev)
    agree, dlev = [], 0
    for seed in range(nseeds):
        raw = noise_on_card(dev, cfg.npol_in, cfg.sample_rate, seed)
        out_a, st_a = dsp.process_second(cfg_a, raw, st_a, False)
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
        rb = perf.bound(nbytes(u, *got), 5 * u.numel())
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
        eb = perf.bound(nbytes(*ins, *got), per_elem * power.numel())
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
    # twin 'xla': the second past the track stays on the armed program
    # (with the chain kernel as the twin, process_second hands it off)
    cfg = PipelineConfig(inject_frb=True, twin_chain_impl="xla")
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
    kernel_launches.zero()
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
    b = perf.bound(nbytes(raws[0], got[0]), ops, "bf16")
    del got, want
    ms = cuda_ms(lambda: mk.dft_detect_power(raws[0], *args), 5)
    x = unpack_ops.convert_uint8(raws[0]).reshape(-1, cfg.nfft)
    lib_ms = cuda_ms(lambda: torch.fft.rfft(x).abs().square(), 5)
    del x
    padded_ms = perf.tc_dft_ops(cfg, frames) \
        / perf.PEAK_OPS_PER_S["bf16"] * 1e3
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
    kernel_launches.zero()
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
    b = perf.bound(nbytes(raws[0], bp0, *got[0]), ops, "bf16")
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


def ptxas_kernels(lib: str, word: str) -> dict:
    """ptxas's report on the kernels of csrc/<lib>.cu whose name holds
    `word`."""
    from vlite_fast_tpu_torch import _build
    log_path = _build.lib_path(lib).with_suffix(".log")
    return {k: v for k, v in _build.ptxas_report(log_path).items()
            if word in k}


def phase_rollsel(dev) -> dict:
    """Kernels C1/C2 on phase 3's gulp against the plain version and the
    fold kernel, each stage timed alone, then the A/B of
    bench_ddp_fold_tpu.py as their path."""
    from vlite_fast_tpu_torch import PipelineConfig, SearchConfig
    from vlite_fast_tpu_torch import constants as C
    from vlite_fast_tpu_torch.models import search
    from vlite_fast_tpu_torch.ops import dedisperse as dd
    from vlite_fast_tpu_torch.ops import dedisperse_pallas as ddp
    ptxas = ptxas_kernels("dedisperse", "rollsel")
    check(len(ptxas) == 3, f"ptxas reports {sorted(ptxas)}")
    log("[13] ptxas, csrc/dedisperse.cu's roll+select kernels: " + "; ".join(
        f"{k} {v['registers']} registers, spill stores/loads "
        f"{v['spill_stores']}/{v['spill_loads']} bytes"
        for k, v in ptxas.items()))
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
    kernel_launches.zero()
    a = ddp.dedisperse_pallas_rollsel(lfb, lplan, lin.gulp_samps)
    torch.cuda.synchronize()
    launches = ddp.ROLLSEL_LAUNCHES
    lwant = ddp.dedisperse_rollsel_plain(lfb, lplan, lin.gulp_samps)
    lin_equal = torch.equal(a, lwant)
    check(lin_equal, "linear grid: rollsel kernel differs from its plain "
          f"version: max abs {float((a - lwant).abs().max())}")
    del lwant
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
    # each stage alone (these launches are timings, not the path's)
    ms_c1 = cuda_ms(lambda: ddp._rollsel_stage1(fb, plan, ntime_out), 3)
    y = ddp._rollsel_stage1(fb, plan, ntime_out)
    ms_c2 = cuda_ms(lambda: ddp._rollsel_stage2(y, plan, ntime_out, 16), 3)
    del y
    b = dedisp_bound(fb, plan, ntime_out)
    ndm = len(plan.dms)
    log(f"[13] dedisperse_pallas_rollsel kernels (csrc/dedisperse.cu: C1 "
        f"the fold's stage 1 reading zeros past the gulp, C2 its stage 2 "
        f"with chunk sums, 8 samples x 5 trials a thread) vs plain, phase "
        f"3's gulp ({full} x {cfg.nchanout}, {ndm} tol-grid trials): "
        f"bit-equal {bit_equal}; vs phase 3's fold kernel max abs diff "
        f"{fold_err:.3e} (allclose rtol 1e-5 atol 1e-4); kernel {ms:.3f} ms "
        f"(C1 {ms_c1:.3f} ms, C2 {ms_c2:.3f} ms alone; CUDA events, 3 "
        f"reps), bound {b['bound_ms']:.3f} ms ({b['bound_by']}), plain "
        f"{plain_ms:.0f} ms (wall); bench_ddp_fold_tpu.py A/B, linear 1024 "
        f"trials, {lin.gulp_samps}-sample gulp: rollsel {ms_r:.3f} ms "
        f"(bit-equal to plain {lin_equal}) vs fold {ms_f:.3f} ms per gulp "
        f"(bound {lb['bound_ms']:.3f} ms), max abs diff {ab_err:.3e}, "
        f"bit-equal {ab_equal}; {launches} launch on its path")
    return {"name": "dedisperse_pallas_rollsel", "route": "cuda",
            "source": "vlite_fast_tpu_torch/csrc/dedisperse.cu",
            "replaces": "vlite_fast_tpu/ops/dedisperse_pallas.py:129",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None, **b,
            "c1_ms": ms_c1, "c2_ms": ms_c2, "ptxas": ptxas,
            "max_abs_err_vs_fold": fold_err, "linear_1024_ms": ms_r,
            "linear_1024_fold_ms": ms_f}


def phase_tile_bench(dev) -> dict:
    """Its path: the benchmark entry's tile_bench for each mode (the
    script's input order from default_rng(7)); then each sum against its
    plain version on the card."""
    from vlite_fast_tpu_torch.benchmarks import transpose_prims as tp
    rng = np.random.default_rng(7)
    kernel_launches.zero()
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
    b = {impl: perf.bound(nbytes(x, y), tiles * tp.LANE ** 2) for impl in
         ("none", "xlu")}
    b["mxu"] = perf.bound(nbytes(x, y), tiles * 2 * tp.LANE ** 3, "bf16")
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


RING_SECONDS = 40


def shm_and_memory() -> tuple:
    """(bytes /dev/shm has free, bytes of memory available), as df and
    /proc/meminfo give them."""
    st = shutil.disk_usage("/dev/shm")
    with open("/proc/meminfo") as fp:
        avail = next(int(line.split()[1]) * 1024 for line in fp
                     if line.startswith("MemAvailable:"))
    return st.free, avail


def phase_array(dev, n_sec: int = 46) -> dict:
    """The array path: ArrayPipeline.run_streaming over N stations of host
    seconds (numpy, three staged seconds per station from seeds of its
    own, cycled), every station with its 40-s ring (pre-faulted, written
    on its own thread), its .fil and its device tap into the coadd's sum
    on the card and its search, at PipelineConfig(inject_frb=True)
    and SearchConfig(); N = 4 where /dev/shm and memory hold four rings
    with a quarter to spare, else 2.  Long enough for the rings to wrap,
    with the first trigger before they do, and no trigger from the last
    gulp.  Returns its kernel launches."""
    import os
    from vlite_fast_tpu_torch import PipelineConfig, SearchConfig
    from vlite_fast_tpu_torch.config import (AntennaConfig, ArrayConfig,
                                             TriggerConfig)
    from vlite_fast_tpu_torch.runtime.pipeline import (ArrayPipeline,
                                                       HOST_PARTS,
                                                       ObservationDocument)
    cfg = PipelineConfig(inject_frb=True)
    scfg = SearchConfig()
    sec_bytes = cfg.npol_in * cfg.sample_rate
    need = RING_SECONDS * sec_bytes            # one station's ring
    shm_free, mem_avail = shm_and_memory()
    room = min(shm_free, mem_avail)
    nant = 4 if room >= 1.25 * 4 * need else 2
    readings = (f"/dev/shm free {shm_free / 1e9:.1f} GB, memory available "
                f"{mem_avail / 1e9:.1f} GB, {need / 1e9:.2f} GB of ring a "
                f"station; {tempfile.gettempdir()} (the .fil files and "
                f"dumps) free "
                f"{shutil.disk_usage(tempfile.gettempdir()).free / 1e9:.1f}"
                f" GB")
    check(room >= 1.25 * nant * need, f"[15] no room for {nant} rings: "
          f"{readings}")
    acfg = ArrayConfig(
        antennas=tuple(AntennaConfig(station_id=i + 1, name=f"ea{i + 1:02d}")
                       for i in range(nant)),
        pipeline=cfg, search=scfg, trigger=TriggerConfig(min_dm=20.0))
    staged = {}
    for a in acfg.antennas:
        gen = torch.Generator(device=dev).manual_seed(1000 + a.station_id)
        staged[a.station_id] = [
            (torch.randn((cfg.npol_in, cfg.sample_rate), generator=gen,
                         device=dev) / 0.05914 + 128.5).clamp(0, 255)
            .to(torch.uint8).cpu().numpy() for _ in range(3)]
    t0_unix = 1.7e9
    fed = []                # host clock when each data-second was first fed

    def seconds(secs):
        for k in range(n_sec):
            if len(fed) == k:
                fed.append(time.perf_counter())
            yield t0_unix + k, secs[k % 3]
    per_ant = {sid: seconds(secs) for sid, secs in staged.items()}
    out_dir = tempfile.mkdtemp(prefix="vfast_array_")
    ap = ArrayPipeline(acfg, out_dir=out_dir, device=dev)
    try:
        t_pre = time.perf_counter()
        ap.prewarm()                        # set-up: its launches not counted
        t_pre = time.perf_counter() - t_pre
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernel_launches.zero()
        t0 = time.perf_counter()
        res = ap.run_streaming(per_ant, ObservationDocument(
            name="SMOKE_ARRAY", start_time=t0_unix, scan_no=2))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_launches.counts()
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        # wall a data-second, before and after the rings wrap, and the
        # tail (the last drains, the flush gulps, the last dumps)
        fed.append(t0 + wall)
        walls = {"before": (fed[RING_SECONDS] - t0) / RING_SECONDS,
                 "after": (fed[n_sec - 1] - fed[RING_SECONDS])
                 / (n_sec - 1 - RING_SECONDS),
                 "tail": fed[n_sec] - fed[n_sec - 1]}
        rows = n_sec * cfg.seg_per_sec * cfg.out_samps_per_seg
        row_bytes = cfg.nchanout * cfg.nbit // 8
        near = lambda c: abs(c.dm - cfg.inject_dm) <= 0.1 * cfg.inject_dm
        beams = {}
        for st in ap.stations:
            prod = res["products"][st.station_id]
            check(prod.seconds == n_sec and prod.dropped == 0,
                  f"[15] station {st.station_id}: {prod.seconds} seconds, "
                  f"{prod.dropped} dropped")
            check_fil(prod.fil_path, rows, row_bytes,
                      what=f"[15] station {st.station_id}")
            frb = [c for c in prod.candidates if near(c)]
            best = max(frb, key=lambda c: c.snr) if frb else None
            check(best is not None and best.snr >= 10.0,
                  f"[15] station {st.station_id}: FRB not recovered ({best})")
            beams[st.station_id] = best
        co = [c for c in res["coadd_candidates"] if near(c)]
        co_best = max(co, key=lambda c: c.snr) if co else None
        beam_max = max(b.snr for b in beams.values())
        beam_mean = float(np.mean([b.snr for b in beams.values()]))
        check(co_best is not None and co_best.snr > beam_max,
              f"[15] coadd candidate near DM {cfg.inject_dm} {co_best} not "
              f"above every beam's (max {beam_max:.2f})")
        for t, at in zip(res["triggers"], res["trigger_seconds"]):
            log(f"[15]   trigger DM {t.dm:.2f} S/N {t.sn:.2f} window "
                f"[{t.t0 - t0_unix:.3f}, {t.t1 - t0_unix:.3f}] s ({t.meta}), "
                f"raised after {at} data seconds")
        frb_trig = [(t, at) for t, at in zip(res["triggers"],
                                             res["trigger_seconds"])
                    if abs(t.dm - cfg.inject_dm) <= 0.1 * cfg.inject_dm]
        check(bool(frb_trig), f"[15] no trigger near DM {cfg.inject_dm}: "
              f"{res['triggers']}")
        first, first_at = min(frb_trig, key=lambda x: x[1])
        check(first_at < RING_SECONDS, f"[15] the first trigger came after "
              f"{first_at} s, when the rings had wrapped")
        # the last gulp, searched over its own rows, raises no trigger
        gulp, overlap = scfg.gulp_samps, ap.stations[0].search.overlap
        flush_s = (rows - overlap) // gulp * gulp * cfg.tsamp
        flush_trig = [t for t in res["triggers"] if t.peak_time >= flush_s]
        check(not flush_trig, f"[15] triggers from the last gulp (from "
              f"{flush_s:.3f} s): {flush_trig}")
        # every dump holds the staged seconds it lists; the first DM-80
        # trigger has one dump per station, holding the burst's second
        frb_dumps = {}
        for rec in res["dumps"]:
            sid = int(os.path.basename(rec.path).split("_ea")[1][:2])
            with open(rec.path, "rb") as fp:
                got = fp.read()
            want = b"".join(staged[sid][int(sec - t0_unix) % 3].tobytes()
                            for sec in rec.seconds)
            check(got == want, f"[15] dump {rec.path} ({rec.seconds}) differs "
                  f"from the staged seconds it lists")
            if rec.t0 == first.t0:
                frb_dumps.setdefault(sid, []).append(rec)
        burst_sec = int(t0_unix + first.peak_time)
        check(sorted(frb_dumps) == sorted(staged) and all(
            len(v) == 1 and burst_sec in v[0].seconds
            for v in frb_dumps.values()),
            f"[15] dumps of the DM-{cfg.inject_dm:g} trigger by station "
            f"{frb_dumps}")
        others = len(res["triggers"]) - 1
        check(others == 0, f"[15] triggers other than the FRB's: "
              f"{res['triggers']}")
        twin = sum(len(st.feed_seconds["twin"]) for st in ap.stations)
        armed = sum(len(st.feed_seconds["armed"]) for st in ap.stations)
        gulps = sum(int(st.metrics.get("vfast_gulps_searched"))
                    for st in ap.stations)
        f32 = launches["dedisperse_pallas"] - \
            launches["dedisperse_pallas_packed"]
        check(twin + armed == nant * n_sec
              and armed == nant * sum(on_track(cfg, n_sec))
              and launches["chain_second_v2"] == twin
              and all(launches[k] == armed + nant * (k == "rfi_front")
                      for k in ARMED_KERNELS)
              and launches["dedisperse_pallas_packed"] == gulps >= nant
              and f32 == ap.coadd.gulps >= 1
              and all(launches[k] == gulps + f32 for k in SEARCH_KERNELS),
              f"[15] launches {launches} vs {twin} twin and {armed} armed "
              f"station-seconds, {nant} bandpass seeds, {gulps} station "
              f"gulps, {ap.coadd.gulps} coadd gulps")
        host = {}
        for when, lo, hi in (("before", 0, RING_SECONDS),
                             ("after", RING_SECONDS, n_sec)):
            host[when] = {k: 1e3 * float(np.mean(
                [t for st in ap.stations for t in st.host_seconds[k][lo:hi]]))
                for k in HOST_PARTS}
    finally:
        ap.close()
        shutil.rmtree(out_dir, ignore_errors=True)
    rtf = n_sec / wall
    # the coadd's spans (utils/spans "coadd" records), a data-second
    co_ms = {k: 1e3 * sum(r.parts([k])[k] for r in ap.coadd.records)
             / n_sec for k in ("sum", "search")}
    log(f"[15] array path: {nant} stations x {n_sec} s "
        f"(ArrayPipeline.run_streaming, rings of {RING_SECONDS} s, .fil, "
        f"coadd search; {readings}) in {wall:.1f} s wall (prewarm "
        f"{t_pre:.1f} s before it): real-time factor {rtf:.3f} "
        f"(data-seconds over wall), {nant * rtf:.3f} antenna-seconds a "
        f"second; wall a data-second {1e3 * walls['before']:.1f} ms before "
        f"the rings wrap ({nant / walls['before']:.3f} antenna-seconds a "
        f"second), {1e3 * walls['after']:.1f} ms after "
        f"({nant / walls['after']:.3f}), then a tail of "
        f"{walls['tail']:.1f} s (last drains, flush gulps, last dumps); "
        f"coadd host ms a data-second (its spans): sum {co_ms['sum']:.2f}, "
        f"search "
        f"{co_ms['search']:.2f}; host ms per station-second before the "
        f"rings wrap "
        + ", ".join(f"{k} {v:.2f}" for k, v in host["before"].items())
        + "; after "
        + ", ".join(f"{k} {v:.2f}" for k, v in host["after"].items())
        + f"; peak device memory {peak:.2f} GiB; FRB per beam S/N "
        + ", ".join(f"{b.snr:.2f} (DM {b.dm:.2f})" for b in beams.values())
        + f"; coadd S/N {co_best.snr:.2f} at DM {co_best.dm:.2f}, "
        f"{co_best.snr / beam_mean:.3f}x the beams' mean (sqrt(N) "
        f"{math.sqrt(nant):.3f}); first DM-{cfg.inject_dm:g} trigger raised "
        f"after {first_at} data seconds, one dump a station holding second "
        f"{burst_sec - int(t0_unix)}; {others} other trigger(s); "
        f"{len(res['dumps'])} dumps, each equal to its staged seconds; "
        f"{ap.coadd.gulps} coadd gulps "
        f"through the f32 entry, {gulps} station gulps through the packed "
        f"entry; launches {launches}")
    return launches


# [16]: the entry points a deployment starts, each in processes of its own
ENTRY_SECONDS = 24        # the file: one full gulp (21.3 s) and the flush
LIVE_SECONDS = 12         # [16c]: data-seconds blasted at the daemon

# [16c]'s daemon below the wire rate: station_main's own command line,
# without the capture's packet-time check (writer.c's clock abort): a
# replay paced below the wire rate falls behind the wall clock by design
PACED_DAEMON = """
from vlite_fast_tpu_torch.runtime import capture, station_main
capture.SecondAssembler._check_wallclock = lambda self, seconds: None
station_main.main()
"""

# [16c]'s sender: frames from the file, restamped to the wall clock's
# seconds (data-second j carries the second it is sent in at the wire
# rate), sent through the port's netcap udp_blast at `pace` frames a
# second; prints one JSON line
SENDER = r"""
import ctypes, json, socket, sys, time
import numpy as np
from vlite_fast_tpu_torch import constants as C
from vlite_fast_tpu_torch.runtime.capture import netcap_lib
from vlite_fast_tpu_torch.utils import vdif
path, port, nsec, pace, per_sec, t_first = sys.argv[1], int(sys.argv[2]), \
    int(sys.argv[3]), float(sys.argv[4]), int(sys.argv[5]), \
    float(sys.argv[6])
fb = C.VDIF_FRAME_BYTES
frames = np.fromfile(path, np.uint8, count=nsec * per_sec * fb).reshape(-1, fb)
words = frames.view(np.uint32)
lib = netcap_lib()
tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
tx.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 64 << 20)
tx.connect(("127.0.0.1", port))
epoch = vdif.default_ref_epoch(t_first)
sec0 = int(t_first) - int(vdif._epoch_unix(epoch))
for j in range(nsec):
    w = words[j * per_sec:(j + 1) * per_sec]
    w[:, 0] = (w[:, 0] & np.uint32(0xC0000000)) | np.uint32(sec0 + j)
    w[:, 1] = (w[:, 1] & np.uint32(0xC0FFFFFF)) | np.uint32(epoch << 24)
while time.time() < t_first:
    time.sleep(0.001)
late = time.time() - t_first
t0, sent, stalls, n = time.perf_counter(), 0, 0, len(frames)
while sent < n:
    k = lib.udp_blast(tx.fileno(), frames[sent:].ctypes.data_as(
        ctypes.c_void_p), fb, min(512, n - sent))
    if k <= 0:
        stalls += 1
        time.sleep(0.0005)
        continue
    sent += k
    ahead = sent / pace - (time.perf_counter() - t0)
    if ahead > 0.002:
        time.sleep(ahead)
dt = time.perf_counter() - t0
print(json.dumps({"sent": sent, "seconds": dt, "rate": sent / dt,
                  "stalls": stalls, "late_s": late}))
"""


def _env() -> dict:
    """The environment of [16]'s processes: this checkout's package."""
    import os
    env = dict(os.environ)
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _free_ports(n: int, kind: int = None, consecutive: bool = False) -> list:
    """n ports free on loopback right now (bound, then released);
    consecutive from a free base when asked."""
    import socket
    kind = kind or socket.SOCK_STREAM
    while True:
        socks = []
        try:
            for k in range(n):
                s = socket.socket(socket.AF_INET, kind)
                socks.append(s)
                s.bind(("127.0.0.1", socks[0].getsockname()[1] + k
                        if consecutive and k else 0))
            return [s.getsockname()[1] for s in socks]
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()


def _array_config(sources: list, cfg, scfg):
    from vlite_fast_tpu_torch.config import (AntennaConfig, ArrayConfig,
                                             TriggerConfig)
    import socket
    cmd, coinc = _free_ports(2)
    trig = _free_ports(len(sources) + 1, socket.SOCK_DGRAM, True)[0]
    return ArrayConfig(
        antennas=tuple(AntennaConfig(station_id=i + 1, name=f"ea{i + 1:02d}",
                                     source=src)
                       for i, src in enumerate(sources)),
        pipeline=cfg, search=scfg, trigger=TriggerConfig(min_dm=20.0),
        command_port=cmd, coincidencer_port=coinc, trigger_port_base=trig)


def _summaries(text: str) -> list:
    """The station daemons' observation summary lines, parsed."""
    from vlite_fast_tpu_torch.runtime.station_main import SUMMARY
    return [json.loads(line.split(SUMMARY, 1)[1]) for line in
            text.splitlines() if SUMMARY in line]


def wire_rate(cfg) -> int:
    """Frames a second of one antenna, both pols (51,200: 256 MB/s)."""
    from vlite_fast_tpu_torch import constants as C
    return cfg.npol_in * cfg.sample_rate // C.VDIF_DATA_BYTES


def _gib(x) -> str:
    return "n/a" if x is None else f"{x:.2f} GiB"


def _frb(cands, cfg):
    """The strongest candidate within 10% of the injected DM, or None."""
    near = [c for c in cands
            if abs(c.dm - cfg.inject_dm) <= 0.1 * cfg.inject_dm]
    return max(near, key=lambda c: c.snr) if near else None


def _add(total: dict, got: dict) -> None:
    for k, v in got.items():
        total[k] = total.get(k, 0) + v


def _bound_udp(port: int) -> bool:
    """Whether a socket of this machine holds UDP `port`."""
    with open("/proc/net/udp") as fp:
        return any(line.split()[1].endswith(f":{port:04X}")
                   for line in list(fp)[1:])


def entry_file(dev, cfg) -> tuple:
    """[16]'s input: ENTRY_SECONDS of VDIF at the reference geometry, three
    noise seconds made on the card from torch seeds, framed by the port's
    utils/vdif and cycled by advancing the header's second, written under
    the temporary directory, which must hold it and [16]'s products.
    Returns (path, the three seconds' samples, the first second's unix
    time, readings)."""
    import os
    from vlite_fast_tpu_torch import constants as C
    from vlite_fast_tpu_torch.runtime.capture import to_unix
    from vlite_fast_tpu_torch.utils import vdif
    sec_bytes = cfg.npol_in * cfg.sample_rate
    size = ENTRY_SECONDS * sec_bytes // C.VDIF_DATA_BYTES * C.VDIF_FRAME_BYTES
    # the file, two .fil pairs, and dumps of at most 2 + 11 s a station
    need = size + 2 * 13 * sec_bytes + 4 * ENTRY_SECONDS * 2 ** 20
    shm_free, mem_avail = shm_and_memory()
    rings = 2 * RING_SECONDS * sec_bytes          # [16b]'s two daemons
    where = tempfile.gettempdir()
    free = shutil.disk_usage(where).free
    readings = (f"{where} free {free / 1e9:.1f} GB, /dev/shm free "
                f"{shm_free / 1e9:.1f} GB, memory available "
                f"{mem_avail / 1e9:.1f} GB; the file {size / 1e9:.2f} GB, "
                f"[16]'s products up to {(need - size) / 1e9:.2f} GB, "
                f"[16b]'s rings {rings / 1e9:.2f} GB")
    check(free >= 1.25 * need and shm_free >= 1.25 * rings,
          f"[16] no room: {readings}")
    gen = torch.Generator(device=dev).manual_seed(2001)
    secs = [(torch.randn((cfg.npol_in, cfg.sample_rate), generator=gen,
                         device=dev) / 0.05914 + 128.5).clamp(0, 255)
            .to(torch.uint8).cpu().numpy() for _ in range(3)]
    epoch, sec0 = 40, 1000
    frames = [vdif.streams_to_frames(x, epoch, sec0, station_id=1,
                                     sample_rate=cfg.sample_rate)
              for x in secs]
    out_dir = tempfile.mkdtemp(prefix="vfast_entry_", dir=where)
    path = os.path.join(out_dir, "entry.vdif")
    t0 = time.perf_counter()
    with open(path, "wb") as fp:
        for j in range(ENTRY_SECONDS):
            fr = frames[j % 3].copy()
            w = fr.reshape(-1, C.VDIF_FRAME_BYTES).view(np.uint32)
            w[:, 0] = (w[:, 0] & np.uint32(0xC0000000)) | np.uint32(sec0 + j)
            fp.write(memoryview(fr))
    check(os.path.getsize(path) == size, f"[16] {path} is not {size} bytes")
    readings += f"; written in {time.perf_counter() - t0:.1f} s"
    return path, secs, to_unix(sec0, epoch), readings


def phase_process(cfg, path: str, out_dir: str, device: str = "cuda",
                  extra: tuple = ()) -> dict:
    """[16a] `python -m vlite_fast_tpu_torch.cli process FILE -i`: the FRB
    and a .fil of ENTRY_SECONDS.  Returns its kernel launches."""
    from vlite_fast_tpu_torch.ops.dedisperse import Candidate
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "vlite_fast_tpu_torch.cli", "--device", device,
         "process", path, "-i", "-o", out_dir, *extra], capture_output=True,
        text=True, env=_env(), timeout=600)
    took = time.perf_counter() - t0
    check(res.returncode == 0, f"[16a] cli process exited "
          f"{res.returncode}:\n{res.stderr[-3000:]}")
    got = json.loads(res.stdout.strip().splitlines()[-1])
    cands = [Candidate.from_line(c) for c in got["candidates"]]
    best = _frb(cands, cfg)
    check(best is not None and best.snr >= 10.0,
          f"[16a] FRB not recovered: {best}")
    rows = ENTRY_SECONDS * cfg.seg_per_sec * cfg.out_samps_per_seg
    check(got["seconds"] == ENTRY_SECONDS, f"[16a] {got['seconds']} seconds")
    check_fil(got["fil"], rows, cfg.nchanout * cfg.nbit // 8, what="[16a]")
    launched = got["launches"]
    # armed seconds; rfi_front once more for the observation's seed
    armed = launched.get("normalize_ema_pallas", 0)
    check(armed >= 1 and all(launched.get(k) == armed + (k == "rfi_front")
                             for k in ARMED_KERNELS)
          and launched.get("chain_second_v2", 0) + armed == ENTRY_SECONDS
          and launched.get("dedisperse_pallas_packed", 0) >= 2,
          f"[16a] launches {launched}")
    strongest = max(cands, key=lambda c: c.snr)
    log(f"[16a] cli process of {ENTRY_SECONDS} s: exit 0 in {took:.1f} s "
        f"(the process, start-up and prewarm included); rt_factor "
        f"{got['rt_factor']}, wall {got['wall_s']:.2f} s "
        f"({1e3 * got['wall_s'] / ENTRY_SECONDS:.1f} ms a data-second), of "
        f"which replay_file and the assembler {got['replay_s']:.2f} s "
        f"({1e3 * got['replay_s'] / ENTRY_SECONDS:.1f} ms a data-second); "
        f"peak device memory {_gib(got['peak_device_gib'])}; FRB S/N "
        f"{best.snr:.2f} at DM {best.dm:.2f}, {best.peak_time:.3f} s; "
        f"{len(cands)} candidates, the strongest S/N {strongest.snr:.2f} at "
        f"DM {strongest.dm:.2f}; .fil {rows} rows; launches {launched}")
    return launched


def _check_dumps(dumps: list, secs: list, t0_unix: float, what: str) -> None:
    """Every dump holds the file's seconds it is named from, in order."""
    import os
    sec_bytes = secs[0].nbytes
    for path in dumps:
        first = int(os.path.basename(path).rsplit("_", 1)[1][:-5])
        size = os.path.getsize(path)
        check(size > 0 and size % sec_bytes == 0,
              f"{what} dump {path}: {size} bytes")
        with open(path, "rb") as fp:
            for k in range(size // sec_bytes):
                want = secs[int(first + k - t0_unix) % 3]
                check(fp.read(sec_bytes) == want.tobytes(),
                      f"{what} dump {path}: second {first + k} differs from "
                      f"the file's")


def phase_launch(cfg, scfg, path: str, secs: list, t0_unix: float,
                 out_dir: str, device: str = "cuda") -> dict:
    """[16b] `cli launch --fake` of two stations (the same file: source for
    both), the leader in the CLI's process, each daemon a process of its
    own on the one card: both connect, a trigger near the injected DM,
    each station's .fil and its dumps equal to the file's seconds, and no
    other trigger.  Returns the daemons' kernel launches."""
    import glob
    import os
    acfg = _array_config([f"file:{path}"] * 2, cfg, scfg)
    cfg_path = os.path.join(out_dir, "array.json")
    acfg.save(cfg_path)
    products = os.path.join(out_dir, "launch")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "vlite_fast_tpu_torch.cli", "launch",
         cfg_path, "--out-dir", products, "--fake", "--fake-duration", "300",
         "--startup-timeout", "240", "--device", device],
        capture_output=True, text=True, env=_env(), timeout=720)
    took = time.perf_counter() - t0
    check(res.returncode == 0, f"[16b] cli launch exited {res.returncode}:"
          f"\n{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
    out = res.stdout.strip().splitlines()
    check("array up: 2 stations connected" in out,
          f"[16b] the array did not come up: {out[-5:]}")
    got = json.loads(out[-1])
    check(got["exit_codes"] == [0, 0], f"[16b] daemons exited "
          f"{got['exit_codes']}:\n{res.stderr[-4000:]}")
    summ = {s["station"]: s for s in _summaries(res.stderr)}
    check(sorted(summ) == [1, 2], f"[16b] observation summaries of "
          f"stations {sorted(summ)}:\n{res.stderr[-4000:]}")
    trig = got["trigger_list"]
    frb = [t for t in trig if abs(t["dm"] - cfg.inject_dm)
           <= 0.1 * cfg.inject_dm]
    check(got["triggers"] >= 1 and bool(frb),
          f"[16b] no trigger near DM {cfg.inject_dm}: {trig}")
    rows = ENTRY_SECONDS * cfg.seg_per_sec * cfg.out_samps_per_seg
    launched = {}
    for sid, s in sorted(summ.items()):
        check(s["seconds"] == ENTRY_SECONDS and s["dropped"] == 0,
              f"[16b] station {sid}: {s['seconds']} seconds, "
              f"{s['dropped']} dropped")
        check_fil(s["fil"], rows, cfg.nchanout * cfg.nbit // 8,
                  what=f"[16b] station {sid}")
        check(os.path.exists(s["fil"].replace(".fil", "_plain.fil")),
              f"[16b] station {sid}: no plain .fil")
        _add(launched, s["launches"])
    dumps = glob.glob(os.path.join(products, "dumps", "*.vdif"))
    by_station = {sid: [d for d in dumps if f"_ea{sid:02d}_" in d]
                  for sid in summ}
    check(all(by_station.values()), f"[16b] dumps by station {by_station}")
    _check_dumps(dumps, secs, t0_unix, "[16b]")
    # armed station-seconds; rfi_front once more for each station's seed
    armed = launched.get("normalize_ema_pallas", 0)
    check(armed >= 2 and all(launched.get(k) == armed + 2 * (k == "rfi_front")
                             for k in ARMED_KERNELS)
          and launched.get("chain_second_v2", 0) + armed
          == 2 * ENTRY_SECONDS
          and launched.get("dedisperse_pallas_packed", 0) >= 4,
          f"[16b] launches {launched}")
    for t in trig:
        log(f"[16b]   trigger DM {t['dm']:.2f} S/N {t['sn']:.2f} window "
            f"[{t['t0'] - t0_unix:.3f}, {t['t1'] - t0_unix:.3f}] s "
            f"({t['meta']}), raised {t['fired_s']:.1f} s after FAKE_START")
    # the last gulp is searched over its own rows: no trigger but the FRB's
    other = [t for t in trig if t not in frb]
    check(not other, f"[16b] triggers other than the FRB's: {other}")
    log(f"[16b] cli launch --fake, 2 stations on the same {ENTRY_SECONDS}-s "
        f"file: exit 0 in {took:.1f} s; array up, {got['triggers']} "
        f"trigger(s), {len(frb)} near DM {cfg.inject_dm:g}, "
        f"{len(other)} other; per station: "
        + "; ".join(
            f"{sid}: wall {s['wall_s']:.1f} s, {1e3 * s['wall_per_data_s']:.1f}"
            f" ms a data-second (rt_factor {s['rt_factor']:.3f}), peak device"
            f" memory {_gib(s['peak_device_gib'])}, host ms a second "
            "(median) " + ", ".join(
                f"{k} {v:.2f}" for k, v in s["host_ms_median"].items())
            + f", {len(by_station[sid])} dump(s)"
            for sid, s in sorted(summ.items()))
        + f"; {len(dumps)} dumps, each equal to the file's seconds; "
        f"launches {launched}")
    return launched


def _live_attempt(cfg, scfg, path: str, out_dir: str, pace: float,
                  device: str = "cuda") -> dict:
    """One daemon on udp:PORT, the leader in this process, FAKE_START,
    LIVE_SECONDS of the file's frames blasted at `pace` frames a second,
    FAKE_STOP, QUIT.  Below the wire rate the daemon runs as PACED_DAEMON.
    Returns its summary, the candidates the leader's coincidencer
    received from it and the sender's reading."""
    import os
    from vlite_fast_tpu_torch.runtime.leader_main import Leader
    port = _free_ports(1)[0]
    acfg = _array_config([f"udp:{port}"], cfg, scfg)
    cfg_path = os.path.join(out_dir, f"live_{int(pace)}.json")
    acfg.save(cfg_path)
    products = os.path.join(out_dir, f"live_{int(pace)}")
    log_path = products + ".log"
    wire = wire_rate(cfg)
    cmd = [sys.executable, *(
        ["-m", "vlite_fast_tpu_torch.runtime.station_main"] if pace >= wire
        else ["-c", PACED_DAEMON]),
        "--station", "1", "--config", cfg_path, "--source", f"udp:{port}",
        "--out-dir", products, "--command-port", str(acfg.command_port),
        "--coincidencer", f"127.0.0.1:{acfg.coincidencer_port}",
        "--trigger-port", str(acfg.trigger_port_base + 1),
        "--device", device]
    leader = Leader(acfg, products)
    sender = None
    with open(log_path, "w") as log_fp:
        daemon = subprocess.Popen(cmd, stdout=log_fp, stderr=subprocess.STDOUT,
                                  env=_env())
        try:
            check(leader.wait_for_stations(1, timeout=180),
                  f"[16c] the daemon did not connect (exit "
                  f"{daemon.poll()}):\n{open(log_path).read()[-3000:]}")
            leader.fake_observation(settle_s=0.0)
            deadline = time.time() + 120
            while not _bound_udp(port) and time.time() < deadline \
                    and daemon.poll() is None:
                time.sleep(0.05)
            check(_bound_udp(port), f"[16c] the daemon never bound "
                  f"udp:{port}:\n{open(log_path).read()[-3000:]}")
            # the first frame leaves at a whole wall second, time enough
            # ahead for the sender to read and restamp its frames
            t_first = float(int(time.time()) + 6)
            sender = subprocess.Popen(
                [sys.executable, "-c", SENDER, path, str(port),
                 str(LIVE_SECONDS), str(pace), str(wire), str(t_first)],
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, env=_env())
            # FAKE_STOP as the last data-second starts: the daemon reads
            # commands between seconds, so it ends after the one before
            # (the last never completes: no frame of a next second comes)
            t_stop = t_first + (LIVE_SECONDS - 1) * wire / pace + 0.5
            while time.time() < t_stop and sender.poll() is None \
                    and not _summaries(open(log_path).read()):
                time.sleep(0.1)
            leader.stop_observation()
            deadline = time.time() + 120
            while time.time() < deadline and \
                    not _summaries(open(log_path).read()):
                time.sleep(0.2)
            summ = _summaries(open(log_path).read())
            check(len(summ) == 1, f"[16c] {len(summ)} observation "
                  f"summaries:\n{open(log_path).read()[-3000:]}")
            # the daemon shipped its last batch before its summary line:
            # wait for the coincidencer to take in every candidate
            deadline = time.time() + 30
            while time.time() < deadline and len(
                    _received(leader)) < summ[0]["candidates"]:
                time.sleep(0.1)
            cands = _received(leader)
            # the sender ends on its own schedule (frames sent after an
            # abort or the stop count as sent)
            try:
                sout, serr = sender.communicate(
                    timeout=max(t_first + LIVE_SECONDS * wire / pace
                                - time.time(), 0) + 60)
            except subprocess.TimeoutExpired:
                sender.kill()
                sout, serr = sender.communicate()
        finally:
            leader.shutdown()
            try:
                daemon.wait(timeout=60)
            except subprocess.TimeoutExpired:
                daemon.kill()
                daemon.wait()
            if sender is not None and sender.poll() is None:
                sender.kill()
                sender.wait()
    text = open(log_path).read()
    check(daemon.returncode == 0, f"[16c] the daemon exited "
          f"{daemon.returncode}:\n{text[-3000:]}")
    lines = sout.strip().splitlines()
    check(sender.returncode == 0 and bool(lines), f"[16c] the sender exited "
          f"{sender.returncode}; its output {sout[-500:]!r}, its errors "
          f"{serr[-2000:]!r}")
    sent = json.loads(lines[-1])
    cap = summ[0]["capture"]
    check(sent["sent"] == LIVE_SECONDS * wire
          and sent["sent"] >= cap["frames"] + cap["skipped"],
          f"[16c] the sender sent {sent['sent']} of {LIVE_SECONDS * wire} "
          f"frames; the daemon received {cap['frames']} and skipped "
          f"{cap['skipped']}")
    check(len(cands) == summ[0]["candidates"], f"[16c] the coincidencer "
          f"received {len(cands)} of {summ[0]['candidates']} candidates")
    return {"summary": summ[0], "candidates": cands, "sender": sent,
            "pace": pace, "check_clock": pace >= wire}


def _received(leader) -> list:
    """Every candidate the leader's coincidencer took in from station 1."""
    with leader.coincidencer._lock:
        return [c for beams in leader.coincidencer.utc_groups.values()
                for c in beams.get(1, [])]


def phase_live(cfg, scfg, path: str, out_dir: str,
               device: str = "cuda") -> dict:
    """[16c] one station daemon on live UDP at the wire rate, the pace
    halved after each attempt the capture aborts (at most twice): no
    abort, at least 10 whole seconds, the FRB among the candidates the
    leader received.  Returns the launches of every attempt."""
    attempts, launched = [], {}
    wire = wire_rate(cfg)
    pace = float(wire)
    for _ in range(3):
        att = _live_attempt(cfg, scfg, path, out_dir, pace, device)
        attempts.append(att)
        _add(launched, att["summary"]["launches"])
        s, cap, snd = att["summary"], att["summary"]["capture"], att["sender"]
        total = cap["frames"] + cap["skipped"]
        drop = cap["skipped"] / total if total else float("nan")
        host = ", ".join(
            f"{k} {s['host_ms_median'][k]:.1f} (max {s['host_ms_max'][k]:.1f})"
            for k in ("ring", "staging", "drain"))
        log(f"[16c] live UDP at {pace:.0f} frames/s ("
            f"{pace / wire:.3g}x the wire rate; wall-clock check "
            f"{'on' if att['check_clock'] else 'off'}): sender exit 0, "
            f"{snd['sent']} frames in {snd['seconds']:.3f} s, "
            f"{snd['rate']:.1f}/s, {snd['stalls']} stalls (started "
            f"{snd['late_s']:.3f} s after its second); daemon received "
            f"{cap['frames']}, skipped {cap['skipped']}, anomalous "
            f"{cap['anomalous']} (drop share {drop:.4f}); rcvbuf "
            f"{cap['rcvbuf']}; clock skew {cap['clock_skew_s']:.3f} s; abort "
            f"{cap['abort_reason']}; {s['seconds']} whole seconds processed "
            f"in {s['wall_s']:.1f} s; peak device memory "
            f"{_gib(s['peak_device_gib'])}; host ms a second, median: "
            f"{host}; {len(att['candidates'])} candidates at the leader; "
            f"launches {s['launches']}")
        if cap["abort_reason"] is None:
            break
        pace /= 2
    att = attempts[-1]
    s = att["summary"]
    check(s["capture"]["abort_reason"] is None,
          f"[16c] the capture aborted at every pace down to {pace:.0f} "
          f"frames/s: {s['capture']['abort_reason']}")
    check(s["seconds"] >= 10, f"[16c] {s['seconds']} whole seconds")
    best = _frb(att["candidates"], cfg)
    check(best is not None and best.snr >= 10.0,
          f"[16c] FRB not recovered: {best}")
    log(f"[16c] held at {pace:.0f} frames/s ({pace / wire:.3g}x the "
        f"wire rate) after {len(attempts)} attempt(s): FRB S/N "
        f"{best.snr:.2f} at DM {best.dm:.2f}")
    return launched


def phase_entry_points(dev) -> dict:
    """[16] the entry points on the card: [16a] cli process, [16b] cli
    launch --fake with two daemons, [16c] one daemon on live UDP.  Every
    process's exit code and output are checked.  Returns the kernel
    launches the three made, summed."""
    from vlite_fast_tpu_torch import PipelineConfig, SearchConfig
    cfg = PipelineConfig(inject_frb=True)
    scfg = SearchConfig()
    t0 = time.perf_counter()
    path, secs, t0_unix, readings = entry_file(dev, cfg)
    log(f"[16] input: {path}, {ENTRY_SECONDS} s of VDIF at the reference "
        f"geometry (three noise seconds from torch seeds 2001, cycled); "
        f"{readings}")
    import os
    out_dir = os.path.dirname(path)
    launched = {}
    try:
        _add(launched, phase_process(cfg, path, out_dir))
        _add(launched, phase_launch(cfg, scfg, path, secs, t0_unix, out_dir))
        _add(launched, phase_live(cfg, scfg, path, out_dir))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    log(f"[16] entry points passed in {time.perf_counter() - t0:.1f} s; "
        f"launches {launched}")
    return launched


# ---------------------------------------------------------------------------
# [17] every option one station honours: the polyphase channelizer, the
# Fourier search engine, DOHISTO, the profile, the config matrix
# ---------------------------------------------------------------------------

# [17a]: two arms, at seconds 0 and 60 (C.INJECT_PERIOD_S), and 12 s after
# the second, so that the gulps (12 s + the DM-1000 overlap, 9.3 s) search
# it
PFB_SECONDS = 72
PFB_FRB_S = 60
# the CUDA kernels of the armed program and the search, by a word of their
# names, to find in a torch.profiler trace
CTYPES_KERNELS = ("rfi_front_kernel", "bandpass_kernel", "ema_out_kernel",
                  "stage1_kernel", "stage2_kernel")


def noise_on_card(dev, npol: int, nsamp: int, seed: int) -> torch.Tensor:
    """Gaussian 8-bit voltages made on the card from a torch seed."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((npol, nsamp), generator=gen, device=dev) / 0.05914
            + 128.5).clamp(0, 255).to(torch.uint8)


def burst_on_card(raw: torch.Tensor, at: int) -> torch.Tensor:
    """with_burst on the card: a sinusoidal burst in pol 0."""
    t = torch.arange(3000, device=raw.device, dtype=torch.float32)
    out = raw.to(torch.int16)
    out[0, at:at + 3000] += (60 * torch.sin(0.3 * t)).to(torch.int16)
    return out.clamp(0, 255).to(torch.uint8)


def compare_seconds(cfg, got, st_g, want, st_w, what: str) -> dict:
    """The chain bar at cfg.nbit between two programs' outputs and
    states: >= 0.9999 of levels agree in both streams, weights within
    1e-6 relative, dag_frac within 1e-6, bandpasses within 1e-4 relative;
    histograms and carried tails equal.  Returns the worst readings."""
    agree = 1.0
    for f in ("packed", "packed_kur"):
        lg = levels(getattr(got, f), cfg.nbit)
        lw = levels(getattr(want, f), cfg.nbit)
        check(lg.shape == lw.shape, f"{what}: {f} shapes {lg.shape} vs "
              f"{lw.shape}")
        agree = min(agree, float((lg == lw).mean()))
    check(agree >= 0.9999, f"{what}: level agreement {agree}")
    w_rel = rel_err(got.weights, want.weights, 1e-6)
    check(w_rel <= 1e-6, f"{what}: weights off by {w_rel} relative")
    dag = abs(float(got.dag_frac) - float(want.dag_frac))
    check(dag <= 1e-6, f"{what}: dag_frac off by {dag}")
    bp_rel = max(rel_err(getattr(st_g, f), getattr(st_w, f), 1e-6)
                 for f in ("bp", "bp_kur"))
    check(bp_rel < 1e-4, f"{what}: bandpass off by {bp_rel} relative")
    check(torch.equal(got.histo, want.histo), f"{what}: histograms differ")
    check(torch.equal(st_g.tail, st_w.tail) and
          torch.equal(st_g.wtail, st_w.wtail), f"{what}: WOLA tails differ")
    return {"agree": agree, "weights_rel": w_rel, "dag": dag,
            "bp_rel": bp_rel}


def pfb_parts(dev, cfg, raw) -> dict:
    """Device ms of each part of one pfb second of the armed program,
    each timed alone (CUDA events, 3 reps) on the second's own
    intermediates: both streams where the program runs both."""
    from vlite_fast_tpu_torch.ops import channelize as ch_ops
    from vlite_fast_tpu_torch.ops import kurtosis as kur_ops
    from vlite_fast_tpu_torch.ops import normalize as norm_ops
    from vlite_fast_tpu_torch.ops import pallas_kernels as pk
    from vlite_fast_tpu_torch.ops import rfi_pallas
    from vlite_fast_tpu_torch.ops import unpack as unpack_ops
    from vlite_fast_tpu_torch.models import baseband_dsp as dsp
    tl = (cfg.pfb_ntap - 1) * cfg.nfft
    tail = torch.zeros((cfg.npol_in, tl), device=dev)
    bp = torch.zeros((cfg.npol_in, cfg.nchan), device=dev)
    args = (cfg.nkurto, cfg.nfft, cfg.dag_thresh, cfg.dag_fb_thresh)
    x = unpack_ops.convert_uint8(raw)
    x_kur, weights, _ = rfi_pallas.rfi_front(raw, *args)
    frames = ch_ops.wola(x_kur, cfg.nfft, cfg.pfb_ntap, tail)
    spec = ch_ops.matmul_rfft(frames, cfg.nfft)
    power = norm_ops.detect(spec)
    out, _ = pk.normalize_ema_weighted_pallas(power, weights, bp,
                                              cfg.bp_scale,
                                              time_tile=cfg.ffts_per_seg)
    parts = {
        "rfi_front": cuda_ms(lambda: rfi_pallas.rfi_front(raw, *args), 3),
        "convert": cuda_ms(lambda: unpack_ops.convert_uint8(raw), 3),
        "WOLA x2": 2 * cuda_ms(lambda: ch_ops.wola(
            x_kur, cfg.nfft, cfg.pfb_ntap, tail), 3),
        "DFT GEMMs x2": 2 * cuda_ms(lambda: ch_ops.matmul_rfft(
            frames, cfg.nfft), 3),
        "detect x2": 2 * cuda_ms(lambda: norm_ops.detect(spec), 3),
        "normalize_ema_pallas": cuda_ms(lambda: pk.normalize_ema_pallas(
            power, bp, cfg.bp_scale, time_tile=cfg.ffts_per_seg), 3),
        "normalize_ema_weighted_pallas": cuda_ms(
            lambda: pk.normalize_ema_weighted_pallas(
                power, weights, bp, cfg.bp_scale,
                time_tile=cfg.ffts_per_seg), 3),
        "scrunch and pack x2": cuda_ms(
            lambda: dsp._finish_stream(cfg, out, None), 3)
        + cuda_ms(lambda: dsp._finish_stream(cfg, out, weights), 3),
        "pfb_weights": cuda_ms(lambda: ch_ops.pfb_weights(
            weights, cfg.pfb_ntap, cfg.nfft), 3),
        "histogram": cuda_ms(lambda: kur_ops.sample_histogram(raw), 3)}
    return parts


def phase_pfb(dev) -> tuple:
    """[17a] the polyphase channelizer's observation, DOHISTO and the
    profile: PFB_SECONDS staged seconds through run_observation with a
    profile_dir, after prewarm.  Both arms' FRBs are held to S/N >= 20:
    the bandpass seed leaves out the spectra that the WOLA's zero tail (a
    fresh state's) makes partial, so no start-up transient covers the
    first.  Returns (its kernel launches, the packed rows the block tap
    received, by second)."""
    import os
    from vlite_fast_tpu_torch import PipelineConfig, SearchConfig
    from vlite_fast_tpu_torch.models import baseband_dsp as dsp
    from vlite_fast_tpu_torch.runtime.pipeline import (PROFILE_RANGES,
                                                       ObservationDocument,
                                                       StationPipeline)
    from vlite_fast_tpu_torch.utils import sigproc
    cfg = PipelineConfig(channelizer="pfb", inject_frb=True, do_histo=True)
    scfg = SearchConfig()
    staged = [noise_on_card(dev, cfg.npol_in, cfg.sample_rate, 1700 + i)
              for i in range(3)]
    staged[2] = burst_on_card(staged[2], cfg.sample_rate * 5 // 16)
    out_dir = tempfile.mkdtemp(prefix="vfast_pfb_")
    blocks = []
    try:
        pipe = StationPipeline(1, cfg, scfg, out_dir=out_dir,
                               keep_ring=False, write_cands=False,
                               device=dev)
        _, twin, twin_cfg = dsp.second_program(cfg, -1)
        check(twin is dsp.process_second and twin_cfg.chain_impl == "xla",
              f"[17a] the pfb twin resolved to {twin.__name__} "
              f"{twin_cfg.chain_impl}")
        pipe.block_taps.append(lambda sid, off, blk: blocks.append(blk.copy()))
        t_pre = time.perf_counter()
        pipe.prewarm()
        t_pre = time.perf_counter() - t_pre
        od = ObservationDocument(name="SMOKE_PFB", start_time=1.7e9)
        seconds = lambda: ((1.7e9 + s, staged[s % 3])
                           for s in range(PFB_SECONDS))
        torch.cuda.reset_peak_memory_stats(dev)
        kernel_launches.zero()
        t0 = time.perf_counter()
        prod = pipe.run_observation(seconds(), od, profile_dir=os.path.join(
            out_dir, "profile"))
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
        launches = kernel_launches.counts()
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        armed = list(pipe.feed_seconds["armed"])
        twin_s = list(pipe.feed_seconds["twin"])
        gulps = int(pipe.metrics.get("vfast_gulps_searched"))
        with open(pipe.profile_path) as fp:
            events = json.load(fp)["traceEvents"]
        trace_mb = os.path.getsize(pipe.profile_path) / 2 ** 20
        names = {e.get("name") for e in events}
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        seen = sorted({w for w in CTYPES_KERNELS
                       if any(w in k for k in kernels)})
        check(set(PROFILE_RANGES) <= names, f"[17a] the trace lacks "
              f"{set(PROFILE_RANGES) - names}")
        hist = np.load(prod.fil_path.replace(".fil", "_histo.npz"))[
            "histogram"]
        rows = cfg.seg_per_sec * cfg.out_samps_per_seg
        row_bytes = cfg.nchanout * cfg.nbit // 8
        with open(prod.fil_path.replace(".fil", "_plain.fil"), "rb") as fp:
            sigproc.read_header(fp)
            plain_rows = np.frombuffer(fp.read(2 * rows * row_bytes),
                                       np.uint8).reshape(2 * rows,
                                                         row_bytes).copy()
        # the same observation without the profiler, for its wall
        t0 = time.perf_counter()
        pipe.run_observation(seconds(), od, write_fil=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    # every second through the armed program's kernels, each gulp through
    # the dedispersion kernel's packed entry, never a chain kernel; every
    # twin second (the track reaches the armed ones) through the fused
    # WOLA kernel
    check(prod.seconds == PFB_SECONDS and len(armed) + len(twin_s)
          == PFB_SECONDS and len(armed) == sum(on_track(cfg, PFB_SECONDS)),
          f"[17a] {prod.seconds} seconds, {len(armed)} armed")
    check(all(launches[k] == PFB_SECONDS + (k == "rfi_front")
              for k in ARMED_KERNELS)
          and not any(launches[k] for k in CHAIN_KERNELS)
          and launches["wola_dft_detect_power"] == 2 * len(twin_s),
          f"[17a] launches {launches} vs {PFB_SECONDS} seconds, one "
          f"bandpass seed and the fused WOLA kernel twice a twin second "
          f"({len(twin_s)})")
    check(gulps >= 1 and launches["dedisperse_pallas_packed"] == gulps,
          f"[17a] dedispersion launches {launches} vs {gulps} gulps")
    def frb(at):          # the best candidate near DM 80 within 1.5 s of at
        near = [c for c in prod.candidates
                if abs(c.dm - cfg.inject_dm) <= 0.1 * cfg.inject_dm
                and at <= c.peak_time <= at + 1.5]
        return max(near, key=lambda c: c.snr) if near else None
    best, first = frb(PFB_FRB_S), frb(0.0)
    top = max(prod.candidates, key=lambda c: c.snr) \
        if prod.candidates else None
    check(best is not None and best.snr >= 20.0,
          f"[17a] FRB armed at {PFB_FRB_S} s not recovered at S/N >= 20: "
          f"best near DM 80 {best}, top {top}")
    check(first is not None and first.snr >= 20.0,
          f"[17a] FRB armed at 0 s not recovered at S/N >= 20: best near "
          f"DM 80 {first}, top {top}")
    early = bench.start_transient(prod.candidates, scfg)
    check(not early, f"[17a] candidates below DM {bench.START_MAX_DM:g} in "
          f"the first {bench.START_S:g} s: {early}")
    # DOHISTO: the product is the staged seconds' bincount, every sample
    per_sec = [np.stack([np.bincount(r, minlength=256) for r in
                         s.cpu().numpy()]) for s in staged]
    want_hist = sum(per_sec[s % 3] for s in range(PFB_SECONDS))
    check(np.array_equal(hist, want_hist) and int(hist.sum())
          == cfg.npol_in * cfg.sample_rate * PFB_SECONDS,
          f"[17a] _histo.npz differs from the staged seconds' bincount "
          f"(sum {int(hist.sum())})")
    # the first two seconds against the plain program, and the kernel
    # program against the plain one in full, each from its own seed
    st_k, st_p, seed_note = seed_check(dev, cfg, staged[0], "[17a]")
    worst, same, t_plain = {}, [], []
    for sec in range(2):
        got, st_k = dsp.process_second(cfg, staged[sec], st_k, sec == 0)
        (want, st_p), ms = timed_wall(lambda: dsp.process_second_plain(
            cfg, staged[sec], st_p, sec == 0))
        t_plain.append(ms)
        r = compare_seconds(cfg, got, st_k, want, st_p,
                            f"[17a] pfb second {sec}")
        worst = {k: (min if k == "agree" else max)(worst.get(k, v), v)
                 for k, v in r.items()}
        pipe_kur = torch.from_numpy(blocks[sec])
        pipe_plain = torch.from_numpy(plain_rows[sec * rows:(sec + 1) * rows])
        for mine, theirs, f in ((pipe_kur, want.packed_kur, ".fil"),
                                (pipe_plain, want.packed, "_plain.fil")):
            a, _ = agreement(mine, theirs)
            check(a >= 0.9999, f"[17a] second {sec}'s {f} rows vs "
                  f"process_second_plain: agreement {a}")
            worst["agree"] = min(worst["agree"], a)
        same.append(torch.equal(pipe_kur, got.packed_kur.cpu()))
    ms = cuda_ms(lambda: dsp.process_second(cfg, staged[0], st_k, False), 3)
    parts = pfb_parts(dev, cfg, staged[2])
    spans = armed + twin_s
    log(f"[17a] pfb observation (PipelineConfig(channelizer='pfb', "
        f"inject_frb=True, do_histo=True), SearchConfig()): {prod.seconds} s "
        f"in {wall:.2f} s wall, real-time factor {PFB_SECONDS / wall:.3f} "
        f"({wall_prof:.2f} s profiled, the trace's export included; "
        f"prewarm {t_pre:.2f} s before); span per data-second (CUDA events) "
        f"armed {', '.join(f'{1e3 * a:.1f}' for a in armed)} ms, twin "
        f"(process_second, injection off) median "
        f"{1e3 * float(np.median(twin_s)):.2f} ms x{len(twin_s)}, summed "
        f"{sum(spans):.2f} s; {gulps} gulps; the FRB armed at {PFB_FRB_S} s "
        f"at DM {best.dm:.2f} S/N {best.snr:.2f}, {best.peak_time:.3f} s; "
        f"the one armed at 0 s at DM {first.dm:.2f} S/N {first.snr:.2f}, "
        f"{first.peak_time:.3f} s; none below DM {bench.START_MAX_DM:g} in "
        f"the first {bench.START_S:g} s (top candidate DM {top.dm:.2f} S/N "
        f"{top.snr:.2f} at {top.peak_time:.3f} s, {len(prod.candidates)} "
        f"candidates); peak "
        f"device memory "
        f"{peak:.2f} GiB; launches {launches}")
    log(f"[17a] {seed_note}; first 2 seconds from the kernel's seed vs "
        f"process_second_plain from the plain front's: the pipeline's "
        f".fil and _plain.fil rows and process_second's outputs, level "
        f"agreement >= {worst['agree']:.6f} (bar 0.9999), weights rel "
        f"{worst['weights_rel']:.2e}, dag_frac diff {worst['dag']:.2e}, "
        f"bandpass rel {worst['bp_rel']:.2e}, histograms and WOLA tails "
        f"equal; the pipeline's .fil rows bit-equal to process_second's: "
        f"{same}; process_second {ms:.2f} ms per second (CUDA events, 3 "
        f"reps), plain {t_plain[0]:.0f} / {t_plain[1]:.0f} ms (wall)")
    log(f"[17a] one pfb second's device ms by part (each alone, CUDA events, "
        f"3 reps): " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"; sum {sum(parts.values()):.2f} against process_second's "
        f"{ms:.2f}")
    log(f"[17a] _histo.npz: {hist.shape} int{8 * hist.itemsize}, sum "
        f"{int(hist.sum())} = 2 x {cfg.sample_rate} x {PFB_SECONDS}, equal "
        f"to numpy's bincount of the staged seconds; trace "
        f"{trace_mb:.1f} MiB, {len(events)} events, ranges "
        f"{sorted(PROFILE_RANGES)} present, {len(kernels)} kernel events, "
        f"the CUDA libraries' kernels in it: {seen or 'none'}")
    return launches, blocks


def phase_wola(dev) -> dict:
    """[17a'] the pfb station's fused WOLA, DFT and detect
    (ops/megakernel.wola_dft_detect_power) at production shapes, one
    stream (stream 0's u8 bytes, stream 1's masked f32 voltages) and both,
    by CUDA events, beside its bound, its plain version's wall and the
    torch WOLA + matmul_rfft + detect it replaces in the twin second; the
    kernel within 1e-4 of the mean power of the plain version; ptxas's
    registers and spills of every dft_tc_kernel instantiation."""
    from vlite_fast_tpu_torch import PipelineConfig
    from vlite_fast_tpu_torch.ops import channelize as ch_ops
    from vlite_fast_tpu_torch.ops import megakernel as mk
    from vlite_fast_tpu_torch.ops import normalize as norm_ops
    from vlite_fast_tpu_torch.ops import rfi_pallas
    from vlite_fast_tpu_torch.ops import unpack as unpack_ops
    cfg = PipelineConfig(channelizer="pfb", inject_frb=True)
    raw = noise_on_card(dev, cfg.npol_in, cfg.sample_rate, 1721)
    x_kur, _, _ = rfi_pallas.rfi_front(
        raw, cfg.nkurto, cfg.nfft, dag_thresh=cfg.dag_thresh,
        dag_fb_thresh=cfg.dag_fb_thresh)
    gen = torch.Generator(device=dev).manual_seed(1722)
    tail = 0.3 * torch.randn((cfg.npol_in, (cfg.pfb_ntap - 1) * cfg.nfft),
                             generator=gen, device=dev)
    run = lambda v: mk.wola_dft_detect_power(v, tail, cfg)
    ms = {"u8": cuda_ms(lambda: run(raw), 5),
          "f32": cuda_ms(lambda: run(x_kur), 5),
          "both": cuda_ms(lambda: (run(raw), run(x_kur)), 5)}

    def torch_stream(v):
        frames = ch_ops.wola(v, cfg.nfft, cfg.pfb_ntap, tail)
        return norm_ops.detect(ch_ops.matmul_rfft(frames, cfg.nfft))
    ms_torch = cuda_ms(lambda: (torch_stream(unpack_ops.convert_uint8(raw)),
                                torch_stream(x_kur)), 3)
    err = 0.0
    for v in (raw, x_kur):
        want, plain_ms = timed_wall(lambda: mk.wola_dft_detect_plain(
            v, tail, cfg))
        got = run(v)
        torch.cuda.synchronize()
        err = max(err, float((got - want).abs().max() / want.mean()))
        del got, want
    check(err < 1e-4, f"[17a'] the fused WOLA kernel off its plain version "
          f"by {err:.3e} of the mean power")
    # both streams: the second's bytes and masked voltages read once, the
    # two power planes written once, the padded products of 2 x frames
    frames = cfg.npol_in * (cfg.sample_rate // cfg.nfft)
    ops = perf.tc_dft_ops(cfg, 2 * frames, planes1=6)
    moved = cfg.npol_in * cfg.sample_rate * 5 + 2 * 4 * frames * cfg.nchan
    bound = perf.bound(moved, ops, "bf16")
    regs = {}
    for lib in ("wola_tc", "chain", "stage_ab"):
        regs.update(ptxas_kernels(lib, "dft_tc_kernel"))
    geo = {"wola": mk.tc_geometry(cfg.nfft, wola=True).smem,
           "raw second": mk.tc_geometry(cfg.nfft).smem,
           "CT u8": mk.tc_geometry(cfg.nfft, 1).smem,
           "CT bf16": mk.tc_geometry(cfg.nfft, 2).smem}
    log(f"[17a'] the fused WOLA kernel (wola_dft_detect_power, "
        f"{cfg.pfb_ntap} taps, nfft {cfg.nfft}) per data-second: stream 0 "
        f"(u8) {ms['u8']:.3f} ms, stream 1 (f32) {ms['f32']:.3f} ms, both "
        f"{ms['both']:.3f} ms (CUDA events, 5 reps); bound, both streams, "
        f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}: "
        f"{ops / 1e12:.3f} TFLOP of padded bf16 products); the torch WOLA + matmul_rfft + detect it "
        f"replaces, both streams, {ms_torch:.2f} ms; plain version "
        f"{plain_ms:.0f} ms a stream (wall), the kernel within "
        f"{err:.2e} of its mean power; shared memory by loader "
        f"{geo}; ptxas {regs}")
    return {"name": "wola_dft_detect_power", "source": "wola_tc.cu",
            "replaces": "none (vlite_fast_tpu/ops/channelize.py "
            "polyphase_channelize is XLA)", "ms": ms["u8"],
            "ms_both": ms["both"], "plain_ms": plain_ms,
            "library_ms": None, "torch_path_ms_both": ms_torch,
            "max_rel_err_of_mean": err, **bound}


def phase_fourier(dev, blocks) -> None:
    """[17b] the 'fourier' engine on [17a]'s gulps (the pfb observation's
    packed rows: its first gulp, and one over the FRB armed at
    PFB_FRB_S) and on [3]'s production gulp, against the fold kernel."""
    from vlite_fast_tpu_torch import PipelineConfig, SearchConfig
    from vlite_fast_tpu_torch.models import search
    from vlite_fast_tpu_torch.ops import dedisperse_pallas as ddp
    from vlite_fast_tpu_torch.ops import quantize as q
    cfg, scfg = PipelineConfig(), SearchConfig()
    kw = dict(nsub=min(128, cfg.nchanout), nbatch=min(scfg.ndm, 128),
              device=dev)
    fold = search.SinglePulseSearch(scfg, cfg.tsamp, cfg.freqs_mhz(), **kw)
    four = search.SinglePulseSearch(
        dataclasses.replace(scfg, engine="fourier"), cfg.tsamp,
        cfg.freqs_mhz(), **kw)
    plan, nchan = fold.plan, cfg.nchanout
    full = scfg.gulp_samps + fold.overlap
    ntime_out = full - plan.max_delay
    rows = np.concatenate(blocks)
    per_sec = cfg.seg_per_sec * cfg.out_samps_per_seg
    rel = []

    def dmt_err(src, nbit):
        want = ddp.dedisperse_pallas_packed(src, nbit, nchan, plan,
                                            ntime_out) if nbit else \
            ddp.dedisperse_pallas(src, plan, ntime_out)
        got = search.dedisperse(src, plan, ntime_out, engine="fourier",
                                nbit=nbit, nchan=nchan)
        return float((got - want).abs().max() / want.pow(2).mean().sqrt())

    gulp_readings = []
    # the observation's first gulp, and one from a second before the FRB
    # armed at PFB_FRB_S to the end (searched over the rows the stream
    # has, as the flush gulp is; the window is padded for the timings)
    for start in (0, (PFB_FRB_S - 1) * per_sec):
        nrows = min(full, rows.shape[0] - start)
        win = np.full((full, rows.shape[1]), q.NEAR_ZERO_FILL[cfg.nbit],
                      np.uint8)
        win[:nrows] = rows[start:start + nrows]
        win = torch.from_numpy(win).to(dev)
        found = [eng.search_gulp_device(win[:nrows], cfg.nbit, start)
                 for eng in (fold, four)]
        rel.append(dmt_err(win, cfg.nbit))
        near = [max((c for c in cs if abs(c.dm - cfg.inject_dm)
                     <= 0.1 * cfg.inject_dm and PFB_FRB_S <= c.peak_time
                     <= PFB_FRB_S + 1.5),
                    key=lambda c: c.snr, default=None) for cs in found]
        gulp_readings.append((start, [len(cs) for cs in found], near))
    (_, _, (bf, bq)) = gulp_readings[1]
    check(bf is not None and bq is not None and abs(bf.dmi - bq.dmi) <= 1
          and abs(bq.snr - bf.snr) <= 0.02 * bf.snr,
          f"[17b] the FRB: fold {bf}, fourier {bq}")
    torch.cuda.reset_peak_memory_stats(dev)
    k = scfg.topk or min(16 * scfg.max_candidates, 20000)
    gulp = lambda engine: search._device_gulp(
        win, plan, widths=fold.widths, k=k, nbit=cfg.nbit, nchan=nchan,
        nbands=fold.nbands, thresh=float(scfg.snr_thresh), engine=engine)
    ms_four = cuda_ms(lambda: gulp("fourier"), 1)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    ms_fold = cuda_ms(lambda: gulp("auto"), 3)
    rng = np.random.default_rng(11)                        # [3]'s gulp
    fb = torch.from_numpy(rng.standard_normal(
        (full, nchan)).astype(np.float32)).to(dev)
    rel3 = dmt_err(fb, 0)
    check(max(rel + [rel3]) < 1e-2, f"[17b] the Fourier DM-time planes off "
          f"the fold kernel's by {rel} (pfb gulps), {rel3} ([3]'s gulp) of "
          f"their rms")
    log(f"[17b] 'fourier' engine vs the fold kernel ({len(plan.dms)} "
        f"tol-grid trials, {full} rows): the FRB at DM {bq.dm:.2f} trial "
        f"{bq.dmi} S/N {bq.snr:.2f} against DM {bf.dm:.2f} trial {bf.dmi} "
        f"S/N {bf.snr:.2f} (bar: trial +-1, S/N within 2%); candidates "
        f"(fold, fourier) per gulp: " + ", ".join(
            f"from {s / per_sec:.0f} s: {n}" for s, n, _ in gulp_readings)
        + f"; DM-time max |diff| / fold rms: pfb gulps "
        f"{', '.join(f'{r:.2e}' for r in rel)}, [3]'s f32 gulp {rel3:.2e}; "
        f"gulp device {ms_four:.1f} ms fourier (CUDA events, 1 rep), "
        f"{ms_fold:.2f} ms fold (3 reps); peak device memory {peak:.2f} GiB "
        f"(batch_chunk 8)")


def phase_matrix(dev, raw) -> dict:
    """[17c] the config matrix (config.CONFIG_MATRIX) at the reference
    geometry, one second each from a fresh state, through the port's
    program (the armed one where the variant injects, else the twin the
    pipeline resolves) against process_second_plain.  Returns the
    launches of the port's programs."""
    from vlite_fast_tpu_torch.config import CONFIG_MATRIX, PipelineConfig
    from vlite_fast_tpu_torch.models import baseband_dsp as dsp
    launched, lines = {}, []
    t0 = time.perf_counter()
    for name, kw in CONFIG_MATRIX:
        cfg = PipelineConfig(**kw)
        arm = cfg.inject_frb
        _, prog, pcfg = dsp.second_program(cfg, 0 if arm else -1)
        fresh = lambda: dsp.init_state(cfg, dev)
        prog(pcfg, raw, fresh(), arm)                # first use, not timed
        before = kernel_launches.counts()
        (got, st_g), ms = timed_wall(lambda: prog(pcfg, raw, fresh(), arm))
        n = kernel_launches.since(before)
        _add(launched, n)
        want, st_w = dsp.process_second_plain(cfg, raw, fresh(), arm)
        r = compare_seconds(cfg, got, st_g, want, st_w, f"[17c] {name}")
        ran = [k for k, v in n.items() if v]
        check(ran, f"[17c] {name}: no kernel launched")
        lines.append(f"{name}: {pcfg.chain_impl} ({', '.join(ran)}) "
                     f"{ms:.1f} ms, agreement {r['agree']:.6f}")
        del got, want, st_g, st_w
    log(f"[17c] config matrix, {len(CONFIG_MATRIX)} variants at the "
        f"reference geometry, one second of [2]'s input each, the port's "
        f"program (wall) vs process_second_plain at the chain bar: "
        + "; ".join(lines) + f" ({time.perf_counter() - t0:.1f} s)")
    return launched


def phase_options(dev, raw) -> dict:
    """[17]: returns the kernel launches of [17a]'s observation and
    [17c]'s programs, summed."""
    t0 = time.perf_counter()
    launched, blocks = phase_pfb(dev)
    torch.cuda.empty_cache()
    phase_wola(dev)
    torch.cuda.empty_cache()
    phase_fourier(dev, blocks)
    torch.cuda.empty_cache()
    _add(launched, phase_matrix(dev, raw))
    torch.cuda.empty_cache()
    log(f"[17] options passed in {time.perf_counter() - t0:.1f} s; "
        f"launches {launched}")
    return launched


MESH_SECONDS = 20         # [18a]: a call, validate_fullgeom_mesh.py's
# [18b]: 2 s of two-pol voltages at 128 MS/s, a 64 MHz band, DM 30
COH = {"seconds": 2, "rate": 128_000_000, "dm": 30.0, "bw": 64.0}
FOLLOWUP_RATE = 128_000_000   # [18c]: 1-s dumps of FOLLOWUP_ANTS stations
FOLLOWUP_ANTS = 4
FOLLOWUP_SLICE = 8_000_000    # [18c]: samples held against the CPU


def phase_mesh_step(dev, mesh) -> dict:
    """[18a] the sharded array step at the production geometry
    (benchmarks/fullgeom_mesh: PipelineConfig(inject_frb=True), the linear
    1024-trial grid, 20-s calls, the FRB armed at second 2) on `mesh`, two
    calls with the state carried, the first continuing an observation
    (fullgeom_mesh.initial_state): the FRB in every beam and in the coadd
    on both calls, the coadd above every beam, antenna 0's rows of call 1
    equal to process_second second by second, the dedispersion kernel
    against its plain version on call 0's beam and coadd spans
    (mesh_dedisp_check), and the launches of each call.  Before call 0,
    the first call as the JAX script starts it and from the warm-up's
    bandpasses, both with no history (mesh_jax_start).  Returns the
    launches of both calls."""
    from vlite_fast_tpu_torch.benchmarks import fullgeom_mesh as fg
    from vlite_fast_tpu_torch.models import baseband_dsp as dsp
    from vlite_fast_tpu_torch.parallel import sharded_pipeline as sp
    from vlite_fast_tpu_torch.utils import spans
    check(mesh.size == 1, "[18a] needs a 1x1 mesh")
    torch.cuda.empty_cache()
    cfg = fg.array_config(8, mesh).pipeline
    rate = cfg.sample_rate
    nant, free, raw8 = fg.choose_nant(mesh, cfg, MESH_SECONDS)
    log(f"[18a] {nant} antennas (the card has {free / 2 ** 30:.1f} GiB "
        f"free; 8 antennas' raw is {raw8 / 2 ** 30:.1f} GiB)")
    acfg = fg.array_config(nant, mesh)
    scfg = acfg.search
    (step_fn, _, plan, info), build_ms = timed_wall(
        lambda: sp.build_array_step(acfg, mesh, nsec_per_call=MESH_SECONDS,
                                    inject_sec=fg.INJECT_SEC))
    raw = torch.empty((info.m, cfg.npol_in, MESH_SECONDS * rate),
                      dtype=torch.uint8, device=dev)
    # the first call continues an observation: the seconds before it
    # through process_second (their launches are set-up, not counted)
    state, prime_ms = timed_wall(
        lambda: fg.initial_state(mesh, cfg, info, seed=0))
    bp0 = (state[0][0].clone(), state[1][0].clone())
    rows = info.T // MESH_SECONDS
    ant_secs = nant * MESH_SECONDS
    launched = {}
    for k in range(2):
        _, noise_ms = timed_wall(lambda: fg.fill_noise(raw, mesh, cfg, k, 0))
        if k == 0:
            cold = mesh_jax_start(step_fn, raw, mesh, cfg, info, scfg,
                                  (state[0].clone(), state[1].clone()))
        torch.cuda.reset_peak_memory_stats(dev)
        rec = spans.Record("call", k, on_card=True)
        tail_in = state[2]
        kernel_launches.zero()
        (out, state), wall_ms = timed_wall(
            lambda: step_fn(raw, *state, record=rec))
        got = kernel_launches.counts()
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        _add(launched, got)
        parts = fg.part_ms(rec)
        full = sp.gather_step_output(out, mesh)
        per_beam, coadd, stats = sp.extract_candidates(
            full, info, scfg, call_base=k * info.T)
        verdict = fg.judge(per_beam, coadd, info, cfg.inject_dm)
        for beam, b in verdict["beams"].items():
            check(b["recovered"], f"[18a] call {k}: beam {beam} lost the "
                  f"FRB ({b})")
        check(verdict["coadd"]["recovered"],
              f"[18a] call {k}: coadd lost the FRB ({verdict['coadd']})")
        check(verdict["pass"], f"[18a] call {k}: coadd S/N "
              f"{verdict['coadd']['snr']} not above every beam's")
        # the seconds the track reaches run the armed program; the others
        # are handed to the twin's chain kernel
        track = nant * sum(dsp.second_program(
            cfg, (s - fg.INJECT_SEC) * cfg.seg_per_sec)[0] == "armed"
            for s in range(fg.INJECT_SEC, MESH_SECONDS))
        want = {"rfi_front": track, "normalize_ema_pallas": track,
                "normalize_ema_weighted_pallas": track,
                "chain_second_v2": ant_secs - track,
                "dedisperse_pallas": info.nant + 1,
                "dedisperse_pallas_packed": 0,
                **dict.fromkeys(SEARCH_KERNELS, info.nant + 1)}
        for name, n in want.items():
            check(got[name] == n, f"[18a] call {k}: {name} launched "
                  f"{got[name]} times, not {n}")
        others = {n: v for n, v in got.items() if v and n not in want}
        check(not others, f"[18a] call {k}: other kernels launched "
              f"{others}")
        snrs = [b["snr"] for b in verdict["beams"].values()]
        collect = parts["reshard"] + parts["coadd_allreduce"]
        log(f"[18a] call {k}: wall {wall_ms:.1f} ms "
            f"({ant_secs / wall_ms * 1e3:.3f} antenna-seconds a second); "
            f"device ms: DSP {parts['dsp']:.1f}, per-beam search "
            f"{parts['beam_search']:.1f}, coadd search "
            f"{parts['coadd_search']:.1f}, collectives {collect:.1f} "
            f"(reshard and halos {parts['reshard']:.1f}, coadd all_reduce "
            f"{parts['coadd_allreduce']:.1f}); peak {peak:.2f} GiB; FRB "
            f"S/N beams {min(snrs):.2f}-{max(snrs):.2f}, coadd "
            f"{verdict['coadd']['snr']:.2f} at DM "
            f"{verdict['coadd']['dm']:.2f} (gain "
            f"{verdict['coadd']['gain_vs_best_beam']:.2f}); "
            f"{stats['n_crossings']} crossings; noise made in "
            f"{noise_ms:.1f} ms")
        if k == 0:
            warm_n = max(stats["n_crossings"], 1)
            log(f"[18a] call 0's crossings: {stats['n_crossings']} from the "
                f"warm-up's bandpasses and tail; with no history "
                + ", ".join(f"{n} from {start} ({n / warm_n:.2f}x)"
                            for start, n in cold.items()))
            mesh_dedisp_check(tail_in, out.packed_kur, plan, info, cfg)
            st = dsp.init_state(cfg, dev)._replace(bp=bp0[0], bp_kur=bp0[1])
            for s in range(MESH_SECONDS):
                o, st = dsp.process_second(
                    cfg, raw[0, :, s * rate:(s + 1) * rate].contiguous(), st,
                    s == fg.INJECT_SEC)
                check(np.array_equal(o.packed_kur.cpu().numpy(),
                                     full.packed_kur[0][s * rows:
                                                        (s + 1) * rows]),
                      f"[18a] antenna 0 second {s}: rows differ from "
                      "process_second")
            log(f"[18a] call 0: antenna 0's {MESH_SECONDS} seconds equal "
                "process_second's, byte for byte")
        del out, full, tail_in
    log(f"[18a] {nant} antennas x 2 calls of {MESH_SECONDS} s on a "
        f"{mesh.shape['ant']}x{mesh.shape['time']} mesh, NCCL; "
        f"build {build_ms:.1f} ms; the seconds before the first call "
        f"{prime_ms:.1f} ms; launches {launched}")
    del raw, state
    torch.cuda.empty_cache()
    return launched


def saturated_bands(full, info, scfg) -> list:
    """(shard, DM band, first and last second of its top-k's crossings)
    of every saturated DM band of a one-rank step's output: a band whose
    every top-k slot is above the threshold (search.decode_crossings)."""
    from vlite_fast_tpu_torch.models import search
    out = []
    shards = [(f"beam {j}", full.beam_topk[0, j], info.c)
              for j in range(info.mg)]
    shards.append(("coadd", full.coadd_topk[0], info.ca))
    nbands = search.effective_nbands(len(info.dms), info.nbands)
    for name, packed, ntime in shards:
        vals = packed[0, :-1].view(np.float32).reshape(nbands, -1)
        idx = packed[1, :-1].astype(np.int64).reshape(nbands, -1)
        for band in np.flatnonzero(vals.min(axis=1) > scfg.snr_thresh):
            t = (idx[band] % ntime - info.halo) * info.tsamp
            out.append((name, int(band), float(t.min()), float(t.max())))
    return out


def mesh_jax_start(step_fn, raw, mesh, cfg, info, scfg, warm_bp) -> dict:
    """[18a]'s first call as the JAX script starts it, not counted: zero
    bandpasses and the step's make_inputs history, which in the port is
    none (tail None: the search starts at the stream's first row, and
    the zero bandpasses are seeded from each antenna's first second,
    baseband_dsp.seed_bandpass; the JAX step's make_inputs draws `halo`
    rows of random bytes there).  Then the same call from the warm-up's
    bandpasses (`warm_bp`, which the seed passes through) and no history.
    Checked: the FRB in every beam and in the coadd from both starts; no
    DM band's top-k saturated from either; the crossings from zero
    bandpasses within 1.5x of the warm ones' (the start-up transient of
    a tile seed, ROADMAP Queue 3 #2, gave 6.81x and 4 saturated bands on
    an H100).
    Returns each start's crossings."""
    from vlite_fast_tpu_torch.benchmarks import fullgeom_mesh as fg
    from vlite_fast_tpu_torch.parallel import sharded_pipeline as sp
    zero = torch.zeros((info.m, cfg.npol_in, cfg.nchan), device=mesh.device)
    crossings = {}
    for start, (bp, bp_kur) in (("zero bandpasses", (zero, zero.clone())),
                                ("warm bandpasses", warm_bp)):
        out, wall_ms = timed_wall(lambda: step_fn(raw, bp, bp_kur)[0])
        full = sp.gather_step_output(out, mesh)
        del out
        per_beam, coadd, stats = sp.extract_candidates(full, info, scfg)
        verdict = fg.judge(per_beam, coadd, info, cfg.inject_dm)
        kept = [b for b, v in verdict["beams"].items() if v["recovered"]]
        snrs = [v["snr"] for v in verdict["beams"].values()
                if v["recovered"]]
        sat = saturated_bands(full, info, scfg)
        log(f"[18a] the first call from {start} and no history: "
            f"{wall_ms:.1f} ms; "
            f"{stats['n_crossings']} crossings, {stats['saturated_bands']} "
            f"saturated DM bands {sat}; the FRB kept in {len(kept)} of "
            f"{info.nant} beams (S/N {min(snrs, default=0):.2f}-"
            f"{max(snrs, default=0):.2f}); coadd {verdict['coadd']}")
        check(len(kept) == info.nant and verdict["coadd"]["recovered"],
              f"[18a] the first call from {start} and no history lost the "
              f"FRB: {verdict}")
        check(len(sat) == stats["saturated_bands"],
              f"[18a] saturated bands {sat} vs {stats}")
        check(not sat, f"[18a] the first call from {start} and no history "
              f"saturated DM bands: {sat}")
        crossings[start] = stats["n_crossings"]
    ratio = crossings["zero bandpasses"] / max(
        crossings["warm bandpasses"], 1)
    check(1 / 1.5 <= ratio <= 1.5, f"[18a] the first call's crossings from "
          f"zero bandpasses {ratio:.2f}x the warm ones' ({crossings})")
    return crossings


def mesh_dedisp_check(tail, packed, plan, info, cfg) -> None:
    """[18a]'s dedispersion at the step's own inputs, outside the counted
    window: on a 1x1 mesh a beam's span is its input tail, then its rows
    of the call, and the coadd's window is the sum of every beam's span
    times the step's 1/sqrt(nant).  The f32 entry against dd.dedisperse
    on beam 0's span at ntime_out c and on the coadd's window at ca, at
    [3]'s bar (allclose rtol 1e-5, atol 1e-3)."""
    from vlite_fast_tpu_torch.ops import dedisperse as dd
    from vlite_fast_tpu_torch.ops import dedisperse_pallas as ddp
    from vlite_fast_tpu_torch.parallel import sharded_pipeline as sp
    co = None
    for j in range(info.mg):
        fb = sp.dequant_rows(torch.cat([tail[j], packed[j]]), cfg)
        if j == 0:
            beam0 = fb.clone()
        co = fb if co is None else co.add_(fb)
    co.mul_(float(np.float32(1.0 / np.sqrt(info.nant))))
    errs, ms = {}, {}
    for name, fb, n in (("beam 0", beam0, info.c),
                        ("coadd", co[:info.ca + info.halo], info.ca)):
        got = ddp.dedisperse_pallas(fb, plan, n)
        want, ms[name] = timed_wall(lambda: dd.dedisperse(fb, plan, n))
        errs[name] = float((got - want).abs().max())
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-3),
              f"[18a] dedispersion kernel (f32 entry) on the {name}'s "
              f"{tuple(fb.shape)} span differs from plain: max abs "
              f"{errs[name]}")
        del got, want
    log(f"[18a] dedispersion kernel (f32 entry) vs plain at the step's "
        f"shapes ({len(plan.dms)} trials, nsub {plan.nsub}): beam 0 "
        f"({info.c + info.halo} x {cfg.nchanout} -> {info.c}) max abs "
        f"{errs['beam 0']:.3e}, coadd ({info.ca + info.halo} -> {info.ca}) "
        f"{errs['coadd']:.3e} (allclose rtol 1e-5 atol 1e-3); plain "
        f"{ms['beam 0']:.1f} / {ms['coadd']:.1f} ms (wall)")
    del beam0, co
    torch.cuda.empty_cache()


def phase_coherent_sharded(dev, mesh) -> None:
    """[18b] coherent_dedisperse_sharded on `mesh` at 128 MS/s, a 64 MHz
    band, DM 30: 2 s of two-pol voltages dispersed by one chirp over the
    whole stream, against the unsharded ops/coherent path over the same
    zero-padded stream (1e-4 of its rms) and the JAX test's round-trip bar
    away from the stream's ends."""
    import torch.nn.functional as F
    from vlite_fast_tpu_torch.ops import coherent as coh
    from vlite_fast_tpu_torch.parallel.sharded_coherent import (
        coherent_dedisperse_sharded, sharded_halo)
    rate, dm, bw, fbot = COH["rate"], COH["dm"], COH["bw"], 320.0
    n = COH["seconds"] * rate
    gen = torch.Generator(device=dev).manual_seed(18)
    x = torch.randn((2, n), generator=gen, device=dev)
    halo = sharded_halo(dm, rate, bw, fbot)
    ker, ker_ms = timed_wall(lambda: coh.dispersion_kernel(
        n, dm, bw, fbot, taper=False, device=dev))
    dispersed = coh.apply_chirp(x, ker)
    del ker
    # the block's kernel (numpy phases, cached) before the timed call
    _, ext_ms = timed_wall(lambda: coh.dispersion_kernel(
        n + 2 * halo, dm, bw, fbot, taper=False, device=dev))
    out, ms = timed_wall(lambda: coherent_dedisperse_sharded(
        dispersed, mesh, dm, rate, bw, fbot))
    ref, ref_ms = timed_wall(lambda: coh.coherent_dedisperse(
        F.pad(dispersed, (halo, halo)), dm, rate, bw, fbot)[:, halo:halo + n])
    rms = float(ref.square().mean().sqrt())
    diff = float((out - ref).abs().max())
    check(diff <= 1e-4 * rms, f"[18b] sharded vs unsharded: {diff} > 1e-4 "
          f"of the rms {rms}")
    del ref, dispersed
    err = (out[:, 2 * halo:n - 2 * halo] - x[:, 2 * halo:n - 2 * halo]).abs()
    e_max, e_frac = float(err.max()), float((err > 0.01).float().mean())
    e_med = float(np.median(err.cpu().numpy()))
    check(e_max < 0.1 and e_med < 2e-3 and e_frac < 0.01,
          f"[18b] round trip: max {e_max}, median {e_med}, share > 0.01 "
          f"{e_frac}")
    log(f"[18b] coherent_dedisperse_sharded, DM {dm}, {COH['seconds']} s at "
        f"{rate / 1e6:g} MS/s: halo {halo} samples, block {n + 2 * halo} "
        f"samples a pol; "
        f"{ms:.1f} ms (the unsharded path {ref_ms:.1f} ms; the numpy chirp "
        f"phases {ker_ms:.1f} ms for the dispersing kernel, {ext_ms:.1f} "
        f"ms for the block's); max |sharded - unsharded| {diff:.3g} "
        f"(rms {rms:.4f}); round trip max {e_max:.4g}, median {e_med:.3g}, "
        f"share > 0.01 {e_frac:.3g}")
    del out, x, err
    coh._dm_kernel_np.cache_clear()
    torch.cuda.empty_cache()


def followup_dumps(dev, d: str, positions: np.ndarray, az: float,
                   el: float) -> dict:
    """FOLLOWUP_ANTS stations' 1-s dumps at FOLLOWUP_RATE in `d` (the
    tests/test_dataset.py recipe, made on the card from a torch seed): a
    common broadband pulse train from (az, el) with each station's
    geometric delay, noise of its own, ragged start frames, and station
    3's dump in two fragment files.  Returns each file's stations."""
    import os
    from vlite_fast_tpu_torch.analysis import localization as loc
    from vlite_fast_tpu_torch.utils import vdif
    rate = FOLLOWUP_RATE
    n, margin, extra = rate, 4000, 16 * 5000
    total = n + 2 * margin + extra
    gen = torch.Generator(device=dev).manual_seed(31)
    common = 0.3 * torch.randn(total, generator=gen, device=dev,
                               dtype=torch.float64)
    hits = torch.randint(margin, n, (60,), generator=gen, device=dev)
    common[hits] += 20.0
    spec = torch.fft.rfft(common)
    f = torch.fft.rfftfreq(total, device=dev, dtype=torch.float64)
    tau = positions @ loc.direction_unit(np.array(az), np.array(el)) \
        / loc.C_LIGHT
    files = {}
    for k in range(FOLLOWUP_ANTS):
        sig = torch.fft.irfft(spec * torch.exp(
            -2j * np.pi * f * (-tau[k] * rate)), n=total)[
            margin:margin + n + extra]
        x = torch.stack([sig, sig]) + 0.5 * torch.randn(
            (2, sig.numel()), generator=gen, device=dev, dtype=torch.float64)
        u = (x * 12.8 + 128.5).clamp(0, 255).to(torch.uint8)
        off = 3 * k + 1                            # ragged start frames
        cut = u[:, off * 5000:off * 5000 + n].cpu().numpy()
        parts = [(f"ant{k}.vdif", cut, off)]
        if k == 2:                                 # one station in two files
            h = n // 2 // 5000 * 5000
            parts = [("c1.vdif", cut[:, :h], off),
                     ("c2.vdif", cut[:, h:], off + h // 5000)]
        for name, samples, frame0 in parts:
            vdif.streams_to_frames(samples, ref_epoch=40, start_second=9,
                                   start_frame=frame0, station_id=k + 1,
                                   sample_rate=rate).tofile(
                os.path.join(d, name))
            files[name] = k + 1
    return files


def _cli(args: list) -> str:
    """The port's CLI in this process: its standard output."""
    import contextlib
    import io
    from vlite_fast_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(args)
    return buf.getvalue()


def phase_followup(dev) -> None:
    """[18c] the offline follow-up of a trigger at FOLLOWUP_RATE: the
    stations' dumps (followup_dumps), `cli join-dumps` of the split station's
    fragments, `cli unwrap` of a dump whose frames were rotated as a
    ring's wrap leaves them (repaired byte for byte), `cli localize
    --positions` (the direction within 0.1 rad), filterbank,
    correlation_matrix and beamform_toward on the card against the same
    calls with device='cpu' on the dumps' first FOLLOWUP_SLICE samples,
    and `cli waterfall` of a .fil of one dump's filterbank.  Each step
    timed."""
    import json
    import os
    from vlite_fast_tpu_torch import constants as C
    from vlite_fast_tpu_torch.analysis import baseband as bb
    from vlite_fast_tpu_torch.analysis import beamforming as bf
    from vlite_fast_tpu_torch.analysis.dataset import load_dataset
    from vlite_fast_tpu_torch.analysis.waterfall import waterfall_from_fil
    from vlite_fast_tpu_torch.utils import sigproc
    rate = FOLLOWUP_RATE
    positions = np.array([[0.0, 0.0, 0.0], [1200.0, 0.0, 0.0],
                          [0.0, 1200.0, 0.0], [450.0, 850.0, 0.0]])
    az, el = 1.1, 0.7
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        dumps = os.path.join(tmp, "dumps")
        os.makedirs(dumps)
        files, times["dumps"] = timed_wall(
            lambda: followup_dumps(dev, dumps, positions, az, el))
        joined = os.path.join(tmp, "joined.vdif")
        out, times["join-dumps"] = timed_wall(lambda: _cli(
            ["join-dumps", os.path.join(dumps, "c2.vdif"),
             os.path.join(dumps, "c1.vdif"), "-o", joined]))
        rep = json.loads(out)
        check(rep["clean"] and rep["nframes"] == 2 * rate // 5000,
              f"[18c] join-dumps: {rep}")
        # 0.75 s of a dump: a whole second rotated keeps every frame
        # number's successor, which is all the wrap search reads
        frames = np.fromfile(os.path.join(dumps, "ant0.vdif"), np.uint8)\
            .reshape(-1, C.VDIF_FRAME_BYTES)[:2 * (3 * rate // 20_000)]
        wrapped = os.path.join(tmp, "wrapped.vdif")
        np.roll(frames, -2 * 12_345, axis=0).tofile(wrapped)
        out, times["unwrap"] = timed_wall(lambda: _cli(["unwrap", wrapped]))
        rep = json.loads(out)
        check(not rep["clean"] and not rep["corrupted"] and np.array_equal(
            np.fromfile(wrapped + ".uw", np.uint8).reshape(frames.shape),
            frames), f"[18c] unwrap did not repair the wrap: {rep}")
        del frames
        pos = os.path.join(tmp, "pos.json")
        with open(pos, "w") as fh:
            json.dump({str(k + 1): list(p) for k, p in enumerate(positions)},
                      fh)
        out, times["localize"] = timed_wall(lambda: _cli(
            ["--device", str(dev), "localize", dumps, "--positions", pos,
             "--sigma-ns", str(0.7 / rate * 1e9),
             "--sample-rate", str(rate)]))
        fit = json.loads(out.strip().splitlines()[-1])
        check(abs(fit["az_rad"] - az) < 0.1 and abs(fit["el_rad"] - el)
              < 0.1, f"[18c] localize: {fit}, not ({az}, {el})")
        # the common window, cut to whole 12500-sample spectra
        aligned = load_dataset(dumps, sample_rate=rate).aligned()
        keep = aligned[0].nsamp // C.NFFT * C.NFFT
        aligned = [bb.VoltageDump(a.samples[:, :keep], a.start_time,
                                  a.station_id, rate) for a in aligned]
        p, times["filterbank"] = timed_wall(
            lambda: bb.filterbank(aligned[0], device=dev))
        _, times["correlation_matrix"] = timed_wall(
            lambda: bb.correlation_matrix(aligned, device=dev))
        _, times["beamform_toward"] = timed_wall(
            lambda: bf.beamform_toward(aligned, positions, az, el,
                                       device=dev))
        part = [bb.VoltageDump(a.samples[:, :FOLLOWUP_SLICE], a.start_time,
                               a.station_id, rate) for a in aligned]
        worst = {}
        for name, fn in (
                ("filterbank", lambda d: bb.filterbank(part[0], device=d)),
                ("correlation_matrix",
                 lambda d: bb.correlation_matrix(part, device=d))):
            got, want = fn(dev), fn("cpu")
            worst[name] = float(np.abs(got - want).max()
                                / np.abs(want).max())
            check(worst[name] <= 1e-4, f"[18c] {name}: card vs CPU "
                  f"{worst[name]} of the maximum")
        got = bf.beamform_toward(part, positions, az, el, device=dev).samples
        want = bf.beamform_toward(part, positions, az, el,
                                  device="cpu").samples
        dd = np.abs(got.astype(np.int16) - want.astype(np.int16))
        check(dd.max() <= 1 and (dd == 0).mean() >= 0.9999,
              f"[18c] beamform_toward: card vs CPU {dd.max()} counts, "
              f"{(dd == 0).mean()} equal")
        fil = os.path.join(tmp, "dump0.fil")
        lev = np.clip(p / np.median(p) * 64.0, 0, 255).astype(np.uint8)
        with sigproc.FilterbankWriter(fil, sigproc.FilterbankHeader(
                nchans=p.shape[1], nbits=8, tsamp=C.NFFT / rate,
                fch1=C.FREQ_BOT_MHZ + C.BANDWIDTH_MHZ,
                foff=-C.BANDWIDTH_MHZ / (p.shape[1] - 1),
                source_name="DUMP0")) as w:
            w.write_block(lev)
        out, times["waterfall"] = timed_wall(lambda: _cli(["waterfall", fil]))
        png = out.strip()
        with open(png, "rb") as fh:
            w_px, h_px = np.frombuffer(fh.read(24)[16:24], ">u4")
        want_px = waterfall_from_fil(fil)[0].shape
        check((w_px, h_px) == want_px, f"[18c] waterfall PNG {w_px}x{h_px}, "
              f"not {want_px}")
    log(f"[18c] {FOLLOWUP_ANTS} stations' 1-s dumps at {rate / 1e6:g} MS/s "
        f"({files}): "
        f"localize az {fit['az_rad']} el {fit['el_rad']} (true {az}, "
        f"{el}); card vs CPU on {FOLLOWUP_SLICE} samples: filterbank "
        f"{worst['filterbank']:.3g}, correlation_matrix "
        f"{worst['correlation_matrix']:.3g} of the maximum, beamform_toward "
        f"{(dd == 0).mean():.6f} equal; waterfall PNG {w_px}x{h_px}; ms: "
        + ", ".join(f"{k} {v:.1f}" for k, v in times.items()))


def phase_mesh(dev) -> dict:
    """[18] the array on a mesh and the offline follow-up: [18a] and
    [18b] on a 1x1 mesh of a one-rank NCCL process group, then [18c].
    Returns [18a]'s launches."""
    import torch.distributed as dist
    from vlite_fast_tpu_torch.parallel.distributed import init_distributed
    from vlite_fast_tpu_torch.parallel.mesh import make_mesh
    t0 = time.perf_counter()
    init_distributed(device="cuda")
    try:
        check(dist.get_backend() == "nccl", "[18] not an NCCL group")
        mesh = make_mesh(n_ant=1, n_time=1)
        launched = phase_mesh_step(dev, mesh)
        t1 = time.perf_counter()
        phase_coherent_sharded(dev, mesh)
        t2 = time.perf_counter()
    finally:
        dist.destroy_process_group()
    phase_followup(dev)
    torch.cuda.empty_cache()
    log(f"[18] mesh and follow-up passed in {time.perf_counter() - t0:.1f} s "
        f"([18a] {t1 - t0:.1f}, [18b] {t2 - t1:.1f}, [18c] "
        f"{time.perf_counter() - t2:.1f})")
    return launched


# the keys [19] requires of the bench's line
BENCH_KEYS = (
    "value", "value_tolgrid", "tolgrid_trials", "dsp_only_rt_factor",
    "dsp_only_rt_factor_gated", "dsp_only_rt_factor_blended",
    "twin_agreement", "twin_byte_parity", "twin_chain_impl", "gulp_lin_s",
    "gulp_tol_s", "gulps_searched", "wall_s", "candidates", "best_snr",
    "frb_dm", "frb_snr", "frb_recovered", "cand_latency_wall_s",
    "cand_latency_data_s", "search_engine", "dsp_f32_tflops",
    "dsp_f32_util_pct", "dsp_hbm_gbps_min", "dsp_hbm_util_pct_min",
    "dedisp_gulp_s", "dedisp_hbm_gbps", "dedisp_hbm_util_pct",
    "dedisp_gadds_per_s", "dedisp_sol_hbm_s", "device", "launches",
    "start_lowdm_candidates")


def phase_bench() -> dict:
    """[19] `python -m vlite_fast_tpu_torch.cli bench` in a process of its
    own: its one stdout line checked (BENCH_KEYS, the FRB, the twin's
    agreement, every share in (0, 100], the tol grid no faster than the
    linear one, the main path's kernels in its loops).  Returns the
    launches of its integrated loops."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "vlite_fast_tpu_torch.cli", "bench"],
        capture_output=True, text=True, env=_env(), timeout=600)
    took = time.perf_counter() - t0
    for line in res.stderr.splitlines():
        if line.startswith("bench:"):
            log(f"[19] {line}")
    check(res.returncode == 0, f"[19] cli bench exited {res.returncode}:\n"
          f"{res.stderr[-3000:]}")
    lines = res.stdout.strip().splitlines()
    check(len(lines) == 1, f"[19] {len(lines)} lines on the bench's stdout")
    got = json.loads(lines[0])
    missing = [k for k in BENCH_KEYS if k not in got]
    check(not missing, f"[19] the bench's line lacks {missing}")
    check(got["frb_recovered"] is True, f"[19] FRB not recovered: DM "
          f"{got['frb_dm']}, S/N {got['frb_snr']}")
    check(got["twin_agreement"] >= 0.9999,
          f"[19] twin agreement {got['twin_agreement']}")
    check(got["start_lowdm_candidates"] == 0,
          f"[19] {got['start_lowdm_candidates']} candidates below DM "
          f"{bench.START_MAX_DM:g} in an observation's first "
          f"{bench.START_S:g} s")
    from vlite_fast_tpu_torch import PipelineConfig
    inject_dm = PipelineConfig().inject_dm
    check(abs(got["frb_dm"] - inject_dm) < FRB_DM_TOL
          and FRB_SNR[0] <= got["frb_snr"] <= FRB_SNR[1],
          f"[19] the FRB at DM {got['frb_dm']} S/N {got['frb_snr']}, not "
          f"within {FRB_DM_TOL} of DM {inject_dm:g} at S/N {FRB_SNR}")
    shares = {k: v for k, v in got.items() if "_util_pct" in k}
    check(len(shares) == 3 and all(
        isinstance(v, (int, float)) and 0 < v <= 100
        for v in shares.values()), f"[19] shares {shares}")
    check(got["value_tolgrid"] <= 1.02 * got["value"],
          f"[19] value_tolgrid {got['value_tolgrid']} > 1.02 x value "
          f"{got['value']}")
    launched = got["launches"]
    check(all(launched.get(k, 0) > 0 for k in
              ("chain_second_v2", "dedisperse_pallas_packed", *ARMED_KERNELS)),
          f"[19] launches {launched}")
    log(f"[19] {lines[0]}")
    log(f"[19] cli bench passed in {took:.1f} s (the process, its start-up "
        f"and builds' loading included): value {got['value']:.3f}, "
        f"value_tolgrid {got['value_tolgrid']:.3f}, FRB S/N "
        f"{got['frb_snr']:.2f} at DM {got['frb_dm']:.2f}, "
        f"{got['start_lowdm_candidates']} candidates below DM "
        f"{bench.START_MAX_DM:g} in the first {bench.START_S:g} s; launches "
        f"{launched}")
    return launched


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
    launches, _ = phase_main_path(dev, twin_device_ms=k_chain["ms"],
                                  write_fil=True)
    torch.cuda.empty_cache()
    k_bt = phase_gulp_passes(dev)
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
    for k in (k_chain, k_dedisp, k_rfi, *k_ema, k_pre, *k_ct, k_bt):
        k["launches"] = launches[k["name"]]
    # the staged chain and the roll+select engine count on their own paths
    staged = [phase_stage_a(dev)]
    torch.cuda.empty_cache()
    staged.append(phase_stage_b(dev))
    torch.cuda.empty_cache()
    staged.append(phase_rollsel(dev))
    torch.cuda.empty_cache()
    staged.append(phase_tile_bench(dev))
    torch.cuda.empty_cache()
    # the array path runs the main path's kernels: its launches add to theirs
    got = phase_array(dev)
    for k in (k_chain, k_dedisp, k_rfi, *k_ema, k_bt):
        k["launches"] += got[k["name"]]
    k_dedisp["launches_f32_entry"] = got["dedisperse_pallas"] - \
        got["dedisperse_pallas_packed"]
    torch.cuda.empty_cache()
    # the entry points' processes run the main path's kernels too
    got = phase_entry_points(dev)
    for k in (k_chain, k_dedisp, k_rfi, *k_ema, k_bt):
        k["launches"] += got.get(k["name"], 0)
    torch.cuda.empty_cache()
    # so do the pfb observation and the config matrix
    got = phase_options(dev, raws[0])
    for k in (k_chain, k_dedisp, k_rfi, *k_ema, k_bt):
        k["launches"] += got.get(k["name"], 0)
    torch.cuda.empty_cache()
    # and the sharded array step, whose search takes the f32 entry
    got = phase_mesh(dev)
    for k in (k_dedisp, k_rfi, *k_ema, k_bt):
        k["launches"] += got.get(k["name"], 0)
    k_dedisp["launches_f32_entry"] += got["dedisperse_pallas"] - \
        got["dedisperse_pallas_packed"]
    torch.cuda.empty_cache()
    # and the headline bench's integrated loops, in a process of their own
    got = phase_bench()
    for k in (k_chain, k_dedisp, k_rfi, *k_ema, k_bt):
        k["launches"] += got[k["name"]]
    k_dedisp["launches_f32_entry"] += got["dedisperse_pallas"] - \
        got["dedisperse_pallas_packed"]
    kernels = [k_chain, k_dedisp, k_rfi, *k_ema, k_pre, *k_ct, *staged,
               k_bt]
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
