"""Analytic cost models and the card's peaks: what a bound is.

The port's counterpart of vlite_fast_tpu/utils/perf.py.  It grounds the
bench's real-time factors in hardware numbers (how many operations and
bytes the chain and the dedispersion move a second, against the card's
peaks), and it is the one place that states a kernel's bound, which
chip_smoke.py reads for every kernel it times.

Peaks are those of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at its 700 W power limit): 3.35 TB/s of HBM, 67 TFLOP/s in float32 outside
the tensor cores, 989 TFLOP/s in bf16 on them.  A card set below 700 W
runs slower under load, so a share of these peaks is read beside the
card's power limit.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from vlite_fast_tpu_torch.config import PipelineConfig
    from vlite_fast_tpu_torch.ops.dedisperse import DedispPlan

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "bf16": 989e12}


def bound(moved: float, ops: float, kind: str = "f32") -> dict:
    """The least time the card could take for a function that moves
    `moved` bytes (each input read once, each output written once) and
    does `ops` operations of type `kind` (a multiply-add counts two, an
    add or a compare one): {"bound_ms", "bound_by": "bytes" or
    "operations"}."""
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def tc_dft_ops(cfg: "PipelineConfig", frames: int,
               planes1: int = 4) -> float:
    """The bf16 products the tensor-core DFT (csrc/dft_tc.cuh) issues for
    `frames` frames, padding included: stage 1 `planes1` W1 planes (four
    on exact bf16 frames, six on the WOLA loader's hi + lo frames) of
    (64 nwg) x (32 npass) x (8 kb1), stage 2 twelve of (64 nwg) x 64 x
    (32 npass)."""
    from vlite_fast_tpu_torch.ops import megakernel as mk
    g = mk.tc_geometry(cfg.nfft)
    rows, cols = 64 * g.nwg, 32 * g.npass
    return frames * 2 * (planes1 * rows * cols * 8 * g.kb1
                         + 12 * rows * 64 * cols)


def _frames(cfg: "PipelineConfig") -> int:
    """Frames of nfft samples in one second of every input pol."""
    return cfg.npol_in * (cfg.sample_rate // cfg.nfft)


def dft_flops_per_data_second(cfg: "PipelineConfig") -> dict:
    """The channelizer's products per second of dual-pol baseband.

    nominal_flops: the Cooley-Tukey DFT's products per stream, counted as
    the JAX module counts them (the same number for the same geometry):
    per frame of nfft = n1 x n2 real samples, stage 1 4 n1^2 n2 and stage
    2 8 n1 n2 n2_out with n2_out = n2 // 2 + 1.

    armed_f32_flops: what the armed program (models/baseband_dsp.
    process_second) issues, the f32 torch.matmul GEMMs of
    ops/channelize.matmul_rfft (two products in stage 1, four in stage 2
    over the rfft's nfft // 2 // n1 + 1 columns), for each stream the
    rfi_mode computes (both in rfi_mode 2); 0 with channelizer 'fft'.

    twin_bf16_flops: what the twin's chain kernel issues, the tensor-core
    DFT's padded bf16 products on every frame (tc_dft_ops); the kurtosis
    stream's frames in blocks flagged in part add to it where the data
    has them."""
    from vlite_fast_tpu_torch.ops.channelize import _ct_split
    n1, n2 = _ct_split(cfg.nfft)
    frames = _frames(cfg)
    nominal = (4 * n1 * n1 * n2 + 8 * n1 * n2 * (n2 // 2 + 1)) * frames
    n2o = cfg.nfft // 2 // n1 + 1
    nstreams = 2 if cfg.rfi_mode == 2 else 1
    armed = 0 if cfg.channelizer == "fft" else \
        nstreams * frames * (4 * n1 * n1 * n2 + 8 * n1 * n2 * n2o)
    return {"nominal_flops": nominal, "armed_f32_flops": armed,
            "twin_bf16_flops": tc_dft_ops(cfg, frames)}


def chain_hbm_bytes_per_data_second(cfg: "PipelineConfig") -> int:
    """Lower bound of the armed program's device-memory traffic per
    data-second, as the JAX module counts it: every major intermediate
    written and read once (raw bytes in, f32 voltages, spectra, detected
    powers, the scrunched output's packed bytes out).  The port's torch
    passes write each of these."""
    nsamp = cfg.npol_in * cfg.sample_rate
    nspec = _frames(cfg)
    nchan = cfg.nfft // 2 + 1
    raw = nsamp                                   # uint8 read
    f32 = 2 * 4 * nsamp                           # write + read
    spec = 2 * 8 * nspec * nchan                  # complex64 w+r
    det = 2 * 4 * nspec * nchan                   # detected powers w+r
    out = cfg.seg_per_sec * cfg.out_samps_per_seg * cfg.nchanout \
        * cfg.nbit // 8
    return raw + f32 + spec + det + out


def chain_bytes(cfg: "PipelineConfig") -> int:
    """The bytes a fused chain must move for one second, whatever
    implements it: the raw second in; both streams' packed rows, the
    block weights, the segments' flagged fractions and both streams'
    bandpasses out."""
    rows = cfg.seg_per_sec * cfg.out_samps_per_seg
    row_bytes = cfg.npol_out * cfg.nchanout * cfg.nbit // 8
    nspec = cfg.seg_per_sec * cfg.ffts_per_seg
    return (cfg.npol_in * cfg.sample_rate + 2 * rows * row_bytes
            + 4 * cfg.npol_in * nspec + 4 * cfg.seg_per_sec
            + 4 * 2 * cfg.npol_in * cfg.nchan)


def chain_ops(cfg: "PipelineConfig", masked: int) -> float:
    """The f32 operations the chain needs on one second: a real FFT of
    each frame (2.5 nfft log2 nfft), and ~8 operations per spectrum
    element for detect and EMA in each stream the rfi_mode computes.  In
    rfi_mode 2 the kurtosis stream needs a transform of its own only in
    the `masked` frames, those whose mask zeroed a window (weight < 1)."""
    frames = cfg.npol_in * cfg.seg_per_sec * cfg.ffts_per_seg
    nstreams = 2 if cfg.rfi_mode == 2 else 1
    masked = masked if cfg.rfi_mode == 2 else 0
    return (frames + masked) * 2.5 * cfg.nfft * math.log2(cfg.nfft) \
        + nstreams * frames * 8 * cfg.nchan


def chain_bound(cfg: "PipelineConfig", masked: int) -> dict:
    """The chain's bound on one second with `masked` masked frames."""
    return bound(chain_bytes(cfg), chain_ops(cfg, masked))


def dedisp_fold_cost(plan: "DedispPlan", nchan: int,
                     ntime_out: int) -> dict:
    """Device-memory bytes and adds of one call of the fold kernel
    (csrc/dedisperse.cu through ops/dedisperse_pallas.dedisperse_pallas,
    the f32 entry), as it does the work, without the TPU kernel's
    128-lane padding: stage 1 reads the f32 filterbank's ntime_out +
    max_delay rows and the tables once and writes the (nbatch, nsub,
    ntime_out + max_sub_delay) intermediate, which stage 2 reads once; it
    writes the (ndm, ntime_out) plane once.  One add per term of each
    stage: nbatch x nchan x (ntime_out + max_sub_delay) in stage 1 and
    ndm x nsub x ntime_out in stage 2."""
    nbatch = plan.rel_delays.shape[0]
    ndm, nsub = plan.sub_delays.shape
    t1_len = ntime_out + plan.max_sub_delay
    fb = 4 * nchan * (ntime_out + plan.max_delay)
    tables = 4 * (nbatch * nchan + ndm * nsub + nchan)
    y = 4 * nbatch * nsub * t1_len
    out = 4 * ndm * ntime_out
    hbm = fb + tables + 2 * y + out
    adds = nbatch * nchan * t1_len + ndm * nsub * ntime_out
    return {"hbm_bytes": hbm, "adds": adds,
            "sol_hbm_s": hbm / HBM_BYTES_PER_S}


def torch_cost(fn, *args) -> dict:
    """The floating-point operations torch's FlopCounterMode counts in one
    call fn(*args) ({"flops": n}); {} where it counts none (a kernel
    launched through ctypes is invisible to it)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    flops = counter.get_total_flops()
    return {"flops": float(flops)} if flops else {}
