"""The fused DSP chain for one second: CUDA kernel + plain version.

Replaces the TPU kernel vlite_fast_tpu/ops/megakernel.py:chain_second_v2
(Pallas body _full_kernel_v2).  The CUDA source is csrc/chain.cu (C entry
vf_chain_second: a front, a Cooley-Tukey DFT and an EMA/back-end launch
on the current stream).  On the card it is bound by the DFT's f32 FMA
work (~0.36 TFLOP per data-second, on CUDA cores) and by the EMA's walk
through 10240 spectra in order; the simple design keeps each frame and
its stage-1 planes in shared memory and gives the recurrence one thread
per (stream, channel).  The source header has the details.

It works in the natural layout: bandpass (2, npol, nchan) [plain; kur]
and packed sel_and_dig rows out.  The TPU kernel's factored (kA, kB)
planes and their helpers (bp_to/from_factored_v2,
unfactor_pack_realign_v2) are TPU layout and have no counterpart here.

Dispatch: a CPU tensor goes to `chain_second_v2_plain` (the port's
baseband_dsp.process_second_plain with injection off); a CUDA tensor
launches the kernel or raises.  LAUNCHES counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from vlite_fast_tpu import constants as C
from vlite_fast_tpu.config import PipelineConfig
from vlite_fast_tpu_torch import _build
from vlite_fast_tpu_torch.models import baseband_dsp as dsp
from vlite_fast_tpu_torch.ops import channelize as ch_ops
from vlite_fast_tpu_torch.ops import kurtosis as kur_ops
from vlite_fast_tpu_torch.ops import normalize as norm_ops

LAUNCHES = 0

_TABLES: dict = {}


def _tables(nfft: int, device: torch.device) -> tuple:
    """(w1, tw, w2[:, :n2_out]) as interleaved complex f32 on `device`."""
    key = (nfft, str(device))
    if key not in _TABLES:
        n1, _ = ch_ops._ct_split(nfft)
        w1, tw, w2 = ch_ops._ct_tables(nfft)
        w2 = w2[:, :nfft // 2 // n1 + 1]
        _TABLES[key] = tuple(
            torch.view_as_real(torch.from_numpy(np.ascontiguousarray(t)))
            .contiguous().to(device) for t in (w1, tw, w2))
    return _TABLES[key]


def chain_second_v2_plain(raw: torch.Tensor, bp: torch.Tensor,
                          cfg: PipelineConfig):
    """The plain version: the port's torch chain, segment by segment."""
    cfg0 = dataclasses.replace(cfg, inject_frb=False)
    state = dsp.init_state(cfg0, raw.device)._replace(bp=bp[0],
                                                      bp_kur=bp[1])
    outs, state = dsp.run_segments(cfg0, raw, state)
    return (torch.cat([o.packed for o in outs]),
            torch.cat([o.packed_kur for o in outs]),
            torch.cat([o.weights for o in outs], dim=1),
            torch.stack([o.dag_frac for o in outs]),
            torch.stack([state.bp, state.bp_kur]))


def chain_second_v2(raw: torch.Tensor, bp: torch.Tensor,
                    cfg: PipelineConfig):
    """One injection-free second through the chain.

    raw: uint8 (npol_in, sample_rate); bp: f32 (2, npol_in, nchan)
    [plain; kur] carried bandpass.  Returns (packed u8 (rows, nbytes),
    packed_kur u8 (rows, nbytes), weights f32 (npol_in, seg_per_sec *
    ffts_per_seg), dag_frac f32 (seg_per_sec,), bp_new f32 (2, npol_in,
    nchan)) with rows = seg_per_sec * out_samps_per_seg.  A stream that
    rfi_mode does not produce comes back zero, its bandpass unchanged."""
    global LAUNCHES
    if raw.device.type == "cpu":
        return chain_second_v2_plain(raw, bp, cfg)
    if raw.device.type != "cuda":
        raise ValueError(f"chain_second_v2: unsupported device {raw.device}")
    if not dsp.megakernel_supported(cfg):
        raise ValueError("chain_second_v2: the CUDA kernel takes only "
                         "injection-free 2-bit npol_out=1 configs with the "
                         "matmul channelizer (baseband_dsp."
                         "megakernel_supported); got " + repr(cfg))
    npol, nsamp = cfg.npol_in, cfg.sample_rate
    if raw.dtype != torch.uint8 or tuple(raw.shape) != (npol, nsamp) \
            or not raw.is_contiguous():
        raise ValueError(f"raw must be contiguous uint8 ({npol}, {nsamp})")
    if bp.dtype != torch.float32 or tuple(bp.shape) != (2, npol, cfg.nchan) \
            or not bp.is_contiguous() or bp.device != raw.device:
        raise ValueError(f"bp must be contiguous f32 (2, {npol}, "
                         f"{cfg.nchan}) on {raw.device}")
    lib = _build.load("chain")
    fn = lib.vf_chain_second
    fn.argtypes = [ctypes.c_void_p] * 16
    fn.restype = ctypes.c_int
    dev = raw.device
    n1, n2 = ch_ops._ct_split(cfg.nfft)
    w1, tw, w2 = _tables(cfg.nfft, dev)
    nrows = cfg.seg_per_sec * cfg.out_samps_per_seg
    nbytes = cfg.nchanout // 4
    nblk = cfg.seg_per_sec * cfg.ffts_per_seg
    nstreams = 2 if cfg.rfi_mode == 2 else 1
    power = torch.empty((nstreams, npol, nblk, cfg.nchan),
                        dtype=torch.float32, device=dev)
    keep = torch.empty((max(1, nblk * cfg.windows_per_fft),),
                       dtype=torch.uint8, device=dev)
    dagcnt = torch.zeros((cfg.seg_per_sec,), dtype=torch.int32, device=dev)
    packed = torch.zeros((nrows, nbytes), dtype=torch.uint8, device=dev)
    packed_kur = torch.zeros_like(packed)
    weights = (torch.ones if cfg.rfi_mode == 0 else torch.empty)(
        (npol, nblk), dtype=torch.float32, device=dev)
    dag_frac = torch.empty((cfg.seg_per_sec,), dtype=torch.float32,
                           device=dev)
    bp_out = bp.clone()
    s, oms = norm_ops.ema_constants(cfg.bp_scale)
    ip = (ctypes.c_longlong * 11)(
        npol, nsamp, cfg.nfft, n1, n2, cfg.nkurto, cfg.seg_per_sec,
        cfg.nscrunch, cfg.rfi_mode, cfg.chanmin, cfg.chanmax)
    fvals = [s, oms, cfg.dag_thresh, cfg.dag_fb_thresh, C.DAG_INF,
             C.BP_CLIP_RATIO, C.BP_CLIP_VALUE, cfg.min_weight,
             norm_ops._SQRT_HALF, norm_ops.inv_sqrt(cfg.nscrunch),
             *C.QUANT2_THRESH, *kur_ops.dag_consts(cfg.nkurto),
             *kur_ops.dag_consts(cfg.nfft)]
    fp = (ctypes.c_float * len(fvals))(*fvals)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    rc = fn(ctypes.cast(ip, ctypes.c_void_p), ctypes.cast(fp, ctypes.c_void_p),
            ptr(raw), ptr(w1), ptr(tw), ptr(w2), ptr(bp), ptr(power),
            ptr(keep), ptr(dagcnt), ptr(packed), ptr(packed_kur),
            ptr(weights), ptr(dag_frac), ptr(bp_out),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(rc, "vf_chain_second", lib)
    LAUNCHES += 1
    return packed, packed_kur, weights, dag_frac, bp_out
