"""The fused DSP chain for one second: CUDA kernels + plain versions.

Replaces six TPU kernels of vlite_fast_tpu/ops/megakernel.py.  Four are
on the injection-free twin:

  chain_second_v2      (body _full_kernel_v2) on the raw second:
                       csrc/chain.cu, layout 0, on the tensor-core DFT of
                       csrc/dft_tc.cuh;
  pallas_pretranspose  (body _pretranspose_kernel) the Cooley-Tukey-major
                       relayout, u8 bytes or bf16 converted voltages:
                       csrc/pretranspose.cu;
  chain_second         (body _full_kernel) on those CT-major tiles:
                       csrc/chain.cu, layouts 1 (u8) and 2 (bf16);
  chain_second_v4      (body _full_kernel_v4) the same, its DFT stages
                       batched on the TPU: the same chain.cu launch on
                       pallas_pretranspose's tiles.

Two are the staged chain, the JAX package's milestones towards the
fused kernel (its tests and benchmarks/bench_megakernel_tpu.py reach
them; no configuration does):

  dft_detect_power     (body _stageA_kernel) stage A: convert, the
                       split-plane bf16 Cooley-Tukey DFT, detect:
                       csrc/stage_ab.cu on csrc/dft_tc.cuh (tensor cores);
  chain_second_plain   (body _mk_stageB_kernel) stage B: stage A, then the
                       plain stream's EMA, scrunches and 2-bit pack with
                       the bandpass carried: the same DFT, then chain.cuh's
                       EMA launch in rfi_mode 0.

One replaces no TPU kernel, because the JAX package's pfb path is XLA
(vlite_fast_tpu/ops/channelize.polyphase_channelize, its WOLA and then
matmul_rfft's einsums at dft_precision):

  wola_dft_detect_power  the pfb station's WOLA, DFT and detect of one
                         stream in one launch: csrc/wola_tc.cu, the
                         tensor-core DFT of csrc/dft_tc.cuh with its WOLA
                         loader (frames formed in f32 from their taps,
                         split into bf16 hi + lo, stage 1 in three passes:
                         the configuration's bf16x3).

The three chains compute one function, as their TPU kernels do, and are
one launch of csrc/chain.cu on the current stream: the front, the DFT on
the tensor cores in the TPU kernels' split-plane bf16 arithmetic (wgmma,
csrc/dft_tc.cuh, the same kernel as the staged chain's; the kurtosis
stream's own transform only in the blocks the front flagged in part),
then the EMA back end (a pass for each segment's starting bandpass, then
one thread per (stream, segment, pol, channel)).  Only the loader
differs: the raw second, or CT-major u8 or bf16 tiles, each putting the
same bf16 frame in shared memory, so the three give the same bits.  The
source headers have the details.

They work in the natural layout: raw (npol, nsamp) u8 in, linear
channels out.  The chains take the bandpass (2, npol, nchan) [plain;
kur] and return packed sel_and_dig rows.  Stage A returns power (nseg,
npol * ffts, nfft // 2 + 1) f32; stage B takes and returns the bandpass
(npol, nfft // 2 + 1) and returns the sel_and_dig rows (nseg * nout,
(chanmax - chanmin + 1) // 4) u8.  The TPU kernels' factored (k2, k1)
planes, which every JAX caller unfolds at once, and their helpers
(bp_to/from_factored[_v2], unfactor_pack_realign[_v2]) are TPU layout
and have no counterpart here: the outputs equal the JAX helpers'
unfolding of the JAX outputs (interop.bp_from_factored carries a JAX
stage-B bandpass over).  `pretranspose_u8` is XLA in the reference and
stays torch.

Dispatch: a CPU tensor goes to the plain version (for the chains the
port's torch chain segment by segment with injection off: on the f32 DFT
for chain_second_v2, on the split-plane DFT for the CT-major chains,
whose card tests hold them to it at seeds where the f32 DFT puts a 2-bit
level one off; dft_detect_oracle and chain_second_plain_oracle for the
stages); a CUDA tensor launches the kernel or raises.  LAUNCHES counts
kernel launches per wrapper.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from vlite_fast_tpu_torch import constants as C
from vlite_fast_tpu_torch.config import PipelineConfig
from vlite_fast_tpu_torch import _build
from vlite_fast_tpu_torch.models import baseband_dsp as dsp
from vlite_fast_tpu_torch.ops import channelize as ch_ops
from vlite_fast_tpu_torch.ops import kurtosis as kur_ops
from vlite_fast_tpu_torch.ops import normalize as norm_ops
from vlite_fast_tpu_torch.ops import quantize as q_ops
from vlite_fast_tpu_torch.ops import unpack as unpack_ops

LAUNCHES = {"chain_second_v2": 0, "pallas_pretranspose": 0,
            "chain_second": 0, "chain_second_v4": 0,
            "dft_detect_power": 0, "chain_second_plain": 0,
            "wola_dft_detect_power": 0}
LANE = 128               # the CT-major tile is LANE x LANE
PRETRANSPOSE = ("xla", "pallas", "pallas_bf16")


def _chain_plain(raw: torch.Tensor, bp: torch.Tensor, cfg: PipelineConfig,
                 power=dsp._power):
    """The port's torch chain, segment by segment, with `power` as its
    channelize + detect stage (dsp.run_segments)."""
    cfg0 = dataclasses.replace(cfg, inject_frb=False)
    state = dsp.init_state(cfg0, raw.device)._replace(bp=bp[0],
                                                      bp_kur=bp[1])
    outs, state = dsp.run_segments(cfg0, raw, state, power)
    return (torch.cat([o.packed for o in outs]),
            torch.cat([o.packed_kur for o in outs]),
            torch.cat([o.weights for o in outs], dim=1),
            torch.stack([o.dag_frac for o in outs]),
            torch.stack([state.bp, state.bp_kur]))


def chain_second_v2_plain(raw: torch.Tensor, bp: torch.Tensor,
                          cfg: PipelineConfig):
    """The plain version of chain_second_v2: the port's torch chain on
    the f32 DFT, segment by segment."""
    return _chain_plain(raw, bp, cfg)


def chain_second_ct_plain(raw: torch.Tensor, bp: torch.Tensor,
                          cfg: PipelineConfig):
    """The plain version of the CT-major chains (chain_second,
    chain_second_v4): the same chain on the split-plane bf16 DFT that
    every TPU chain kernel computes (split_power, dft_detect_oracle's
    products), the front, the kurtosis stream, the EMA, the scrunches and
    the pack the torch chain's own.  The JAX package holds its v4 kernel
    to its v1 and v2 kernels, never to an f32 chain; `chain_second_plain`
    is another TPU kernel's, the Stage-B chain."""
    return _chain_plain(raw, bp, cfg, split_power)


chain_second_v4_plain = chain_second_ct_plain


def pretranspose_u8(raw: torch.Tensor, nfft: int, npol: int,
                    seg_per_sec: int) -> torch.Tensor:
    """(npol, nsamp) u8 -> (nseg, npol * ffts * 128, 128) CT-major tiles:
    tile (s, pol, t) holds frame sample n = m1 * n2 + m2 at row m2, lane
    m1, zero beyond n2 rows and n1 lanes (the JAX package's XLA relayout,
    here torch on any device)."""
    n1, n2 = ch_ops._ct_split(nfft)
    ffts = raw.shape[1] // seg_per_sec // nfft
    f = raw.reshape(npol, seg_per_sec, ffts, n1, n2).permute(1, 0, 2, 4, 3)
    out = torch.zeros((seg_per_sec, npol, ffts, LANE, LANE),
                      dtype=raw.dtype, device=raw.device)
    out[..., :n2, :n1] = f
    return out.reshape(seg_per_sec, npol * ffts * LANE, LANE)


def pallas_pretranspose_plain(raw: torch.Tensor, nfft: int, npol: int,
                              seg_per_sec: int,
                              out_dtype=torch.uint8) -> torch.Tensor:
    """The plain version: pretranspose_u8, then for bf16 the converted
    voltages u / 128 - 1 with u == 0 -> 0 (exact in bf16)."""
    u = pretranspose_u8(raw, nfft, npol, seg_per_sec)
    if out_dtype == torch.uint8:
        return u
    return unpack_ops.convert_uint8(u).to(out_dtype)


def pallas_pretranspose(raw: torch.Tensor, nfft: int, npol: int,
                        seg_per_sec: int,
                        out_dtype=torch.uint8) -> torch.Tensor:
    """The CT-major relayout of one second (pretranspose_u8's tiles).

    raw: contiguous u8 (npol, nsamp); out_dtype torch.uint8 (the bytes)
    or torch.bfloat16 (the converted voltages)."""
    n1, n2, ffts = _check_pretranspose_args(raw, nfft, npol, seg_per_sec,
                                            out_dtype)
    if raw.device.type == "cpu":
        return pallas_pretranspose_plain(raw, nfft, npol, seg_per_sec,
                                         out_dtype)
    if raw.device.type != "cuda":
        raise ValueError(f"pallas_pretranspose: unsupported device "
                         f"{raw.device}")
    nsamp = raw.shape[-1]
    out = torch.empty((seg_per_sec, npol * ffts * LANE, LANE),
                      dtype=out_dtype, device=raw.device)
    lib = _build.load("pretranspose")
    fn = lib.vf_pretranspose
    fn.argtypes = [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    ip = (ctypes.c_longlong * 7)(npol, nsamp, nfft, n1, n2, seg_per_sec,
                                 int(out_dtype == torch.bfloat16))
    rc = fn(ctypes.cast(ip, ctypes.c_void_p), ctypes.c_void_p(raw.data_ptr()),
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream(raw.device)
                            .cuda_stream))
    _build.check(rc, "vf_pretranspose", lib)
    LAUNCHES["pallas_pretranspose"] += 1
    return out


def _check_pretranspose_args(raw: torch.Tensor, nfft: int, npol: int,
                             seg_per_sec: int, out_dtype) -> tuple:
    """(n1, n2, ffts) of a relayout the kernel takes; raises otherwise."""
    if out_dtype not in (torch.uint8, torch.bfloat16):
        raise ValueError(f"pallas_pretranspose: out_dtype {out_dtype}")
    n1, n2 = ch_ops._ct_split(nfft)
    if n1 > LANE or n2 > LANE:
        raise ValueError(f"pallas_pretranspose: CT factors {n1}x{n2} exceed "
                         f"the {LANE}x{LANE} tile")
    nsamp = raw.shape[-1]
    if raw.dtype != torch.uint8 or raw.dim() != 2 or raw.shape[0] != npol \
            or nsamp % (seg_per_sec * nfft) or not raw.is_contiguous():
        raise ValueError(f"pallas_pretranspose: raw must be contiguous "
                         f"uint8 ({npol}, k * {seg_per_sec * nfft})")
    return n1, n2, nsamp // seg_per_sec // nfft


def _check_chain_args(name: str, raw: torch.Tensor, bp: torch.Tensor,
                      cfg: PipelineConfig, layout: str) -> None:
    if raw.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {raw.device}")
    if not dsp.chain_kernel_takes(cfg, layout):
        raise ValueError(f"{name}: the CUDA kernel takes only injection-free "
                         "2-bit npol_out=1 configs with the matmul "
                         "channelizer and a CT split that fits "
                         f"(baseband_dsp.chain_kernel_takes, layout "
                         f"{layout!r}); got " + repr(cfg))
    npol, nsamp = cfg.npol_in, cfg.sample_rate
    if raw.dtype != torch.uint8 or tuple(raw.shape) != (npol, nsamp) \
            or not raw.is_contiguous():
        raise ValueError(f"raw must be contiguous uint8 ({npol}, {nsamp})")
    if bp.dtype != torch.float32 or tuple(bp.shape) != (2, npol, cfg.nchan) \
            or not bp.is_contiguous() or bp.device != raw.device:
        raise ValueError(f"bp must be contiguous f32 (2, {npol}, "
                         f"{cfg.nchan}) on {raw.device}")


def _chain_params(cfg: PipelineConfig, layout: int) -> tuple:
    """chain.cuh's chain_params (int64 and f32 arrays) for cfg, then the
    input layout."""
    n1, n2 = ch_ops._ct_split(cfg.nfft)
    s, oms = norm_ops.ema_constants(cfg.bp_scale)
    ivals = [cfg.npol_in, cfg.sample_rate, cfg.nfft, n1, n2, cfg.nkurto,
             cfg.seg_per_sec, cfg.nscrunch, cfg.rfi_mode, cfg.chanmin,
             cfg.chanmax, layout]
    fvals = [s, oms, cfg.dag_thresh, cfg.dag_fb_thresh, C.DAG_INF,
             C.BP_CLIP_RATIO, C.BP_CLIP_VALUE, cfg.min_weight,
             norm_ops._SQRT_HALF, norm_ops.inv_sqrt(cfg.nscrunch),
             *C.QUANT2_THRESH, *kur_ops.dag_consts(cfg.nkurto),
             *kur_ops.dag_consts(cfg.nfft)]
    return ivals, fvals


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _ema_seeds(npol: int, nseg: int, nchan: int, device) -> torch.Tensor:
    """Scratch of the chain's EMA launch (chain.cuh's launch_ema): f32
    (2, npol, nseg, nchan), the per-segment seeds and then the bandpass
    each segment starts from, then the weighted stream's counts of
    spectra of weight > 0 (npol, nseg) as i32."""
    return torch.empty((2 * npol * nseg * nchan + npol * nseg,),
                       dtype=torch.float32, device=device)


def _launch_chain(inp: torch.Tensor, layout: int, bp: torch.Tensor,
                  cfg: PipelineConfig):
    """Allocate the outputs and scratch and launch csrc/chain.cu's
    vf_chain_second on `inp` in input layout `layout` (0 the raw second,
    1 CT-major u8 tiles, 2 CT-major bf16 tiles)."""
    lib = _build.load("chain")
    fn = lib.vf_chain_second
    dev = bp.device
    npol = cfg.npol_in
    nrows = cfg.seg_per_sec * cfg.out_samps_per_seg
    nbytes = cfg.nchanout // 4
    nblk = cfg.seg_per_sec * cfg.ffts_per_seg
    # the plain plane, and with the front the kurtosis plane of the blocks
    # flagged in part
    nplanes = 1 if cfg.rfi_mode == 0 else 2
    power = torch.empty((nplanes, npol, nblk, cfg.nchan),
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
    ivals, fvals = _chain_params(cfg, layout)
    # the front's list of blocks flagged in part: flags, ids, count
    scratch = [torch.empty((nblk,), dtype=torch.uint8, device=dev),
               torch.empty((nblk,), dtype=torch.int32, device=dev),
               torch.zeros((1,), dtype=torch.int32, device=dev)]
    ip = (ctypes.c_longlong * len(ivals))(*ivals)
    fp = (ctypes.c_float * len(fvals))(*fvals)
    seeds = _ema_seeds(npol, cfg.seg_per_sec, cfg.nchan, dev)
    ptrs = [_ptr(t) for t in (inp, *tc_planes(cfg.nfft, dev), bp, power,
                              keep, dagcnt, seeds, *scratch, packed,
                              packed_kur, weights, dag_frac, bp_out)]
    fn.argtypes = [ctypes.c_void_p] * (len(ptrs) + 3)
    fn.restype = ctypes.c_int
    rc = fn(ctypes.cast(ip, ctypes.c_void_p), ctypes.cast(fp, ctypes.c_void_p),
            *ptrs, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(rc, "vf_chain_second", lib)
    return packed, packed_kur, weights, dag_frac, bp_out


def chain_second_v2(raw: torch.Tensor, bp: torch.Tensor,
                    cfg: PipelineConfig):
    """One injection-free second through the chain, natural layout.

    raw: uint8 (npol_in, sample_rate); bp: f32 (2, npol_in, nchan)
    [plain; kur] carried bandpass.  Returns (packed u8 (rows, nbytes),
    packed_kur u8 (rows, nbytes), weights f32 (npol_in, seg_per_sec *
    ffts_per_seg), dag_frac f32 (seg_per_sec,), bp_new f32 (2, npol_in,
    nchan)) with rows = seg_per_sec * out_samps_per_seg.  A stream that
    rfi_mode does not produce comes back zero, its bandpass unchanged."""
    if raw.device.type == "cpu":
        return chain_second_v2_plain(raw, bp, cfg)
    _check_chain_args("chain_second_v2", raw, bp, cfg, "natural")
    out = _launch_chain(raw, 0, bp, cfg)
    LAUNCHES["chain_second_v2"] += 1
    return out


def chain_second(raw: torch.Tensor, bp: torch.Tensor, cfg: PipelineConfig,
                 pretranspose: str = "xla"):
    """chain_second_v2's second on the CT-major tiles: pretranspose 'xla'
    (pretranspose_u8, torch), 'pallas' (the pallas_pretranspose kernel, u8)
    or 'pallas_bf16' (the same kernel shipping converted voltages).  Same
    arguments and returns as chain_second_v2; the three modes give
    byte-identical outputs."""
    if pretranspose not in PRETRANSPOSE:
        raise ValueError(f"chain_second: pretranspose {pretranspose!r} not "
                         f"in {PRETRANSPOSE}")
    if raw.device.type == "cpu":
        return chain_second_ct_plain(raw, bp, cfg)
    _check_chain_args("chain_second", raw, bp, cfg, "ct")
    args = (raw, cfg.nfft, cfg.npol_in, cfg.seg_per_sec)
    if pretranspose == "xla":
        xs, layout = pretranspose_u8(*args), 1
    elif pretranspose == "pallas":
        xs, layout = pallas_pretranspose(*args), 1
    else:
        xs, layout = pallas_pretranspose(*args, torch.bfloat16), 2
    out = _launch_chain(xs, layout, bp, cfg)
    LAUNCHES["chain_second"] += 1
    return out


def chain_second_v4(raw: torch.Tensor, bp: torch.Tensor, cfg: PipelineConfig,
                    pre_dtype: str = "u8", pre_impl: str = "mxu"):
    """chain_second on pallas_pretranspose's tiles (pre_dtype 'u8' or
    'bf16'): the TPU kernel batches both DFT stages, the card runs the
    same chain.cu launch as chain_second.  pre_impl ('mxu' | 'xlu') picks
    the TPU's transpose engine, which gives identical bytes either way; it
    is checked and has no other effect here.  Same arguments and returns
    as chain_second_v2."""
    if pre_dtype not in ("u8", "bf16") or pre_impl not in ("mxu", "xlu"):
        raise ValueError(f"chain_second_v4: pre_dtype {pre_dtype!r}, "
                         f"pre_impl {pre_impl!r}")
    if raw.device.type == "cpu":
        return chain_second_v4_plain(raw, bp, cfg)
    _check_chain_args("chain_second_v4", raw, bp, cfg, "ct")
    bf16 = pre_dtype == "bf16"
    xs = pallas_pretranspose(raw, cfg.nfft, cfg.npol_in, cfg.seg_per_sec,
                             torch.bfloat16 if bf16 else torch.uint8)
    out = _launch_chain(xs, 2 if bf16 else 1, bp, cfg)
    LAUNCHES["chain_second_v4"] += 1
    return out


# ---------------------------------------------------------------------------
# The staged chain: stage A (dft_detect_power) and stage B
# (chain_second_plain), the TPU kernels' split-plane bf16 arithmetic
# ---------------------------------------------------------------------------

def _hi_lo(m: torch.Tensor) -> tuple:
    """f32 -> (hi, lo), both bf16-exact f32: hi = bf16(m), lo = bf16(m - hi),
    each rounded to nearest even (the JAX package's _hi_lo and _split)."""
    hi = m.to(torch.bfloat16).to(torch.float32)
    lo = (m - hi).to(torch.bfloat16).to(torch.float32)
    return hi, lo


class SplitPlanes(NamedTuple):
    """The constants of the split-plane DFT at natural shapes (f32, the
    hi/lo planes bf16-exact): the counterpart of the JAX package's
    DFTPlanes without its 128-lane padding and twiddle tiling."""

    w1r_hi: torch.Tensor   # (n1, n1) [k1, m1] stage-1 real plane
    w1r_lo: torch.Tensor
    w1i_hi: torch.Tensor   # imaginary plane
    w1i_lo: torch.Tensor
    twr: torch.Tensor      # (n1, n2) [k1, m2] twiddle, f32
    twi: torch.Tensor
    w2r_hi: torch.Tensor   # (n2, n2_out) [m2, k2] stage-2 real plane
    w2r_lo: torch.Tensor
    w2i_hi: torch.Tensor
    w2i_lo: torch.Tensor


_SPLIT: dict = {}


def split_planes(nfft: int, device) -> SplitPlanes:
    """The split planes of nfft = n1 * n2 on `device` (built once)."""
    key = (nfft, str(device))
    if key not in _SPLIT:
        n1, _ = ch_ops._ct_split(nfft)
        w1, tw, w2 = ch_ops._ct_tables(nfft)
        w2 = w2[:, :nfft // 2 // n1 + 1]
        f32 = lambda a: torch.from_numpy(np.ascontiguousarray(
            a.astype(np.float32)))
        # stage 1 contracts m1 against W1[m1, k1] = w1[k1, m1] (the JAX
        # package's w1.T); the port keeps W1's transpose, [k1, m1], which
        # is w1 itself
        planes = (*_hi_lo(f32(w1.real)), *_hi_lo(f32(w1.imag)),
                  f32(tw.real), f32(tw.imag),
                  *_hi_lo(f32(w2.real)), *_hi_lo(f32(w2.imag)))
        _SPLIT[key] = SplitPlanes(*(p.to(device) for p in planes))
    return _SPLIT[key]


def _frames(raw: torch.Tensor, nfft: int, npol: int,
            seg_per_sec: int) -> torch.Tensor:
    """(npol, nsamp) u8 -> (nseg, npol, ffts, n1, n2) frames, sample
    n = m1 * n2 + m2 at [m1, m2] (a view)."""
    n1, n2 = ch_ops._ct_split(nfft)
    ffts = raw.shape[1] // seg_per_sec // nfft
    return raw.reshape(npol, seg_per_sec, ffts, n1, n2).transpose(0, 1)


def dft_detect_oracle(raw: torch.Tensor, nfft: int, npol: int,
                      seg_per_sec: int, seg_chunk: int = 32) -> torch.Tensor:
    """Stage A's plain version: the split-plane bf16 DFT emulated in f32
    (each operand rounded to bf16 values, every product exact in f32, the
    sums f32 matrix products), then |X|^2, in the JAX package's order of
    terms (its dft_detect_oracle).  raw u8 (npol, nsamp) -> power f32
    (nseg, npol * ffts, nfft // 2 + 1), linear channels.  seg_chunk
    segments at a time bound the memory at production size."""
    nchan = nfft // 2 + 1
    fr = _frames(raw, nfft, npol, seg_per_sec)
    ffts = fr.shape[2]
    out = torch.empty((seg_per_sec, npol * ffts, nchan), dtype=torch.float32,
                      device=raw.device)
    for s0 in range(0, seg_per_sec, seg_chunk):
        s1 = min(s0 + seg_chunk, seg_per_sec)
        x = unpack_ops.convert_uint8(fr[s0:s1])
        out[s0:s1] = _split_detect(x, nfft).reshape(s1 - s0, npol * ffts,
                                                    nchan)
    return out


def _split_detect(x: torch.Tensor, nfft: int,
                  x_lo: torch.Tensor | None = None) -> torch.Tensor:
    """The split-plane bf16 DFT and |X|^2 of bf16-exact f32 frames x
    (..., n1, n2), sample n = m1 * n2 + m2 at [m1, m2], emulated in f32 in
    the JAX package's order of terms -> power (..., nfft // 2 + 1),
    linear channels.  With x_lo (frames that are not exact in bf16, split
    as x + x_lo by _hi_lo) stage 1 takes the third pass of bf16x3:
    W1hi x + (W1lo x + W1hi x_lo)."""
    n1, n2 = ch_ops._ct_split(nfft)
    n2o = nfft // 2 // n1 + 1
    sp = split_planes(nfft, x.device)
    batch = x.shape[:-2]
    x = x.reshape(-1, n1, n2)
    if x_lo is None:
        ar = torch.matmul(sp.w1r_hi, x) + torch.matmul(sp.w1r_lo, x)
        ai = torch.matmul(sp.w1i_hi, x) + torch.matmul(sp.w1i_lo, x)
    else:
        xl = x_lo.reshape(-1, n1, n2)
        ar = torch.matmul(sp.w1r_hi, x) + (torch.matmul(sp.w1r_lo, x)
                                           + torch.matmul(sp.w1r_hi, xl))
        ai = torch.matmul(sp.w1i_hi, x) + (torch.matmul(sp.w1i_lo, x)
                                           + torch.matmul(sp.w1i_hi, xl))
    br = ar * sp.twr - ai * sp.twi
    bi = ar * sp.twi + ai * sp.twr
    rh, rl = _hi_lo(br)
    ih, il = _hi_lo(bi)

    def stage2(w_hi, w_lo, h, lo):
        return (torch.matmul(h, w_hi) + torch.matmul(lo, w_hi)
                + torch.matmul(h, w_lo))

    pr = (stage2(sp.w2r_hi, sp.w2r_lo, rh, rl)
          - stage2(sp.w2i_hi, sp.w2i_lo, ih, il))
    pi = (stage2(sp.w2i_hi, sp.w2i_lo, rh, rl)
          + stage2(sp.w2r_hi, sp.w2r_lo, ih, il))
    p = pr * pr + pi * pi                              # (f, k1, k2)
    lin = p.transpose(1, 2).reshape(-1, n2o * n1)[:, :nfft // 2 + 1]
    return lin.reshape(*batch, -1)


def split_power(cfg: PipelineConfig, v: torch.Tensor, since: int
                ) -> torch.Tensor:
    """baseband_dsp's power stage on the split-plane DFT (no injection):
    voltages (npol, nsamp) f32, bf16-exact (converted bytes, masked or
    not) -> power f32 (npol, nsamp // nfft, nchan)."""
    n1, n2 = ch_ops._ct_split(cfg.nfft)
    npol, nsamp = v.shape
    return _split_detect(v.reshape(npol, nsamp // cfg.nfft, n1, n2),
                         cfg.nfft)


class TcGeometry(NamedTuple):
    """The tensor-core DFT's shapes for nfft = n1 * n2 (csrc/dft_tc.cuh's
    Geom) and one loader (ct: 0 the raw second, else the element bytes of
    the CT-major tiles; wola: the WOLA loader, whose lo frame tile takes
    the ring's place): consumer warpgroups (64 rows k1 each), the stage-1
    depth in 8-wide core blocks, the W1 rows stored in 8-row groups, the
    stage-1 passes of 32 m2 columns, the W2 depth stored in 8-wide core
    blocks (all 32 npass columns that stage 2 walks), the ring's slots
    (raw frames, or CT slices of 32 tile rows), whether two blocks share
    each frame (one warpgroup's 64 rows of W1 each, where all of W1 does
    not fit) and the block's shared memory in bytes."""

    n1: int
    n2: int
    n2_out: int
    nwg: int
    kb1: int
    rg1: int
    npass: int
    kb2: int
    nslot: int
    split: bool
    smem: int


TC_SMEM_MAX = 232448     # shared memory a block may use on Hopper
TC_SLOTS = 3             # raw frames in flight (dft_tc.cuh's kSlots)
TC_CT_SLOTS = 8          # CT slices in flight, at most (kCtSlots)


def tc_geometry(nfft: int, ct: int = 0, wola: bool = False) -> TcGeometry:
    n1, n2 = ch_ops._ct_split(nfft)
    kb1, rg1, npass = 2 * -(-n1 // 16), -(-n1 // 8), -(-n2 // 32)
    kb2, nwg = 4 * npass, -(-n1 // 64)
    slot = 0 if wola else min(32, n2) * 128 * ct if ct else \
        -(-nfft // 16) * 16 + 16
    for split in (False, True):
        ring = (4 * (8 if split else rg1) * kb1 + 4 * 8 * kb2
                + (2 if wola else 1) * 4 * npass * kb1) * 128
        nslot = 0 if wola else TC_SLOTS if not ct else min(
            TC_CT_SLOTS, (TC_SMEM_MAX - ring - 8 * TC_CT_SLOTS) // slot)
        smem = ring + nslot * slot + 8 * nslot
        if (smem <= TC_SMEM_MAX and (not ct or nslot > npass)) or nwg < 2:
            break
    return TcGeometry(n1, n2, nfft // 2 // n1 + 1, nwg, kb1, rg1, npass, kb2,
                      nslot, split, smem)


def tc_fits(nfft: int, wola: bool = False) -> bool:
    """Whether the tensor-core DFT takes nfft's CT split, for every chain
    loader (the raw second, u8 and bf16 CT-major tiles), or with wola for
    the WOLA loader: n1 <= 128 (two warpgroups), n2 <= 128, n2_out <= 64
    (one m64n64 stage-2 product), its planes, frame tiles and ring within
    a block's shared memory, and for the tiles at least npass + 1 slices
    in the ring."""
    for ct in ((0,) if wola else (0, 1, 2)):
        g = tc_geometry(nfft, ct, wola)
        if not (2 <= g.n1 <= 128 and g.n2 <= 128 and g.n2_out <= 64
                and g.smem <= TC_SMEM_MAX and (not ct or g.nslot > g.npass)):
            return False
    return True


def tc_planes(nfft: int, device) -> tuple:
    """The split planes in the layouts csrc/dft_tc.cuh reads: w1 bf16 (4,
    rg1, kb1, 8, 8) and w2 bf16 (4, 8, kb2, 8, 8) as wgmma's
    no-swizzle core matrices (K-major: [8-row group, 8-wide K block, row,
    element]; W1 [k1, m1] as stage 1's A operand, W2 as stage 2's B
    operand stored [k2, m2]; planes hi_r, lo_r, hi_i, lo_i), and tw f32
    (2, 4 nwg, 4 npass, 32, 4) in the accumulator order of wgmma
    m64nNk16 (per warp of 16 rows and n8 chunk: rows g, g + 8, columns
    2t, 2t + 1, lane = 4 g + t), every padded entry 0."""
    key = ("tc", nfft, str(device))
    if key in _SPLIT:
        return _SPLIT[key]
    geo = tc_geometry(nfft)
    n1, n2 = geo.n1, geo.n2
    sp = split_planes(nfft, "cpu")

    def cores(m, ngrp, nblk):
        out = torch.zeros((8 * ngrp, 8 * nblk), dtype=torch.bfloat16)
        out[:m.shape[0], :m.shape[1]] = m.to(torch.bfloat16)
        return out.reshape(ngrp, 8, nblk, 8).permute(0, 2, 1, 3)

    w1 = torch.stack([cores(m, geo.rg1, geo.kb1) for m in
                      (sp.w1r_hi, sp.w1r_lo, sp.w1i_hi, sp.w1i_lo)])
    w2 = torch.stack([cores(m.T, 8, geo.kb2) for m in
                      (sp.w2r_hi, sp.w2r_lo, sp.w2i_hi, sp.w2i_lo)])
    twp = np.zeros((2, 64 * geo.nwg, 32 * geo.npass), np.float32)
    twp[0, :n1, :n2] = sp.twr.numpy()
    twp[1, :n1, :n2] = sp.twi.numpy()
    i = np.arange(4 * geo.nwg)[:, None, None]
    j = np.arange(4 * geo.npass)[None, :, None]
    g = (np.arange(32) // 4)[None, None, :]
    t = (np.arange(32) % 4)[None, None, :]
    r0, c0 = 16 * i + g, 8 * j + 2 * t
    tw = np.stack([twp[:, r0, c0], twp[:, r0, c0 + 1], twp[:, r0 + 8, c0],
                   twp[:, r0 + 8, c0 + 1]], axis=-1)
    planes = (w1.contiguous().to(device),
              torch.from_numpy(np.ascontiguousarray(tw)).to(device),
              w2.contiguous().to(device))
    _SPLIT[key] = planes
    return planes


def _check_stage_args(name: str, raw: torch.Tensor, nfft: int, npol: int,
                      seg_per_sec: int) -> None:
    if raw.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {raw.device}")
    if not tc_fits(nfft):
        raise ValueError(f"{name}: the CUDA kernel takes CT splits n1 <= 128, "
                         f"n2 <= 128, n2_out <= 64 within a block's shared "
                         f"memory (tc_fits); got nfft {nfft} = "
                         f"{' x '.join(map(str, ch_ops._ct_split(nfft)))}")
    nsamp = raw.shape[-1]
    if raw.dtype != torch.uint8 or raw.dim() != 2 or raw.shape[0] != npol \
            or nsamp % (seg_per_sec * nfft) or not raw.is_contiguous():
        raise ValueError(f"{name}: raw must be contiguous uint8 ({npol}, k * "
                         f"{seg_per_sec * nfft})")


def dft_detect_power(raw: torch.Tensor, nfft: int, npol: int,
                     seg_per_sec: int) -> torch.Tensor:
    """Stage A: convert, the split-plane bf16 Cooley-Tukey DFT, detect.

    raw u8 (npol, nsamp) -> power f32 (nseg, npol * ffts, nfft // 2 + 1),
    row (pol, fft) within a segment, linear channels: the JAX package's
    dft_detect_power with its factored planes unfolded."""
    if raw.device.type == "cpu":
        return dft_detect_oracle(raw, nfft, npol, seg_per_sec)
    _check_stage_args("dft_detect_power", raw, nfft, npol, seg_per_sec)
    n1, n2 = ch_ops._ct_split(nfft)
    nsamp = raw.shape[1]
    ffts = nsamp // seg_per_sec // nfft
    out = torch.empty((seg_per_sec, npol * ffts, nfft // 2 + 1),
                      dtype=torch.float32, device=raw.device)
    a1, tw, b2 = tc_planes(nfft, raw.device)
    lib = _build.load("stage_ab")
    fn = lib.vf_dft_detect_power
    fn.argtypes = [ctypes.c_void_p] * 7
    fn.restype = ctypes.c_int
    ip = (ctypes.c_longlong * 6)(npol, nsamp, nfft, n1, n2, seg_per_sec)
    rc = fn(ctypes.cast(ip, ctypes.c_void_p),
            *(ctypes.c_void_p(t.data_ptr()) for t in (raw, a1, tw, b2, out)),
            ctypes.c_void_p(torch.cuda.current_stream(raw.device)
                            .cuda_stream))
    _build.check(rc, "vf_dft_detect_power", lib)
    LAUNCHES["dft_detect_power"] += 1
    return out


def chain_second_plain_oracle(raw: torch.Tensor, bp: torch.Tensor, nfft: int,
                              npol: int, seg_per_sec: int, nscrunch: int,
                              scale: float, chanmin: int, chanmax: int):
    """Stage B's plain version: dft_detect_oracle's power, then the plain
    stream's back end as the JAX package's _mk_stageB_kernel defines it,
    one spectrum at a time over the channels, in the kernel's order:
    per segment the bandpass seeds where it is 0 from the segment mean
    (row sum in order, times 1/ffts; a mean of 0 seeds 1); per spectrum
    b' = s p + (1 - s) b and p / b' - 1; pscrunch sqrt(1/2) (v0 + v1)
    (none for npol 1); tscrunch the sum of nscrunch in order times
    1/sqrt(nscrunch); QUANT2_THRESH levels packed as sel_and_dig.

    Returns (packed u8 (nseg * nout, (chanmax - chanmin + 1) // 4),
    bandpass f32 (npol, nfft // 2 + 1))."""
    power = dft_detect_oracle(raw, nfft, npol, seg_per_sec)
    nseg, rows, nchan = power.shape
    ffts = rows // npol
    power = power.reshape(nseg, npol, ffts, nchan)
    s, oms = norm_ops.ema_constants(scale)
    rs, ns = norm_ops.recip(ffts), norm_ops.inv_sqrt(nscrunch)
    nout = ffts // nscrunch
    bp = bp.clone()
    ts = torch.empty((nseg * nout, nchan), dtype=torch.float32,
                     device=raw.device)
    one = torch.ones_like(bp)
    for seg in range(nseg):
        p = power[seg]                                   # (npol, ffts, nchan)
        seed = norm_ops._row_sum(p, 0, ffts) * rs
        seed = torch.where(seed == 0.0, one, seed)
        bp = torch.where(bp == 0.0, seed, bp)
        for o in range(nout):
            acc = torch.zeros_like(bp[0])
            for q in range(nscrunch):
                p_t = p[:, o * nscrunch + q]
                bp = s * p_t + oms * bp
                v = p_t / bp - 1.0
                v = norm_ops._SQRT_HALF * (v[0] + v[1]) if npol == 2 else v[0]
                acc = acc + v
            ts[seg * nout + o] = acc * ns
    packed = q_ops.sel_and_dig(ts[None], chanmin, chanmax, 2)
    return packed, bp


def chain_second_plain(raw: torch.Tensor, bp: torch.Tensor, nfft: int,
                       npol: int, seg_per_sec: int, nscrunch: int,
                       scale: float, chanmin: int, chanmax: int):
    """Stage B: one second of the plain (rfi_mode 0) stream through stage
    A's DFT, the EMA bandpass, pscrunch, tscrunch and the 2-bit pack.

    raw u8 (npol, nsamp); bp f32 (npol, nfft // 2 + 1), the carried
    bandpass (0 seeds).  Returns (packed u8 (nseg * nout, (chanmax -
    chanmin + 1) // 4), new bandpass): the JAX package's chain_second_plain
    through unfactor_pack_realign and bp_from_factored."""
    if raw.device.type == "cpu":
        return chain_second_plain_oracle(raw, bp, nfft, npol, seg_per_sec,
                                         nscrunch, scale, chanmin, chanmax)
    _check_stage_args("chain_second_plain", raw, nfft, npol, seg_per_sec)
    nchan = nfft // 2 + 1
    if bp.dtype != torch.float32 or tuple(bp.shape) != (npol, nchan) \
            or not bp.is_contiguous() or bp.device != raw.device:
        raise ValueError(f"chain_second_plain: bp must be contiguous f32 "
                         f"({npol}, {nchan}) on {raw.device}")
    if not 0 <= chanmin <= chanmax < nchan or (chanmax - chanmin + 1) % 4:
        raise ValueError(f"chain_second_plain: channels {chanmin}..{chanmax} "
                         f"must lie in 0..{nchan - 1}, a multiple of 4")
    n1, n2 = ch_ops._ct_split(nfft)
    nsamp = raw.shape[1]
    ffts = nsamp // seg_per_sec // nfft
    if ffts % nscrunch:
        raise ValueError(f"chain_second_plain: nscrunch {nscrunch} must "
                         f"divide {ffts} FFTs per segment")
    dev = raw.device
    power = torch.empty((npol, seg_per_sec * ffts, nchan),
                        dtype=torch.float32, device=dev)
    dagcnt = torch.zeros((seg_per_sec,), dtype=torch.int32, device=dev)
    dag_frac = torch.empty((seg_per_sec,), dtype=torch.float32, device=dev)
    packed = torch.zeros((seg_per_sec * (ffts // nscrunch),
                          (chanmax - chanmin + 1) // 4),
                         dtype=torch.uint8, device=dev)
    bp_out = bp.clone()
    a1, tw, b2 = tc_planes(nfft, dev)
    s, oms = norm_ops.ema_constants(scale)
    # chain.cuh's chain_params with rfi_mode 0 (no front: nkurto = nfft)
    ip = (ctypes.c_longlong * 11)(npol, nsamp, nfft, n1, n2, nfft,
                                  seg_per_sec, nscrunch, 0, chanmin, chanmax)
    fvals = [s, oms, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, norm_ops._SQRT_HALF,
             norm_ops.inv_sqrt(nscrunch), *C.QUANT2_THRESH] + [0.0] * 10
    fp = (ctypes.c_float * len(fvals))(*fvals)
    lib = _build.load("stage_ab")
    fn = lib.vf_chain_second_plain
    fn.argtypes = [ctypes.c_void_p] * 14
    fn.restype = ctypes.c_int
    seeds = _ema_seeds(npol, seg_per_sec, nchan, dev)
    rc = fn(ctypes.cast(ip, ctypes.c_void_p), ctypes.cast(fp, ctypes.c_void_p),
            *(ctypes.c_void_p(t.data_ptr()) for t in
              (raw, a1, tw, b2, bp, power, dagcnt, seeds, dag_frac, packed,
               bp_out)),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(rc, "vf_chain_second_plain", lib)
    LAUNCHES["chain_second_plain"] += 1
    return packed, bp_out


# ---------------------------------------------------------------------------
# The pfb station's WOLA, DFT and detect in one launch (wola_dft_detect_power)
# ---------------------------------------------------------------------------

WOLA_TAPS = (4,)         # the tap counts csrc/wola_tc.cu is built for


def wola_fits(nfft: int, ntap: int) -> bool:
    """Whether wola_dft_detect_power's kernel takes a WOLA of ntap taps
    over frames of nfft: a tap count it is built for (WOLA_TAPS) and a CT
    split whose planes and two frame tiles fit (tc_fits with wola)."""
    if ntap not in WOLA_TAPS:
        return False
    try:
        ch_ops._ct_split(nfft)
    except ValueError:
        return False
    return tc_fits(nfft, wola=True)


def wola_window_tiles(nfft: int, ntap: int, device) -> torch.Tensor:
    """The WOLA window (ch_ops._window) in the order csrc/dft_tc.cuh's WOLA
    loader reads it: f32 (npass, kb1, ntap, 2, 32, 4), entry [h, c, t, eh,
    r, i] = win[t, (8 c + 4 eh + i) n2 + 32 h + r], 0 past n1 and n2, so
    that an item's 8 window loads are aligned 16-byte loads (built once)."""
    key = ("wola", nfft, ntap, str(device))
    if key not in _SPLIT:
        geo = tc_geometry(nfft, wola=True)
        n1, n2 = geo.n1, geo.n2
        win = ch_ops._pfb_window(ntap, nfft).reshape(ntap, n1, n2)
        pad = np.zeros((ntap, 8 * geo.kb1, 32 * geo.npass), np.float32)
        pad[:, :n1, :n2] = win
        # [t, c, eh, i, h, r] -> [h, c, t, eh, r, i]
        tiles = pad.reshape(ntap, geo.kb1, 2, 4, geo.npass, 32).transpose(
            4, 1, 0, 2, 5, 3)
        _SPLIT[key] = torch.from_numpy(np.ascontiguousarray(tiles)).to(
            device)
    return _SPLIT[key]


def wola_split_frames(v: torch.Tensor, tail: torch.Tensor, nfft: int,
                      ntap: int) -> tuple:
    """The kernel's frame tiles: the WOLA frames of [tail, v] (ch_ops.wola
    with a tail), each sample the window's taps summed in f32 in tap order,
    every product and sum rounded (no fused multiply-add), then split as
    _hi_lo.  v (npol, nsamp) u8 raw bytes (converted as
    unpack.convert_uint8) or f32 voltages; tail f32 (npol, (ntap - 1) *
    nfft).  Returns (hi, lo), f32 (npol, nsamp // nfft, nfft) of
    bf16-exact values."""
    win, _ = ch_ops._window(ntap, nfft, v.device)
    x = unpack_ops.convert_uint8(v) if v.dtype == torch.uint8 else v
    npol = x.shape[0]
    ext = torch.cat([tail.reshape(npol, ntap - 1, nfft),
                     x.reshape(npol, -1, nfft)], dim=1)
    n = ext.shape[1] - (ntap - 1)
    f = ext[:, 0:n] * win[0]
    for t in range(1, ntap):
        f = f + ext[:, t:t + n] * win[t]
    return _hi_lo(f)


def wola_masked_frames(w_raw: torch.Tensor, wtail: torch.Tensor,
                       ntap: int) -> tuple:
    """The frames of a second whose taps reach a block the RFI front
    masked in part or whole (raw weight < 1), the carried blocks first:
    w_raw (npol, nspec) the second's raw block weights, wtail (npol, ntap
    - 1) the carried ones.  Every other frame of the masked stream has
    the plain stream's taps exactly (a kept sample is the same voltage),
    so the same bits.  Returns (list, count) on w_raw's device, int32:
    the frames' pol-major indices (p nspec + j) in order in list[:count]
    (list holds npol nspec + 1 entries), without reading the device."""
    w_ext = torch.cat([wtail, w_raw], dim=1) < 1.0
    nspec = w_raw.shape[1]
    hit = w_ext[:, 0:nspec].clone()
    for t in range(1, ntap):
        hit |= w_ext[:, t:t + nspec]
    hit = hit.reshape(-1)
    n = hit.numel()
    pos = torch.cumsum(hit, 0) - 1
    slot = torch.where(hit, pos, torch.full_like(pos, n))
    frames = torch.zeros((n + 1,), dtype=torch.int32, device=w_raw.device)
    frames.scatter_(0, slot, torch.arange(n, dtype=torch.int32,
                                          device=w_raw.device))
    return frames, hit.sum(dtype=torch.int32).reshape(1)


def wola_dft_detect_plain(v: torch.Tensor, tail: torch.Tensor,
                          cfg: PipelineConfig, frames: tuple | None = None,
                          out: torch.Tensor | None = None,
                          chunk: int = 4096) -> torch.Tensor:
    """wola_dft_detect_power's plain version: wola_split_frames, then the
    split-plane DFT with stage 1's third pass and |X|^2 (_split_detect),
    chunk frames at a time.  Same arguments and return."""
    hi, lo = wola_split_frames(v, tail, cfg.nfft, cfg.pfb_ntap)
    npol, nspec, _ = hi.shape
    hi, lo = hi.reshape(npol * nspec, -1), lo.reshape(npol * nspec, -1)
    n1, n2 = ch_ops._ct_split(cfg.nfft)
    power = torch.empty((npol * nspec, cfg.nchan), dtype=torch.float32,
                        device=v.device)
    for i in range(0, npol * nspec, chunk):
        power[i:i + chunk] = _split_detect(
            hi[i:i + chunk].reshape(-1, n1, n2), cfg.nfft,
            lo[i:i + chunk].reshape(-1, n1, n2))
    if frames is None:
        return power.reshape(npol, nspec, cfg.nchan)
    rows = frames[0][:int(frames[1][0])].long()
    out.reshape(npol * nspec, cfg.nchan)[rows] = power[rows]
    return out


def _check_wola_args(v: torch.Tensor, tail: torch.Tensor,
                     cfg: PipelineConfig, frames, out) -> None:
    if v.device.type != "cuda":
        raise ValueError(f"wola_dft_detect_power: unsupported device "
                         f"{v.device}")
    if cfg.channelizer != "pfb" or not wola_fits(cfg.nfft, cfg.pfb_ntap):
        raise ValueError("wola_dft_detect_power: the CUDA kernel takes the "
                         f"pfb channelizer with {WOLA_TAPS} taps and a CT "
                         "split that fits (wola_fits); got channelizer "
                         f"{cfg.channelizer!r}, pfb_ntap {cfg.pfb_ntap}, "
                         f"nfft {cfg.nfft}")
    if v.dtype not in (torch.uint8, torch.float32) or v.dim() != 2 \
            or v.shape[1] % cfg.nfft or not v.is_contiguous():
        raise ValueError(f"wola_dft_detect_power: v must be contiguous uint8 "
                         f"or float32 (npol, k * {cfg.nfft})")
    nt = (cfg.pfb_ntap - 1) * cfg.nfft
    if tail.dtype != torch.float32 or tuple(tail.shape) != (v.shape[0], nt) \
            or not tail.is_contiguous() or tail.device != v.device:
        raise ValueError(f"wola_dft_detect_power: tail must be contiguous "
                         f"float32 ({v.shape[0]}, {nt}) on {v.device}")
    if frames is None:
        return
    shape = (v.shape[0], v.shape[1] // cfg.nfft, cfg.nchan)
    lst, count = frames
    if out is None or out.dtype != torch.float32 or tuple(out.shape) != shape \
            or not out.is_contiguous() or out.device != v.device:
        raise ValueError(f"wola_dft_detect_power: with frames, out must be "
                         f"contiguous float32 {shape} on {v.device}")
    if lst.dtype != torch.int32 or lst.shape != (shape[0] * shape[1] + 1,) \
            or count.dtype != torch.int32 or count.shape != (1,) \
            or lst.device != v.device or count.device != v.device:
        raise ValueError("wola_dft_detect_power: frames must be "
                         "wola_masked_frames' (list, count) on the device")


def wola_dft_detect_power(v: torch.Tensor, tail: torch.Tensor,
                          cfg: PipelineConfig, frames: tuple | None = None,
                          out: torch.Tensor | None = None) -> torch.Tensor:
    """One stream of the pfb channelizer and detect: the WOLA frames of
    [tail, v] (cfg.pfb_ntap taps, cfg.nfft), their DFT at bf16x3 (the
    configuration's dft_precision 'high') and |X|^2.

    v (npol, nsamp): the second's u8 raw bytes or f32 voltages (the RFI
    front's masked ones); tail f32 (npol, (pfb_ntap - 1) * nfft), the
    stream's carried voltages.  Returns power f32 (npol, nsamp // nfft,
    nfft // 2 + 1), linear channels.  With frames (wola_masked_frames'
    list and count) only those rows are computed, into `out`, which is
    returned: the masked stream's other rows are the plain stream's.  A
    CPU tensor takes the plain version; a CUDA one launches
    csrc/wola_tc.cu or raises."""
    if v.device.type == "cpu":
        return wola_dft_detect_plain(v, tail, cfg, frames, out)
    _check_wola_args(v, tail, cfg, frames, out)
    npol, nsamp = v.shape
    n1, n2 = ch_ops._ct_split(cfg.nfft)
    if frames is None:
        out = torch.empty((npol, nsamp // cfg.nfft, cfg.nchan),
                          dtype=torch.float32, device=v.device)
    win = wola_window_tiles(cfg.nfft, cfg.pfb_ntap, v.device)
    a1, tw, b2 = tc_planes(cfg.nfft, v.device)
    lib = _build.load("wola_tc")
    fn = lib.vf_wola_dft_detect_power
    fn.argtypes = [ctypes.c_void_p] * 11
    fn.restype = ctypes.c_int
    ip = (ctypes.c_longlong * 7)(npol, nsamp, cfg.nfft, n1, n2, cfg.pfb_ntap,
                                 int(v.dtype == torch.uint8))
    lst, count = frames if frames is not None else (None, None)
    rc = fn(ctypes.cast(ip, ctypes.c_void_p),
            *(_ptr(t) for t in (v, tail, win, a1, tw, b2, lst, count, out)),
            ctypes.c_void_p(torch.cuda.current_stream(v.device).cuda_stream))
    _build.check(rc, "vf_wola_dft_detect_power", lib)
    LAUNCHES["wola_dft_detect_power"] += 1
    return out
