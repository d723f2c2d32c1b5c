"""The fused DSP chain for one second: CUDA kernels + plain versions.

Replaces four TPU kernels of vlite_fast_tpu/ops/megakernel.py, all on
the injection-free twin:

  chain_second_v2      (body _full_kernel_v2) on the raw second:
                       csrc/chain.cu, layout 0;
  pallas_pretranspose  (body _pretranspose_kernel) the Cooley-Tukey-major
                       relayout, u8 bytes or bf16 converted voltages:
                       csrc/pretranspose.cu;
  chain_second         (body _full_kernel) on those CT-major tiles:
                       csrc/chain.cu, layouts 1 (u8) and 2 (bf16);
  chain_second_v4      (body _full_kernel_v4) the same with both DFT
                       stages batched: csrc/chain_v4.cu.

The three chains compute one function (a front, a Cooley-Tukey DFT, an
EMA/back-end launch on the current stream).  On the card they are bound
by the DFT's f32 FMA work (~0.36 TFLOP per data-second, on CUDA cores)
and by the EMA's walk through 10240 spectra in order; chain.cu keeps
each frame and its stage-1 planes in shared memory, chain_v4.cu passes a
complex intermediate between two batched passes.  The source headers
have the details.

They work in the natural layout: raw (npol, nsamp) u8 and bandpass
(2, npol, nchan) [plain; kur] in, packed sel_and_dig rows out.  The TPU
kernels' factored planes and their helpers (bp_to/from_factored[_v2],
unfactor_pack_realign[_v2]) are TPU layout and have no counterpart here;
`pretranspose_u8` is XLA in the reference and stays torch.

Dispatch: a CPU tensor goes to the plain version (for the chains the
port's baseband_dsp.process_second_plain with injection off, one
function for all three); a CUDA tensor launches the kernel or raises.
LAUNCHES counts kernel launches per wrapper.
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
from vlite_fast_tpu_torch.ops import unpack as unpack_ops

LAUNCHES = {"chain_second_v2": 0, "pallas_pretranspose": 0,
            "chain_second": 0, "chain_second_v4": 0}
LANE = 128               # the CT-major tile is LANE x LANE
PRETRANSPOSE = ("xla", "pallas", "pallas_bf16")
# intermediate scratch of chain_second_v4 per launch chunk
V4_CHUNK_BYTES = 256 * 2 ** 20

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


# the three chain kernels compute one function, so they share one plain
# version (the names follow the kernels; `chain_second_plain` is another
# TPU kernel's, the Stage-B chain)
chain_second_ct_plain = chain_second_v2_plain
chain_second_v4_plain = chain_second_v2_plain


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
    if raw.device.type == "cpu":
        return pallas_pretranspose_plain(raw, nfft, npol, seg_per_sec,
                                         out_dtype)
    if raw.device.type != "cuda":
        raise ValueError(f"pallas_pretranspose: unsupported device "
                         f"{raw.device}")
    if out_dtype not in (torch.uint8, torch.bfloat16):
        raise ValueError(f"pallas_pretranspose: out_dtype {out_dtype}")
    n1, n2 = ch_ops._ct_split(nfft)
    if n1 > LANE or n2 > LANE:
        raise ValueError(f"pallas_pretranspose: CT factors {n1}x{n2} exceed "
                         f"the {LANE}x{LANE} tile")
    nsamp = raw.shape[-1]
    if raw.dtype != torch.uint8 or raw.dim() != 2 or raw.shape[0] != npol \
            or nsamp % (seg_per_sec * nfft) or not raw.is_contiguous():
        raise ValueError(f"raw must be contiguous uint8 ({npol}, k * "
                         f"{seg_per_sec * nfft})")
    ffts = nsamp // seg_per_sec // nfft
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


def _launch_chain(lib_name: str, fn_name: str, inp: torch.Tensor,
                  layout: int, bp: torch.Tensor, cfg: PipelineConfig,
                  chunk: int = 0):
    """Allocate the outputs and scratch and launch csrc/<lib_name>.cu's
    `fn_name` on `inp` in input layout `layout` (0 natural u8, 1 CT-major
    u8, 2 CT-major bf16); chunk > 0 adds chain_v4's intermediate for
    `chunk` segments per pass."""
    lib = _build.load(lib_name)
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.c_void_p] * (17 if chunk else 16)
    fn.restype = ctypes.c_int
    dev = bp.device
    npol = cfg.npol_in
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
    ivals = [npol, cfg.sample_rate, cfg.nfft, n1, n2, cfg.nkurto,
             cfg.seg_per_sec, cfg.nscrunch, cfg.rfi_mode, cfg.chanmin,
             cfg.chanmax, layout]
    scratch = []
    if chunk:
        ivals.append(chunk)
        scratch.append(torch.empty(
            (nstreams, chunk * npol * cfg.ffts_per_seg, n1, n2, 2),
            dtype=torch.float32, device=dev))
    ip = (ctypes.c_longlong * len(ivals))(*ivals)
    fvals = [s, oms, cfg.dag_thresh, cfg.dag_fb_thresh, C.DAG_INF,
             C.BP_CLIP_RATIO, C.BP_CLIP_VALUE, cfg.min_weight,
             norm_ops._SQRT_HALF, norm_ops.inv_sqrt(cfg.nscrunch),
             *C.QUANT2_THRESH, *kur_ops.dag_consts(cfg.nkurto),
             *kur_ops.dag_consts(cfg.nfft)]
    fp = (ctypes.c_float * len(fvals))(*fvals)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in
            (inp, w1, tw, w2, bp, power, keep, dagcnt, *scratch, packed,
             packed_kur, weights, dag_frac, bp_out)]
    rc = fn(ctypes.cast(ip, ctypes.c_void_p), ctypes.cast(fp, ctypes.c_void_p),
            *ptrs, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(rc, fn_name, lib)
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
    out = _launch_chain("chain", "vf_chain_second", raw, 0, bp, cfg)
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
    out = _launch_chain("chain", "vf_chain_second", xs, layout, bp, cfg)
    LAUNCHES["chain_second"] += 1
    return out


def chain_second_v4(raw: torch.Tensor, bp: torch.Tensor, cfg: PipelineConfig,
                    pre_dtype: str = "u8", pre_impl: str = "mxu"):
    """chain_second with both DFT stages batched, on pallas_pretranspose's
    tiles (pre_dtype 'u8' or 'bf16').  pre_impl ('mxu' | 'xlu') picks the
    TPU's transpose engine, which gives identical bytes either way; it is
    checked and has no other effect here.  Same arguments and returns as
    chain_second_v2."""
    if pre_dtype not in ("u8", "bf16") or pre_impl not in ("mxu", "xlu"):
        raise ValueError(f"chain_second_v4: pre_dtype {pre_dtype!r}, "
                         f"pre_impl {pre_impl!r}")
    if raw.device.type == "cpu":
        return chain_second_v4_plain(raw, bp, cfg)
    _check_chain_args("chain_second_v4", raw, bp, cfg, "ct")
    bf16 = pre_dtype == "bf16"
    xs = pallas_pretranspose(raw, cfg.nfft, cfg.npol_in, cfg.seg_per_sec,
                             torch.bfloat16 if bf16 else torch.uint8)
    n1, n2 = ch_ops._ct_split(cfg.nfft)
    seg_bytes = (2 if cfg.rfi_mode == 2 else 1) * cfg.npol_in \
        * cfg.ffts_per_seg * n1 * n2 * 8
    chunk = max(1, min(cfg.seg_per_sec, V4_CHUNK_BYTES // seg_bytes))
    out = _launch_chain("chain_v4", "vf_chain_second_v4", xs,
                        2 if bf16 else 1, bp, cfg, chunk=chunk)
    LAUNCHES["chain_second_v4"] += 1
    return out
