"""The per-antenna streaming DSP chain on torch tensors.

Port of vlite_fast_tpu/models/baseband_dsp.py (ref
src/process_baseband.cu:334, segment dispatch :1108-1458), flat front and
per-segment path only.  One segment of raw 8-bit voltages goes through

  convert -> [rfi_mode>0] kurtosis + D'Agostino + mask -> channelize
  -> [inject] FRB track multiply -> detect + EMA bandpass [weighted]
  -> pscrunch [+weights] -> tscrunch [+weights] -> trim + quantize + pack

and a second is a loop over its segments, threading the bandpass state.
`process_second` is the armed program that runs in the injection window
after each minute's arm; every other second runs the injection-free twin
(`twin_second`), which on a CUDA device is the fused kernel
ops/megakernel.chain_second_v2.

Config knobs that only pick a TPU implementation (chain_impl,
twin_chain_impl, ema_impl, rfi_impl, front_layout, batch_streams,
dft_exact_input, dft_stage2, dft_precision) are ignored: the EMA here is
sequential and the DFT is f32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vlite_fast_tpu.config import PipelineConfig
from vlite_fast_tpu_torch.ops import channelize as ch_ops
from vlite_fast_tpu_torch.ops import injection as inj_ops
from vlite_fast_tpu_torch.ops import kurtosis as kur_ops
from vlite_fast_tpu_torch.ops import normalize as norm_ops
from vlite_fast_tpu_torch.ops import quantize as q_ops
from vlite_fast_tpu_torch.ops import unpack as unpack_ops


class DSPState(NamedTuple):
    """Carried DSP state."""

    bp: torch.Tensor         # (npol, nchan) plain-stream bandpass
    bp_kur: torch.Tensor     # (npol, nchan) kurtosis-stream bandpass
    segs_since_inject: int   # < 0 means not armed
    tail: torch.Tensor       # (2, npol, 0): the WOLA channelizer's carry
    wtail: torch.Tensor      # (npol, 0): its weight carry (pfb not ported)


class SegmentOutput(NamedTuple):
    packed: torch.Tensor       # (out_samps, nbytes) plain stream
    packed_kur: torch.Tensor   # (out_samps, nbytes) kurtosis stream
    weights: torch.Tensor      # (npol, ffts) kurtosis weights
    dag_frac: torch.Tensor     # scalar: fraction of fine windows flagged


def _check_supported(cfg: PipelineConfig) -> None:
    if cfg.channelizer not in ("matmul", "fft"):
        raise NotImplementedError(
            f"channelizer {cfg.channelizer!r} is not ported yet")
    if cfg.do_histo:
        raise NotImplementedError("do_histo is not ported yet")


def init_state(cfg: PipelineConfig, device="cpu") -> DSPState:
    _check_supported(cfg)
    z = lambda: torch.zeros((cfg.npol_in, cfg.nchan), dtype=torch.float32,
                            device=device)
    return DSPState(
        bp=z(), bp_kur=z(), segs_since_inject=-1,
        tail=torch.zeros((2, cfg.npol_in, 0), device=device),
        wtail=torch.ones((cfg.npol_in, 0), device=device))


def _frb_delays_np(cfg: PipelineConfig) -> np.ndarray:
    return inj_ops.frb_delays(
        cfg.nchan, cfg.inject_dm, cfg.seg_per_sec * cfg.ffts_per_seg,
        freq_top_ghz=cfg.freq_top_mhz / 1e3,
        bandwidth_ghz=cfg.bandwidth_mhz / 1e3)


def _inject_active_limit_segs(cfg: PipelineConfig) -> int:
    """Last segment index (since arming) whose spectra can still lie on
    the injected track."""
    width = cfg.inject_width_s * cfg.seg_per_sec * cfg.ffts_per_seg
    max_d = float(_frb_delays_np(cfg).max())
    return int(np.ceil((max_d + width) / cfg.ffts_per_seg)) + 1


def inject_window_seconds(cfg: PipelineConfig) -> int:
    """Whole seconds (from the arming second, inclusive) during which the
    injected track can still intersect the data; outside them the
    injection multiplies by all-ones, so the twin is byte-exact."""
    return int(np.ceil((_inject_active_limit_segs(cfg) + 1)
                       / cfg.seg_per_sec)) + 1


def megakernel_supported(cfg: PipelineConfig) -> bool:
    """Configs the fused chain kernel (ops/megakernel) accepts: the
    injection-free, 2-bit, single-output-pol chain with the CT DFT."""
    if cfg.inject_frb or cfg.channelizer != "matmul" or cfg.nbit != 2:
        return False
    if cfg.npol_out != 1 or cfg.npol_in not in (1, 2) or cfg.do_histo:
        return False
    try:
        ch_ops._ct_split(cfg.nfft)
    except ValueError:
        return False
    # one frame and its two stage-1 planes live in one block's shared
    # memory (227 KB on Hopper)
    return 3 * 4 * cfg.nfft <= 232448


def _rfi_stage(cfg: PipelineConfig, x: torch.Tensor):
    """(masked voltages, weights, dag_frac) of the RFI front."""
    if cfg.rfi_mode == 0:
        return (x, torch.ones((cfg.npol_in, cfg.ffts_per_seg),
                              dtype=torch.float32, device=x.device),
                torch.zeros((), dtype=torch.float32, device=x.device))
    res = kur_ops.rfi_excise(x, cfg.nkurto, cfg.nfft,
                             dag_thresh=cfg.dag_thresh,
                             dag_fb_thresh=cfg.dag_fb_thresh)
    flagged = (res.dag >= cfg.dag_thresh).to(torch.float32)
    return (res.masked, res.weights,
            flagged.sum() * norm_ops.recip(flagged.numel()))


def process_segment(cfg: PipelineConfig, raw: torch.Tensor,
                    state: DSPState) -> tuple[SegmentOutput, DSPState]:
    """One 1/seg_per_sec-second chunk: raw (npol_in, seg_samps) uint8."""
    x = unpack_ops.convert_uint8(raw)
    x_kur, weights, dag_frac = _rfi_stage(cfg, x)

    def spectra(v):
        return ch_ops.channelize(v, cfg.nfft, method=cfg.channelizer)

    def maybe_inject(spec):
        if not cfg.inject_frb or state.segs_since_inject < 0:
            return spec
        delays = torch.from_numpy(_frb_delays_np(cfg)).to(spec.device)
        width = cfg.inject_width_s * cfg.seg_per_sec * cfg.ffts_per_seg
        return inj_ops.inject_frb(
            spec, delays, state.segs_since_inject * cfg.ffts_per_seg,
            width, cfg.inject_amp)

    scrunch_pols = cfg.npol_out == 1 and cfg.npol_in == 2

    def finish_plain(spec, bp):
        out, bp_new = norm_ops.normalize_ema(norm_ops.detect(spec), bp,
                                             cfg.bp_scale)
        if scrunch_pols:
            out = norm_ops.pscrunch(out)
        out = norm_ops.tscrunch(out, cfg.nscrunch)
        return q_ops.sel_and_dig(out, cfg.chanmin, cfg.chanmax,
                                 cfg.nbit), bp_new

    def finish_kur(spec, bp):
        out, bp_new = norm_ops.normalize_ema_weighted(
            norm_ops.detect(spec), weights, bp, cfg.bp_scale)
        w = weights
        if scrunch_pols:
            out, w = norm_ops.pscrunch_weights(out, w, cfg.min_weight)
        out = norm_ops.tscrunch_weights(out, w, cfg.nscrunch,
                                        cfg.min_weight)
        return q_ops.sel_and_dig(out, cfg.chanmin, cfg.chanmax,
                                 cfg.nbit), bp_new

    bp, bp_kur = state.bp, state.bp_kur
    nbytes = cfg.npol_out * cfg.nchanout * cfg.nbit // 8
    empty = torch.zeros((cfg.out_samps_per_seg, nbytes), dtype=torch.uint8,
                        device=raw.device)
    packed = packed_kur = empty
    if cfg.rfi_mode != 1:
        packed, bp = finish_plain(maybe_inject(spectra(x)), bp)
    if cfg.rfi_mode != 0:
        packed_kur, bp_kur = finish_kur(maybe_inject(spectra(x_kur)),
                                        bp_kur)
    since = state.segs_since_inject
    new_state = state._replace(
        bp=bp, bp_kur=bp_kur,
        segs_since_inject=since + 1 if since >= 0 else since)
    return SegmentOutput(packed, packed_kur, weights, dag_frac), new_state


def run_segments(cfg: PipelineConfig, raw_second: torch.Tensor,
                 state: DSPState) -> tuple[list, DSPState]:
    """process_segment over the second's segments in order."""
    _check_supported(cfg)
    torch.backends.cuda.matmul.allow_tf32 = False   # the DFT stays f32
    segs = raw_second.reshape(cfg.npol_in, cfg.seg_per_sec, cfg.seg_samps)
    outs = []
    for s in range(cfg.seg_per_sec):
        out, state = process_segment(cfg, segs[:, s], state)
        outs.append(out)
    return outs, state


def process_second(cfg: PipelineConfig, raw_second: torch.Tensor,
                   state: DSPState, arm_inject: bool = False
                   ) -> tuple[SegmentOutput, DSPState]:
    """One second through the chain, segment by segment.

    raw_second: (npol_in, sample_rate) uint8; arm_inject starts an FRB at
    the top of this second.  Outputs are concatenated over segments
    (time-major); dag_frac is the mean over segments."""
    if arm_inject:
        state = state._replace(segs_since_inject=0)
    outs, state = run_segments(cfg, raw_second, state)
    return SegmentOutput(
        packed=torch.cat([o.packed for o in outs]),
        packed_kur=torch.cat([o.packed_kur for o in outs]),
        weights=torch.cat([o.weights for o in outs], dim=1),
        dag_frac=torch.stack([o.dag_frac for o in outs]).mean(),
    ), state


def twin_second(cfg: PipelineConfig, raw_second: torch.Tensor,
                state: DSPState, arm_inject: bool = False
                ) -> tuple[SegmentOutput, DSPState]:
    """The injection-free program through ops/megakernel.chain_second_v2:
    the CUDA kernel for a CUDA tensor, its plain version (this module's
    process_second) for a CPU one."""
    from vlite_fast_tpu_torch.ops import megakernel as mk
    since = 0 if arm_inject else state.segs_since_inject
    packed, packed_kur, weights, dag, bp_new = mk.chain_second_v2(
        raw_second, torch.stack([state.bp, state.bp_kur]), cfg)
    new_state = state._replace(
        bp=bp_new[0], bp_kur=bp_new[1],
        segs_since_inject=since + cfg.seg_per_sec if since >= 0 else since)
    return SegmentOutput(packed, packed_kur, weights, dag.mean()), new_state
