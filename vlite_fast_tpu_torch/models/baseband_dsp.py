"""The per-antenna streaming DSP chain on torch tensors.

Port of vlite_fast_tpu/models/baseband_dsp.py (ref
src/process_baseband.cu:334, segment dispatch :1108-1458), flat front
only.  Raw 8-bit voltages go through

  convert -> [rfi_mode>0] kurtosis + D'Agostino + mask -> channelize
  -> [inject] FRB track multiply -> detect + EMA bandpass [weighted]
  -> pscrunch [+weights] -> tscrunch [+weights] -> trim + quantize + pack

`process_second` is the armed program, the JAX package's
ema_impl='pallas', rfi_impl='pallas' program: the front half (convert, the
RFI front kernel ops/rfi_pallas.rfi_front, channelize, inject, detect)
over the whole second, then one launch per stream of the one-pass EMA
kernels (ops/pallas_kernels) with one tile per segment, then the
scrunches and the pack.  It serves the injection window after each
minute's arm.  Every other second runs the injection-free twin, resolved
once per configuration from chain_impl and twin_chain_impl as the JAX
package resolves them (`resolve_twin_impl`, `twin_config`,
`twin_program`): 'xla' is `process_second` with injection off, and the
megakernel values are `twin_second` on the fused chain kernels of
ops/megakernel ('megakernel2' chain_second_v2; 'megakernel',
'megakernel3', 'megakernel3f' chain_second with pretranspose 'xla',
'pallas', 'pallas_bf16'; 'megakernel4' chain_second_v4).
`process_second_plain` is the same function segment by segment on torch
ops only, the oracle of all of them.

The port reads the JAX package's "on the TPU backend" of
twin_chain_impl='auto' as "on any device": 'auto' gives the v2 chain
kernel wherever it takes the geometry, so the CPU tests go through its
entry point too.  Knobs that only pick a TPU implementation inside a
program (ema_impl, rfi_impl, front_layout, batch_streams,
dft_exact_input, dft_stage2, dft_precision) are ignored: every ema_impl
and rfi_impl gives the sequential EMA's results, and the DFT is f32.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from vlite_fast_tpu.config import PipelineConfig
from vlite_fast_tpu_torch.ops import channelize as ch_ops
from vlite_fast_tpu_torch.ops import injection as inj_ops
from vlite_fast_tpu_torch.ops import kurtosis as kur_ops
from vlite_fast_tpu_torch.ops import normalize as norm_ops
from vlite_fast_tpu_torch.ops import pallas_kernels as pk
from vlite_fast_tpu_torch.ops import quantize as q_ops
from vlite_fast_tpu_torch.ops import rfi_pallas
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


MEGAKERNELS = ("megakernel", "megakernel2", "megakernel3", "megakernel3f",
               "megakernel4")
# chain_second's pretranspose for each CT-major-layout chain_impl
_PRETRANSPOSE = {"megakernel": "xla", "megakernel3": "pallas",
                 "megakernel3f": "pallas_bf16"}


def chain_kernel_takes(cfg: PipelineConfig, layout: str = "natural") -> bool:
    """Configs the port's chain kernels (ops/megakernel) accept: the
    injection-free, 2-bit, single-output-pol chain with the CT DFT, one
    frame and its two stage-1 planes in one block's shared memory (227 KB
    on Hopper); the CT-major layout ('ct') also needs both CT factors
    within its 128 x 128 tile."""
    if cfg.inject_frb or cfg.channelizer != "matmul" or cfg.nbit != 2:
        return False
    if cfg.npol_out != 1 or cfg.npol_in not in (1, 2) or cfg.do_histo:
        return False
    try:
        n1, n2 = ch_ops._ct_split(cfg.nfft)
    except ValueError:
        return False
    if layout == "ct" and (n1 > 128 or n2 > 128):
        return False
    return 3 * 4 * cfg.nfft <= 232448


def megakernel_supported(cfg: PipelineConfig) -> bool:
    """The JAX package's gate for chain_impl = cfg.chain_impl
    (vlite_fast_tpu/models/baseband_dsp.megakernel_supported): the
    injection-free 2-bit chain on a CT split within one 128-lane tile;
    with the RFI front, kurtosis windows of whole m1 rows (nkurto % n2 ==
    0), as powers of two dividing n1 for 'megakernel2' and at most 32
    windows per frame for the others."""
    if cfg.inject_frb or cfg.channelizer != "matmul" or cfg.nbit != 2:
        return False
    if cfg.npol_out != 1 or cfg.npol_in not in (1, 2):
        return False
    n1, n2 = ch_ops._ct_split(cfg.nfft)
    n2_out = cfg.nfft // 2 // n1 + 1
    if n1 > 128 or n2 > 128 or 2 * n2_out > 128 or n1 % 4:
        return False
    if cfg.rfi_mode > 0:
        if cfg.nkurto % n2 or cfg.nfft % cfg.nkurto:
            return False
        rw = cfg.nkurto // n2
        if cfg.chain_impl == "megakernel2":
            if n1 % rw or rw & (rw - 1):
                return False
        elif n1 // rw > 32:
            return False
    return True


def resolve_twin_impl(cfg: PipelineConfig) -> str:
    """chain_impl of the program that serves every second outside the
    armed window (the JAX pipeline's `_cfg_noinject`).

    With injection, the JAX package's resolve_twin_impl: 'same' mirrors
    chain_impl, an explicit value is taken as it is, and 'auto' gives
    'megakernel2' where the v2 chain kernel takes the geometry (on any
    device, see the module docstring), else chain_impl.  Without
    injection there is no armed program and chain_impl governs every
    second, as in the JAX pipeline; only 'auto' with the default
    chain_impl='xla' takes the v2 kernel's reading.

    Raises ValueError where the JAX package raises: a megakernel
    chain_impl with injection (the armed program cannot be one), and a
    megakernel value whose gate (megakernel_supported) refuses the
    configuration."""
    if cfg.inject_frb and cfg.chain_impl in MEGAKERNELS:
        raise ValueError(
            f"chain_impl={cfg.chain_impl!r} cannot run the armed program "
            "(inject_frb=True); choose the twin with twin_chain_impl")
    t = cfg.twin_chain_impl
    cfg0 = dataclasses.replace(cfg, inject_frb=False)
    if t == "auto" and cfg.chain_impl == "xla":
        return "megakernel2" if chain_kernel_takes(cfg0) else "xla"
    if not cfg.inject_frb or t in ("same", "auto"):
        impl = cfg.chain_impl
    else:
        impl = t
    if impl in MEGAKERNELS and not megakernel_supported(
            dataclasses.replace(cfg0, chain_impl=impl)):
        raise ValueError(
            f"chain_impl={impl!r} unsupported for this config (channelizer, "
            "nbit, npol, CT geometry or kurtosis windows); see "
            "baseband_dsp.megakernel_supported")
    return impl


def twin_config(cfg: PipelineConfig) -> PipelineConfig:
    """The configuration the twin program runs: injection off, chain_impl
    resolved (resolve_twin_impl, which raises on what it refuses)."""
    return dataclasses.replace(cfg, inject_frb=False,
                               chain_impl=resolve_twin_impl(cfg))


def twin_program(cfg: PipelineConfig):
    """The program of the seconds outside the armed window, to be called
    with twin_config(cfg): `twin_second` for a megakernel chain_impl,
    else `process_second`."""
    if resolve_twin_impl(cfg) in MEGAKERNELS:
        return twin_second
    return process_second


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


def _power(cfg: PipelineConfig, v: torch.Tensor, since: int
           ) -> torch.Tensor:
    """Channelize, inject and detect whole segments of voltages (npol,
    nsamp) -> power f32 (npol, nsamp // nfft, nchan).  `since` counts the
    segments from the arm to the first of them (< 0: not armed);
    spectrum t lies in segment since + t // ffts_per_seg of the track."""
    spec = ch_ops.channelize(v, cfg.nfft, method=cfg.channelizer)
    if cfg.inject_frb and since >= 0:
        delays = torch.from_numpy(_frb_delays_np(cfg)).to(spec.device)
        width = cfg.inject_width_s * cfg.seg_per_sec * cfg.ffts_per_seg
        spec = inj_ops.inject_frb(spec, delays, since * cfg.ffts_per_seg,
                                  width, cfg.inject_amp)
    return norm_ops.detect(spec)


def _finish_stream(cfg: PipelineConfig, out: torch.Tensor,
                   weights: torch.Tensor | None) -> torch.Tensor:
    """Back half of the chain: pscrunch -> tscrunch -> trim + quantize +
    pack (the weighted scrunches when weights are given)."""
    scrunch_pols = cfg.npol_out == 1 and cfg.npol_in == 2
    if weights is None:
        if scrunch_pols:
            out = norm_ops.pscrunch(out)
        out = norm_ops.tscrunch(out, cfg.nscrunch)
    else:
        w = weights
        if scrunch_pols:
            out, w = norm_ops.pscrunch_weights(out, w, cfg.min_weight)
        out = norm_ops.tscrunch_weights(out, w, cfg.nscrunch,
                                        cfg.min_weight)
    return q_ops.sel_and_dig(out, cfg.chanmin, cfg.chanmax, cfg.nbit)


def process_segment(cfg: PipelineConfig, raw: torch.Tensor,
                    state: DSPState) -> tuple[SegmentOutput, DSPState]:
    """One 1/seg_per_sec-second chunk: raw (npol_in, seg_samps) uint8."""
    x = unpack_ops.convert_uint8(raw)
    x_kur, weights, dag_frac = _rfi_stage(cfg, x)
    since = state.segs_since_inject
    bp, bp_kur = state.bp, state.bp_kur
    nbytes = cfg.npol_out * cfg.nchanout * cfg.nbit // 8
    empty = torch.zeros((cfg.out_samps_per_seg, nbytes), dtype=torch.uint8,
                        device=raw.device)
    packed = packed_kur = empty
    if cfg.rfi_mode != 1:
        out, bp = norm_ops.normalize_ema(_power(cfg, x, since), bp,
                                         cfg.bp_scale)
        packed = _finish_stream(cfg, out, None)
    if cfg.rfi_mode != 0:
        out, bp_kur = norm_ops.normalize_ema_weighted(
            _power(cfg, x_kur, since), weights, bp_kur, cfg.bp_scale)
        packed_kur = _finish_stream(cfg, out, weights)
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


def process_second_plain(cfg: PipelineConfig, raw_second: torch.Tensor,
                         state: DSPState, arm_inject: bool = False
                         ) -> tuple[SegmentOutput, DSPState]:
    """process_second segment by segment on torch ops only (the plain
    composition the kernel path is held against)."""
    if arm_inject:
        state = state._replace(segs_since_inject=0)
    outs, state = run_segments(cfg, raw_second, state)
    return SegmentOutput(
        packed=torch.cat([o.packed for o in outs]),
        packed_kur=torch.cat([o.packed_kur for o in outs]),
        weights=torch.cat([o.weights for o in outs], dim=1),
        dag_frac=torch.stack([o.dag_frac for o in outs]).mean(),
    ), state


def process_second(cfg: PipelineConfig, raw_second: torch.Tensor,
                   state: DSPState, arm_inject: bool = False
                   ) -> tuple[SegmentOutput, DSPState]:
    """One second through the chain (the JAX package's ema_impl='pallas',
    rfi_impl='pallas' program).

    raw_second: (npol_in, sample_rate) uint8; arm_inject starts an FRB at
    the top of this second.  Outputs are time-major over the second;
    dag_frac is the mean of the segments' flagged fractions.  The whole
    second's voltages and powers are held at once: at production ~1 GB
    per f32 plane, a few GB at the peak of the channelize."""
    _check_supported(cfg)
    torch.backends.cuda.matmul.allow_tf32 = False   # the DFT stays f32
    dev = raw_second.device
    since = 0 if arm_inject else state.segs_since_inject
    nspec = cfg.seg_per_sec * cfg.ffts_per_seg
    if cfg.rfi_mode > 0:
        x_kur, weights, dag = rfi_pallas.rfi_front(
            raw_second, cfg.nkurto, cfg.nfft, dag_thresh=cfg.dag_thresh,
            dag_fb_thresh=cfg.dag_fb_thresh)
        flags = (dag >= cfg.dag_thresh).to(torch.float32).reshape(
            cfg.seg_per_sec, cfg.nwin_per_seg)
        dag_frac = (flags.sum(dim=1) * norm_ops.recip(cfg.nwin_per_seg)
                    ).mean()
    else:
        weights = torch.ones((cfg.npol_in, nspec), dtype=torch.float32,
                             device=dev)
        dag_frac = torch.zeros((), dtype=torch.float32, device=dev)
    nbytes = cfg.npol_out * cfg.nchanout * cfg.nbit // 8
    packed = packed_kur = torch.zeros(
        (cfg.seg_per_sec * cfg.out_samps_per_seg, nbytes),
        dtype=torch.uint8, device=dev)
    bp, bp_kur = state.bp, state.bp_kur
    tt = cfg.ffts_per_seg        # one tile per segment: per-segment seeds
    if cfg.rfi_mode != 1:
        power = _power(cfg, unpack_ops.convert_uint8(raw_second), since)
        out, bp = pk.normalize_ema_pallas(power, bp, cfg.bp_scale,
                                          time_tile=tt)
        del power
        packed = _finish_stream(cfg, out, None)
    if cfg.rfi_mode != 0:
        power = _power(cfg, x_kur, since)
        del x_kur
        out, bp_kur = pk.normalize_ema_weighted_pallas(
            power, weights, bp_kur, cfg.bp_scale, time_tile=tt)
        del power
        packed_kur = _finish_stream(cfg, out, weights)
    new_state = state._replace(
        bp=bp, bp_kur=bp_kur,
        segs_since_inject=since + cfg.seg_per_sec if since >= 0 else since)
    return SegmentOutput(packed, packed_kur, weights, dag_frac), new_state


def twin_second(cfg: PipelineConfig, raw_second: torch.Tensor,
                state: DSPState, arm_inject: bool = False
                ) -> tuple[SegmentOutput, DSPState]:
    """The injection-free program on the fused chain kernel that
    cfg.chain_impl names ('megakernel2', and any value that is not a
    megakernel, the v2 kernel; see the module docstring): the CUDA kernel
    for a CUDA tensor, the plain version (this module's run_segments) for
    a CPU one.  The state is the natural DSPState of every program:
    the bandpasses come back from the kernel, segs_since_inject advances
    by seg_per_sec, the channelizer tails pass through."""
    from vlite_fast_tpu_torch.ops import megakernel as mk
    since = 0 if arm_inject else state.segs_since_inject
    bp = torch.stack([state.bp, state.bp_kur])
    impl = cfg.chain_impl
    if impl == "megakernel4":
        out = mk.chain_second_v4(raw_second, bp, cfg, pre_dtype="u8",
                                 pre_impl="xlu")
    elif impl in _PRETRANSPOSE:
        out = mk.chain_second(raw_second, bp, cfg,
                              pretranspose=_PRETRANSPOSE[impl])
    else:
        out = mk.chain_second_v2(raw_second, bp, cfg)
    packed, packed_kur, weights, dag, bp_new = out
    new_state = state._replace(
        bp=bp_new[0], bp_kur=bp_new[1],
        segs_since_inject=since + cfg.seg_per_sec if since >= 0 else since)
    return SegmentOutput(packed, packed_kur, weights, dag.mean()), new_state
