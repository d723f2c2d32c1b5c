"""The per-antenna streaming DSP chain on torch tensors.

Port of vlite_fast_tpu/models/baseband_dsp.py (ref
src/process_baseband.cu:334, segment dispatch :1108-1458), flat front
only.  Raw 8-bit voltages go through

  convert -> [rfi_mode>0] kurtosis + D'Agostino + mask -> channelize
  -> [inject] FRB track multiply -> detect + EMA bandpass [weighted]
  -> pscrunch [+weights] -> tscrunch [+weights] -> trim + quantize + pack

With channelizer='pfb' the channelizer is the streaming WOLA polyphase
filterbank: each stream's last (pfb_ntap - 1) * nfft voltages (stream 0
plain, stream 1 RFI-masked) and the last pfb_ntap - 1 raw block weights
are carried in DSPState.tail / wtail and prepended to the next
segment's, so every segment yields ffts_per_seg spectra; the kurtosis
weights become the WOLA window's tap-energy-weighted means
(ops/channelize.pfb_weights).  With do_histo every program also returns
the second's raw-sample histogram per polarization.

`process_second` is the armed program, the JAX package's
ema_impl='pallas', rfi_impl='pallas' program: the front half (convert, the
RFI front kernel ops/rfi_pallas.rfi_front, channelize, inject, detect)
over the whole second, then one launch per stream of the one-pass EMA
kernels (ops/pallas_kernels) with one tile per segment, then the
scrunches and the pack.  `twin_second` is the injection-free program on
the fused chain kernels of ops/megakernel.  Which program serves a
second is decided by `second_program` alone, whose docstring is the one
account of the routing.  `process_second_plain` is the same function
segment by segment on torch ops only, the oracle of all of them;
`reference_chain_numpy` is the JAX package's numpy oracle of the
unweighted chain, copied.

An observation starts from `seed_bandpass`, which has no JAX
counterpart: the zero bandpasses of a fresh state are seeded from the
mean of the first seed_spectra(cfg) spectra (the EMA's own length, 0.25 s
at production), not from each program's first tile of ffts_per_seg (32
at production), whose mean reads every channel ~3% hot at once.  The
programs keep the JAX package's "a zero entry seeds from its tile".

The port reads the JAX package's "on the TPU backend" of
twin_chain_impl='auto' as "on any device": 'auto' gives the v2 chain
kernel wherever it takes the geometry, so the CPU tests go through its
entry point too.  Knobs that only pick a TPU implementation inside a
program (ema_impl, rfi_impl, front_layout, batch_streams,
dft_exact_input, dft_stage2) are ignored: every ema_impl and rfi_impl
gives the sequential EMA's results.  The DFT is f32, except in the v2
chain kernel, which runs the TPU kernels' split-plane bf16 DFT on the
tensor cores whatever dft_precision says, and in process_second's twin
seconds on the pfb channelizer on a card, whose fused WOLA kernel runs it
at bf16x3 where dft_precision is 'high' (as the JAX package's pfb path
computes at dft_precision); both are held to the f32 plain version at
the chain bar.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from vlite_fast_tpu_torch import devices
from vlite_fast_tpu_torch.config import PipelineConfig
from vlite_fast_tpu_torch.ops import channelize as ch_ops
from vlite_fast_tpu_torch.ops import injection as inj_ops
from vlite_fast_tpu_torch.ops import kurtosis as kur_ops
from vlite_fast_tpu_torch.ops import normalize as norm_ops
from vlite_fast_tpu_torch.ops import pallas_kernels as pk
from vlite_fast_tpu_torch.ops import quantize as q_ops
from vlite_fast_tpu_torch.ops import rfi_pallas
from vlite_fast_tpu_torch.ops import unpack as unpack_ops
from vlite_fast_tpu_torch.utils import spans


class DSPState(NamedTuple):
    """Carried DSP state."""

    bp: torch.Tensor         # (npol, nchan) plain-stream bandpass
    bp_kur: torch.Tensor     # (npol, nchan) kurtosis-stream bandpass
    segs_since_inject: int   # < 0 means not armed
    tail: torch.Tensor       # (2, npol, (pfb_ntap-1)*nfft) the WOLA
                             # channelizer's carried voltages, stream 0
                             # plain, stream 1 RFI-masked ((2, npol, 0)
                             # unless channelizer == 'pfb')
    wtail: torch.Tensor      # (npol, pfb_ntap-1) its carried raw block
                             # weights ((npol, 0) unless 'pfb')


class SegmentOutput(NamedTuple):
    packed: torch.Tensor       # (out_samps, nbytes) plain stream
    packed_kur: torch.Tensor   # (out_samps, nbytes) kurtosis stream
    weights: torch.Tensor      # (npol, ffts) kurtosis weights
    dag_frac: torch.Tensor     # scalar: fraction of fine windows flagged
    histo: torch.Tensor = None  # (npol, 256) int32 raw-sample histogram
                                # of the second with do_histo, else
                                # (npol, 0); None from process_segment


def init_state(cfg: PipelineConfig, device="cuda") -> DSPState:
    device = devices.resolve(device)
    z = lambda: torch.zeros((cfg.npol_in, cfg.nchan), dtype=torch.float32,
                            device=device)
    pfb = cfg.channelizer == "pfb"
    ntail = cfg.pfb_ntap - 1 if pfb else 0
    return DSPState(
        bp=z(), bp_kur=z(), segs_since_inject=-1,
        tail=torch.zeros((2, cfg.npol_in, ntail * cfg.nfft), device=device),
        wtail=torch.ones((cfg.npol_in, ntail), device=device))


def seed_spectra(cfg: PipelineConfig) -> int:
    """Spectra a cold bandpass is seeded from (seed_bandpass): the EMA's
    own effective length N = (2 - s) / s, s = cfg.bp_scale, rounded up to
    whole segments and capped at the spectra of one second.

    A seed averaged over n exponential powers reads E[1/seed] = n/(n - 1):
    every channel then normalizes ~1/n hot at once, and the EMA relaxes
    that over ~1/s spectra.  With n >= N the seed's bias, ~1/N, is no
    larger than the EMA's own steady-state bias, ~s/2.  At production s =
    tsamp / 1 s = 7.8125e-4: N = 2559, 80 segments of 32, 2560 spectra
    (0.25 s); in PipelineConfig.tiny() s = 0.002: N = 999, 5 segments of
    200.  Whole segments hold whole FFT blocks and kurtosis windows, so no
    sample is padded."""
    s = cfg.bp_scale
    segs = int(np.ceil((2.0 - s) / s / cfg.ffts_per_seg))
    return min(segs, cfg.seg_per_sec) * cfg.ffts_per_seg


def seed_bandpass(cfg: PipelineConfig, raw_second: torch.Tensor,
                  state: DSPState, front=rfi_pallas.rfi_front) -> DSPState:
    """An observation's first bandpass: each zero entry of state.bp and
    state.bp_kur seeded from the mean of that stream's first
    seed_spectra(cfg) spectra of raw_second (npol_in, sample_rate) uint8;
    a non-zero entry passes through.  Taken once, before the first second
    runs; an entry it leaves at zero (a kurtosis-stream channel of zero
    power, or a stream the configuration does not run) the programs seed
    from their first tile, as before.

    The spectra are the armed program's: the RFI front (`front`:
    rfi_front, the kernel on a card; rfi_pallas.rfi_front_plain gives the
    plain seed it is held against), then `_power` (channelize + detect)
    with injection off, so the seed never sees an injected FRB.  The plain stream's seed
    is the mean power (1 where it is 0); the kurtosis stream's the mean
    of p/w over the spectra with weight w > 0 (1 where there is none), as
    the EMAs seed a tile.  With channelizer='pfb' the first pfb_ntap - 1
    spectra draw on the state's tail (zeros when fresh) and are left out.
    tail, wtail and segs_since_inject pass through, so process_second
    from the result is the JAX package's from the same bandpasses.
    Nothing is read back to the host."""
    torch.backends.cuda.matmul.allow_tf32 = False   # the DFT stays f32
    n = seed_spectra(cfg)
    raw = raw_second[:, :n * cfg.nfft].contiguous()
    skip = cfg.pfb_ntap - 1 if cfg.channelizer == "pfb" else 0
    bp, bp_kur = state.bp, state.bp_kur
    if cfg.rfi_mode != 1:
        p = _power(cfg, unpack_ops.convert_uint8(raw), -1,
                   state.tail[0])[:, skip:]
        seed = p.mean(dim=1)
        seed = torch.where(seed == 0.0, torch.ones_like(seed), seed)
        bp = torch.where(bp == 0.0, seed, bp)
    if cfg.rfi_mode != 0:
        x_kur, weights, _ = front(
            raw, cfg.nkurto, cfg.nfft, dag_thresh=cfg.dag_thresh,
            dag_fb_thresh=cfg.dag_fb_thresh)
        if cfg.channelizer == "pfb":
            weights = ch_ops.pfb_weights(
                torch.cat([state.wtail, weights], dim=1), cfg.pfb_ntap,
                cfg.nfft)
        p = _power(cfg, x_kur, -1, state.tail[1])
        w3 = weights[:, :, None]
        good = w3 > 0.0
        pw = torch.where(good, p / torch.where(good, w3, torch.ones_like(w3)),
                         torch.zeros_like(p))[:, skip:]
        ngood = good[:, skip:].sum(dim=1)
        seed = torch.where(ngood > 0, pw.sum(dim=1) / ngood.clamp(min=1),
                           torch.ones_like(bp_kur))
        bp_kur = torch.where(bp_kur == 0.0, seed, bp_kur)
    return state._replace(bp=bp, bp_kur=bp_kur)


def _histo(cfg: PipelineConfig, raw_second: torch.Tensor) -> torch.Tensor:
    """The second's histogram (do_histo), or its empty stand-in."""
    if cfg.do_histo:
        return kur_ops.sample_histogram(raw_second)
    return torch.zeros((cfg.npol_in, 0), dtype=torch.int32,
                       device=raw_second.device)


def _pfb_carry(cfg: PipelineConfig, x_tail: torch.Tensor,
               kur_tail: torch.Tensor, weights: torch.Tensor,
               state: DSPState) -> tuple:
    """The WOLA carry of a run of contiguous segments: (new tail, new
    wtail, the spectra's weights).  x_tail / kur_tail: the run's last
    (pfb_ntap - 1) * nfft plain and masked voltages; weights its raw
    block weights, whose last pfb_ntap - 1 are carried before the WOLA
    bookkeeping (with the RFI front only)."""
    tail = torch.stack([x_tail, kur_tail])
    if cfg.rfi_mode == 0:
        return tail, state.wtail, weights
    nh = cfg.pfb_ntap - 1
    wtail = weights[:, weights.shape[1] - nh:].clone()
    weights = ch_ops.pfb_weights(torch.cat([state.wtail, weights], dim=1),
                                 cfg.pfb_ntap, cfg.nfft)
    return tail, wtail, weights


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


@functools.lru_cache(maxsize=64)
def _track_spectra(cfg: PipelineConfig) -> tuple[np.ndarray, np.ndarray]:
    """Per channel, the first and last spectrum after the arm that the
    injection multiplies (ops/injection.track_bounds, as inject_frb
    computes them)."""
    width = cfg.inject_width_s * cfg.seg_per_sec * cfg.ffts_per_seg
    lo, hi = inj_ops.track_bounds(torch.from_numpy(_frb_delays_np(cfg)),
                                  width)
    return lo.numpy(), hi.numpy()


def second_injects(cfg: PipelineConfig, since: int) -> bool:
    """Whether the second whose first segment lies `since` segments after
    the arm (< 0: not armed) has a spectrum the injection multiplies by
    something other than 1: some channel's track meets the second's
    spectra [since, since + seg_per_sec) * ffts_per_seg.  A second where
    it is False is an injection-free second; second_program routes by
    it."""
    if not (cfg.inject_frb and since >= 0) or cfg.inject_amp == 1.0:
        return False
    lo, hi = _track_spectra(cfg)
    first = since * cfg.ffts_per_seg
    end = first + cfg.seg_per_sec * cfg.ffts_per_seg
    return bool(((lo < end) & (hi >= first)).any())


MEGAKERNELS = ("megakernel", "megakernel2", "megakernel3", "megakernel3f",
               "megakernel4")
# chain_second's pretranspose for each CT-major-layout chain_impl
_PRETRANSPOSE = {"megakernel": "xla", "megakernel3": "pallas",
                 "megakernel3f": "pallas_bf16"}


def chain_kernel_takes(cfg: PipelineConfig, layout: str = "natural") -> bool:
    """Configs the port's chain kernels (ops/megakernel) accept: the
    injection-free, 2-bit, single-output-pol chain with the CT DFT.  Every
    layout ('natural', chain_second_v2; 'ct', chain_second and
    chain_second_v4 on the CT-major tiles) runs it on the tensor-core DFT,
    which takes CT splits with n1 <= 128, n2 <= 128, n2_out <= 64 whose
    constant planes, frame tile and ring fit a block's shared memory
    (ops/megakernel.tc_fits, for every loader)."""
    from vlite_fast_tpu_torch.ops import megakernel as mk
    if layout not in ("natural", "ct"):
        raise ValueError(f"chain_kernel_takes: layout {layout!r}")
    if cfg.inject_frb or cfg.channelizer != "matmul" or cfg.nbit != 2:
        return False
    if cfg.npol_out != 1 or cfg.npol_in not in (1, 2):
        return False
    try:
        ch_ops._ct_split(cfg.nfft)
    except ValueError:
        return False
    return mk.tc_fits(cfg.nfft)


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
    """chain_impl of the program that serves every second the injected
    track does not reach (the JAX pipeline's `_cfg_noinject`).

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


@functools.lru_cache(maxsize=64)
def _twin_of(cfg: PipelineConfig) -> PipelineConfig | None:
    """twin_config(cfg), or None where resolve_twin_impl refuses it."""
    try:
        return twin_config(cfg)
    except ValueError:
        return None


def second_program(cfg: PipelineConfig, since: int) -> tuple:
    """(kind, program, program_cfg) of the second whose first segment
    lies `since` segments after the arm (< 0: not armed), run as
    program(program_cfg, raw_second, state, arm_inject): the one account
    of the routing, asked by every caller.

    - ("armed", process_second, cfg) where the injected track reaches the
      second (second_injects: the arming second at production; the JAX
      pipeline's wider inject_window_seconds multiplies the seconds past
      the track by all-ones).
    - Otherwise the injection-free twin, resolved per configuration as
      the JAX package resolves it (resolve_twin_impl, twin_config):
      ("twin", twin_second, twin_config(cfg)) for a megakernel
      chain_impl, else ("twin", process_second, twin_config(cfg)); and
      ("twin", process_second, cfg) where the resolution refuses the
      configuration (StationPipeline refuses it at construction; this
      never raises).

    On a CUDA tensor process_second asks it too: a second it gives to
    twin_second goes to the chain kernel (so the sharded array step runs
    the armed program on the arming second alone), and a pfb twin second
    takes the fused WOLA kernel (wola_kernel_takes); CPU tensors keep the
    torch program.  kind names the station's "vfast.{kind}_second" range
    and feed_seconds key.  The programs are looked up on the module at
    each call."""
    if second_injects(cfg, since):
        return "armed", process_second, cfg
    twin = _twin_of(cfg)
    if twin is None:
        return "twin", process_second, cfg
    if twin.chain_impl in MEGAKERNELS:
        return "twin", twin_second, twin
    return "twin", process_second, twin


def _on_card(v: torch.Tensor) -> bool:
    """The device condition of process_second's fused launches: CPU
    tensors keep the torch program."""
    return v.device.type == "cuda"


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


def _power(cfg: PipelineConfig, v: torch.Tensor, since: int,
           tail: torch.Tensor | None = None) -> torch.Tensor:
    """Channelize, inject and detect whole segments of voltages (npol,
    nsamp) -> power f32 (npol, nsamp // nfft, nchan).  `since` counts the
    segments from the arm to the first of them (< 0: not armed);
    spectrum t lies in segment since + t // ffts_per_seg of the track.
    With channelizer='pfb', `tail` is the stream's carried voltages.
    Device stages (spans.stage): "wola" (pfb), "dft", "detect" (with the
    injection)."""
    if cfg.channelizer == "pfb":
        # ch_ops.polyphase_channelize(method="matmul"), by its stages
        spans.stage("wola")
        frames = ch_ops.wola(v, cfg.nfft, cfg.pfb_ntap, tail)
        spans.stage("dft")
        spec = ch_ops.matmul_rfft(frames, cfg.nfft)
        del frames
    else:
        spans.stage("dft")
        spec = ch_ops.channelize(v, cfg.nfft, method=cfg.channelizer)
    spans.stage("detect")
    if cfg.inject_frb and since >= 0:
        delays = torch.from_numpy(_frb_delays_np(cfg)).to(spec.device)
        width = cfg.inject_width_s * cfg.seg_per_sec * cfg.ffts_per_seg
        spec = inj_ops.inject_frb(spec, delays, since * cfg.ffts_per_seg,
                                  width, cfg.inject_amp)
    return norm_ops.detect(spec)


def wola_kernel_takes(cfg: PipelineConfig, v: torch.Tensor) -> bool:
    """Whether process_second takes a twin second's stream power from the
    fused WOLA kernel (ops/megakernel.wola_dft_detect_power) rather than
    `_power`: the pfb channelizer at dft_precision 'high' (the kernel's
    bf16x3; 'highest' keeps the f32 DFT), voltages on a CUDA device and a
    geometry the kernel takes (megakernel.wola_fits).  An armed second
    never does: the injection sits between the DFT and detect."""
    from vlite_fast_tpu_torch.ops import megakernel as mk
    return (cfg.channelizer == "pfb" and cfg.dft_precision == "high"
            and _on_card(v) and mk.wola_fits(cfg.nfft, cfg.pfb_ntap))


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
                    state: DSPState, power=_power
                    ) -> tuple[SegmentOutput, DSPState]:
    """One 1/seg_per_sec-second chunk: raw (npol_in, seg_samps) uint8.
    `power(cfg, voltages, since)` is the channelize + detect stage
    (`_power`, f32; ops/megakernel gives the split-plane DFT's); with
    channelizer='pfb' it also takes the stream's carried voltages."""
    x = unpack_ops.convert_uint8(raw)
    x_kur, weights, dag_frac = _rfi_stage(cfg, x)
    since = state.segs_since_inject
    tail, wtail = state.tail, state.wtail
    if cfg.channelizer == "pfb":
        tl = (cfg.pfb_ntap - 1) * cfg.nfft
        tail, wtail, weights = _pfb_carry(
            cfg, x[:, x.shape[1] - tl:], x_kur[:, x.shape[1] - tl:],
            weights, state)
        spectra = lambda v, s: power(cfg, v, since, state.tail[s])
    else:
        spectra = lambda v, s: power(cfg, v, since)
    bp, bp_kur = state.bp, state.bp_kur
    nbytes = cfg.npol_out * cfg.nchanout * cfg.nbit // 8
    empty = torch.zeros((cfg.out_samps_per_seg, nbytes), dtype=torch.uint8,
                        device=raw.device)
    packed = packed_kur = empty
    if cfg.rfi_mode != 1:
        out, bp = norm_ops.normalize_ema(spectra(x, 0), bp, cfg.bp_scale)
        packed = _finish_stream(cfg, out, None)
    if cfg.rfi_mode != 0:
        out, bp_kur = norm_ops.normalize_ema_weighted(
            spectra(x_kur, 1), weights, bp_kur, cfg.bp_scale)
        packed_kur = _finish_stream(cfg, out, weights)
    new_state = state._replace(
        bp=bp, bp_kur=bp_kur, tail=tail, wtail=wtail,
        segs_since_inject=since + 1 if since >= 0 else since)
    return SegmentOutput(packed, packed_kur, weights, dag_frac), new_state


def run_segments(cfg: PipelineConfig, raw_second: torch.Tensor,
                 state: DSPState, power=_power) -> tuple[list, DSPState]:
    """process_segment over the second's segments in order."""
    torch.backends.cuda.matmul.allow_tf32 = False   # the DFT stays f32
    segs = raw_second.reshape(cfg.npol_in, cfg.seg_per_sec, cfg.seg_samps)
    outs = []
    for s in range(cfg.seg_per_sec):
        out, state = process_segment(cfg, segs[:, s], state, power)
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
        histo=_histo(cfg, raw_second),
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
    per f32 plane, a few GB at the peak of the channelize.  With
    channelizer='pfb' one WOLA runs over [carried tail, whole second]
    per stream (the segments are contiguous, so its spectra are the
    segment-by-segment ones); the masked tail is rfi_front's, and the
    raw block weights are carried before the WOLA bookkeeping.  Its head
    asks second_program: on a CUDA tensor a second it gives to
    twin_second is the twin's chain kernel whole, the state advancing
    alike; in a twin second where wola_kernel_takes, each stream's WOLA,
    DFT and detect are one launch of the fused kernel (stream 0 reading
    the raw bytes), at bf16x3; with both streams, stream 1's computes
    only the frames whose taps reach a block the front masked
    (megakernel.wola_masked_frames) and keeps stream 0's rows elsewhere,
    which are the same bits.

    Device stages of a bound span record (utils/spans; none without
    one): "front" (convert, the RFI front, the WOLA carry), then for each
    stream "wola" (pfb), "dft", "detect", "ema", "pack" (the scrunches
    and sel_and_dig); the fused WOLA kernel's launch is "dft" alone, and
    the twin's chain kernel is "dft" alone for the whole second.  A
    second handed to either fused launch adds 1 to the record's counter
    "fused_seconds"."""
    from vlite_fast_tpu_torch.ops import megakernel as mk
    torch.backends.cuda.matmul.allow_tf32 = False   # the DFT stays f32
    dev = raw_second.device
    since = 0 if arm_inject else state.segs_since_inject
    kind, program, pcfg = second_program(cfg, since)
    if program is twin_second and _on_card(raw_second):
        spans.stage("dft")
        out = program(pcfg, raw_second, state, arm_inject)
        spans.stage(None)
        spans.count("fused_seconds")
        return out
    fused = kind == "twin" and wola_kernel_takes(cfg, raw_second)
    if fused:
        spans.count("fused_seconds")

    def power_of(v: torch.Tensor, s: int, over=None) -> torch.Tensor:
        if fused:
            spans.stage("dft")
            frames = None if over is None else mk.wola_masked_frames(
                w_raw, state.wtail, cfg.pfb_ntap)
            return mk.wola_dft_detect_power(v.contiguous(), state.tail[s],
                                            cfg, frames, over)
        if v.dtype == torch.uint8:
            v = unpack_ops.convert_uint8(v)
        return _power(cfg, v, since, state.tail[s])

    nspec = cfg.seg_per_sec * cfg.ffts_per_seg
    spans.stage("front")
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
    tail, wtail = state.tail, state.wtail
    w_raw = weights
    if cfg.channelizer == "pfb":
        tl = (cfg.pfb_ntap - 1) * cfg.nfft
        x_tail = unpack_ops.convert_uint8(
            raw_second[:, raw_second.shape[1] - tl:])
        kur_tail = x_kur[:, x_kur.shape[1] - tl:] if cfg.rfi_mode > 0 \
            else x_tail
        tail, wtail, weights = _pfb_carry(cfg, x_tail, kur_tail, weights,
                                          state)
    plain_power = None
    tt = cfg.ffts_per_seg        # one tile per segment: per-segment seeds
    if cfg.rfi_mode != 1:
        power = power_of(raw_second, 0)
        spans.stage("ema")
        out, bp = pk.normalize_ema_pallas(power, bp, cfg.bp_scale,
                                          time_tile=tt)
        # the fused kernel computes the masked stream only in the frames
        # whose taps reach a masked block, over the plain stream's rows
        plain_power = power if fused and cfg.rfi_mode == 2 else None
        del power
        spans.stage("pack")
        packed = _finish_stream(cfg, out, None)
    if cfg.rfi_mode != 0:
        power = power_of(x_kur, 1, plain_power)
        del x_kur, plain_power
        spans.stage("ema")
        out, bp_kur = pk.normalize_ema_weighted_pallas(
            power, weights, bp_kur, cfg.bp_scale, time_tile=tt)
        del power
        spans.stage("pack")
        packed_kur = _finish_stream(cfg, out, weights)
    spans.stage(None)
    new_state = state._replace(
        bp=bp, bp_kur=bp_kur, tail=tail, wtail=wtail,
        segs_since_inject=since + cfg.seg_per_sec if since >= 0 else since)
    return SegmentOutput(packed, packed_kur, weights, dag_frac,
                         _histo(cfg, raw_second)), new_state


def twin_second(cfg: PipelineConfig, raw_second: torch.Tensor,
                state: DSPState, arm_inject: bool = False
                ) -> tuple[SegmentOutput, DSPState]:
    """The injection-free program on the fused chain kernel that
    cfg.chain_impl names ('megakernel2', and any value that is not a
    megakernel, the v2 kernel; see the module docstring): the CUDA kernel
    for a CUDA tensor, the plain version (this module's run_segments) for
    a CPU one.  The state is the natural DSPState of every program:
    the bandpasses come back from the kernel, segs_since_inject advances
    by seg_per_sec, the channelizer tails pass through.  With do_histo
    the second's histogram is computed beside the kernel.  It marks no
    device stage (utils/spans): on a card it is one launch, and its
    plain version's segments are not the stages of a second."""
    from vlite_fast_tpu_torch.ops import megakernel as mk
    since = 0 if arm_inject else state.segs_since_inject
    bp = torch.stack([state.bp, state.bp_kur])
    impl = cfg.chain_impl
    with spans.bound(None):
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
    return SegmentOutput(packed, packed_kur, weights, dag.mean(),
                         _histo(cfg, raw_second)), new_state


def reference_chain_numpy(cfg: PipelineConfig, raw: np.ndarray,
                          bp_in: np.ndarray | None = None) -> dict:
    """Slow, direct numpy oracle of the *unweighted* chain for tests:
    convert -> rfft -> |.|^2 -> EMA bandpass -> pscrunch -> tscrunch ->
    quantize levels (unpacked).  Mirrors the same math as process_segment
    with rfi_mode=0 for flag-free data."""
    npol, nsamp = raw.shape
    x = raw.astype(np.float32) / 128.0 - 1.0
    x[raw == 0] = 0.0
    spec = np.fft.rfft(x.reshape(npol, -1, cfg.nfft), axis=-1)
    p = (spec.real ** 2 + spec.imag ** 2).astype(np.float32)
    ntime = p.shape[1]
    bp = np.zeros((npol, cfg.nchan), np.float32) if bp_in is None \
        else bp_in.copy()
    out = np.empty_like(p)
    seg = cfg.ffts_per_seg
    for s in range(0, ntime, seg):
        blk = p[:, s:s + seg]
        mask = bp == 0.0
        bp[mask] = np.mean(blk, axis=1)[mask]
        for t in range(blk.shape[1]):
            bp = (cfg.bp_scale * blk[:, t]
                  + (1 - cfg.bp_scale) * bp).astype(np.float32)
            out[:, s + t] = blk[:, t] / bp - 1.0
    if cfg.npol_out == 1 and npol == 2:
        out = (np.sqrt(np.float32(0.5)) * (out[0] + out[1]))[None]
    ns = cfg.nscrunch
    out = out.reshape(out.shape[0], -1, ns, cfg.nchan).sum(2) * np.float32(
        1.0 / np.sqrt(ns))
    trimmed = out[:, :, cfg.chanmin:cfg.chanmax + 1]
    return {"power": p, "normalized": out, "trimmed": trimmed, "bp": bp}
