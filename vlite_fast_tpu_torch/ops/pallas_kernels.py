"""The one-pass EMA bandpass kernels: CUDA kernels + plain versions.

Replace the TPU kernels vlite_fast_tpu/ops/pallas_kernels.py:
normalize_ema_pallas (body _ema_kernel) and normalize_ema_weighted_pallas
(body _ema_weighted_kernel).  The armed program (models/baseband_dsp.
process_second) runs each once per stream per second over the whole
second's power, with time_tile = ffts_per_seg.  The CUDA source is
csrc/ema.cu: one thread per (pol, channel) walking time, the bandpass in
a register across the time tiles; it is bound by load latency (the
recurrence leaves npol x nchan threads, 12.5k at production).  The
source header has the details.

Dispatch: a CPU tensor goes to the plain version (ops/normalize's
sequential EMA with the same time tiles); a CUDA tensor launches the
kernel or raises.  LAUNCHES counts kernel launches per wrapper.

The JAX kernels take TPU tiling knobs (chan_tile, and time_tile rounded
to a multiple of 8 on the TPU); here time_tile is only semantics.  One
difference from the JAX unweighted kernel, which follows the JAX
package's 'scan' EMA instead: a tile whose mean power is 0 seeds a zero
bandpass with 1, not 0 (the TPU kernel divides 0/0 there).
"""

from __future__ import annotations

import ctypes

import torch

from vlite_fast_tpu import constants as C
from vlite_fast_tpu_torch import _build
from vlite_fast_tpu_torch.ops import normalize as norm_ops

LAUNCHES = {"normalize_ema_pallas": 0, "normalize_ema_weighted_pallas": 0}


def _f32(name: str, t: torch.Tensor, shape: tuple, dev) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != shape \
            or not t.is_contiguous() or t.device != dev:
        raise ValueError(f"{name} must be contiguous f32 {shape} on {dev}")


def _launch(fn_name: str, power: torch.Tensor, bp: torch.Tensor,
            scale: float, time_tile: int, tensors: list,
            clip: tuple = (0.0, 0.0)):
    """Check the shared arguments, allocate the outputs and launch
    csrc/ema.cu's `fn_name` on the current stream."""
    if power.device.type != "cuda":
        raise ValueError(f"{fn_name}: unsupported device {power.device}")
    npol, ntime, nchan = power.shape
    if ntime == 0:
        raise ValueError(f"{fn_name}: no spectra")
    _f32("power", power, (npol, ntime, nchan), power.device)
    _f32("bp", bp, (npol, nchan), power.device)
    tt = norm_ops.tile_rows(ntime, time_tile)
    s, oms = norm_ops.ema_constants(scale)
    out = torch.empty_like(power)
    bp_out = torch.empty_like(bp)
    lib = _build.load("ema")
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.c_void_p] * (7 + len(tensors))
    fn.restype = ctypes.c_int
    ip = (ctypes.c_longlong * 4)(npol, ntime, nchan, tt)
    fp = (ctypes.c_float * 5)(s, oms, norm_ops.recip(tt), *clip)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in
            (power, *tensors, bp, out, bp_out)]
    rc = fn(ctypes.cast(ip, ctypes.c_void_p), ctypes.cast(fp, ctypes.c_void_p),
            *ptrs,
            ctypes.c_void_p(torch.cuda.current_stream(power.device)
                            .cuda_stream))
    _build.check(rc, fn_name, lib)
    return out, bp_out


def normalize_ema_pallas(power: torch.Tensor, bp: torch.Tensor,
                         scale: float, time_tile: int = 0
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """ops/normalize.normalize_ema in one launch.

    power: f32 (npol, ntime, nchan); bp: f32 (npol, nchan), 0 = seed.
    Returns (p/bp - 1, new bp)."""
    if power.device.type == "cpu":
        return norm_ops.normalize_ema(power, bp, scale, time_tile)
    out = _launch("vf_ema", power, bp, scale, time_tile, [])
    LAUNCHES["normalize_ema_pallas"] += 1
    return out


def normalize_ema_weighted_pallas(power: torch.Tensor,
                                  weights: torch.Tensor, bp: torch.Tensor,
                                  scale: float,
                                  clip_ratio: float = C.BP_CLIP_RATIO,
                                  clip_value: float = C.BP_CLIP_VALUE,
                                  time_tile: int = 0
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """ops/normalize.normalize_ema_weighted in one launch.

    power: f32 (npol, ntime, nchan); weights: f32 (npol, ntime);
    bp: f32 (npol, nchan).  Returns (out, new bp)."""
    if power.device.type == "cpu":
        return norm_ops.normalize_ema_weighted(power, weights, bp, scale,
                                               clip_ratio, clip_value,
                                               time_tile)
    _f32("weights", weights, tuple(power.shape[:2]), power.device)
    out = _launch("vf_ema_weighted", power, bp, scale, time_tile, [weights],
                  clip=(clip_ratio, clip_value))
    LAUNCHES["normalize_ema_weighted_pallas"] += 1
    return out
