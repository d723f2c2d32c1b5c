"""Detection, running-bandpass normalization, pol/time scrunching.

Port of vlite_fast_tpu/ops/normalize.py (ref src/pb_kernels.cu:393-630).
The bandpass EMA is the sequential recurrence (the JAX package's
ema_impl='scan' semantics): one Python step per spectrum over the
(npol, nchan) bandpass.  These are the plain versions of the one-pass
EMA kernels (ops/pallas_kernels) and the oracle of the fused chain
kernel (ops/megakernel).

`time_tile` splits time into tiles of that many spectra, each seeded
(and, weighted, stale-checked) from its own rows with the bandpass
carried across tiles, as the JAX package's Pallas EMAs do; with
time_tile = ffts_per_seg a whole second in one call equals the
per-segment calls.  A tile's mean is its rows summed in time order, the
order the kernels sum in, so kernel and plain version agree bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from vlite_fast_tpu import constants as C


def detect(spec: torch.Tensor) -> torch.Tensor:
    """|X|^2: complex (npol, ntime, nchan) -> float32."""
    return (spec.real ** 2 + spec.imag ** 2).to(torch.float32)


def ema_constants(scale: float) -> tuple[float, float]:
    """(scale, 1 - scale) both rounded as f32 arithmetic rounds them."""
    s = np.float32(scale)
    return float(s), float(np.float32(1.0) - s)


def tile_rows(ntime: int, time_tile: int) -> int:
    """Spectra per time tile: time_tile (0 = all), lowered to a divisor
    of ntime (the JAX package's _tile_geometry off the TPU)."""
    tt = min(time_tile or ntime, ntime)
    while ntime % tt:
        tt -= 1
    return tt


def _row_sum(x: torch.Tensor, t0: int, n: int) -> torch.Tensor:
    """x[:, t0:t0+n] summed over dim 1 one row at a time, in order."""
    acc = torch.zeros_like(x[:, t0])
    for t in range(t0, t0 + n):
        acc = acc + x[:, t]
    return acc


def normalize_ema(power: torch.Tensor, bp: torch.Tensor, scale: float,
                  time_tile: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Unweighted bandpass normalization (detect_and_normalize2).

    power: (npol, ntime, nchan); bp: (npol, nchan), 0 = seed from the
    tile's mean (1 if that mean is 0).  Returns (p/bp - 1, new bp)."""
    s, oms = ema_constants(scale)
    tt = tile_rows(power.shape[1], time_tile)
    out = torch.empty_like(power)
    for t0 in range(0, power.shape[1], tt):
        seed = _row_sum(power, t0, tt) * recip(tt)
        seed = torch.where(seed == 0.0, torch.ones_like(seed), seed)
        bp = torch.where(bp == 0.0, seed, bp)
        for t in range(t0, t0 + tt):
            p_t = power[:, t]
            bp = s * p_t + oms * bp
            out[:, t] = p_t / bp - 1.0
    return out, bp


def normalize_ema_weighted(power: torch.Tensor, weights: torch.Tensor,
                           bp: torch.Tensor, scale: float,
                           clip_ratio: float = C.BP_CLIP_RATIO,
                           clip_value: float = C.BP_CLIP_VALUE,
                           time_tile: int = 0,
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kurtosis-weighted normalization (detect_and_normalize3).

    power: (npol, ntime, nchan); weights: (npol, ntime); bp: (npol, nchan).
      w == 0          -> out = 0, no bandpass update
      p/w > clip*bp   -> out = clip_value, no bandpass update
      else            -> bp = s*(p/w) + (1-s)*bp ; out = (p/w)/bp - 1
    Per tile: seeding (bp==0) from the mean of p/w over good spectra (1
    if none), and stale-bandpass recovery: a tile mean more than 5x off
    the carry in either direction re-seeds it."""
    s, oms = ema_constants(scale)
    tt = tile_rows(power.shape[1], time_tile)
    w3 = weights[:, :, None]
    good = w3 > 0.0
    zero = torch.zeros_like(power)
    pw = torch.where(good, power / torch.where(good, w3,
                                               torch.ones_like(w3)), zero)
    out = torch.empty_like(power)
    clip = torch.full_like(bp, clip_value)
    for t0 in range(0, power.shape[1], tt):
        ngood = good[:, t0:t0 + tt].sum(dim=1)
        seed = torch.where(ngood > 0, _row_sum(pw, t0, tt)
                           / ngood.clamp(min=1), torch.ones_like(bp))
        bp = torch.where(bp == 0.0, seed, bp)
        stale = (ngood > 0) & ((seed > 5.0 * bp) | (seed < 0.2 * bp))
        bp = torch.where(stale, seed, bp)
        for t in range(t0, t0 + tt):
            p_t, good_t = pw[:, t], good[:, t]
            clipped = p_t > bp * clip_ratio
            update = good_t & ~clipped
            bp = torch.where(update, s * p_t + oms * bp, bp)
            out[:, t] = torch.where(good_t, torch.where(clipped, clip,
                                                        p_t / bp - 1.0),
                                    torch.zeros_like(bp))
    return out, bp


_SQRT_HALF = float(np.sqrt(np.float32(0.5), dtype=np.float32))


def pscrunch(x: torch.Tensor) -> torch.Tensor:
    """Sum polarizations, variance-normalized: (2, T, C) -> (1, T, C)."""
    return (_SQRT_HALF * (x[0] + x[1]))[None]


def pscrunch_weights(x: torch.Tensor, weights: torch.Tensor,
                     min_weight: float = C.MIN_WEIGHT
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted pol sum: both pols good -> (x0+x1)/sqrt2, w=(w0+w1)/2;
    one good -> that pol and its weight; none -> 0, 0."""
    w0, w1 = weights[0], weights[1]
    g0 = w0 >= min_weight
    g1 = w1 >= min_weight
    both = (g0 & g1)[:, None]
    xg = x[0] * g0[:, None].to(x.dtype) + x[1] * g1[:, None].to(x.dtype)
    out = torch.where(both, _SQRT_HALF * (x[0] + x[1]), xg)
    w_out = torch.where(g0 & g1, 0.5 * (w0 + w1),
                        w0 * g0.to(w0.dtype) + w1 * g1.to(w1.dtype))
    return out[None], w_out[None]


def tscrunch(x: torch.Tensor, nscrunch: int) -> torch.Tensor:
    """Sum of nscrunch samples scaled by 1/sqrt(nscrunch)."""
    npol, ntime, nchan = x.shape
    y = x.reshape(npol, ntime // nscrunch, nscrunch, nchan)
    return y.sum(dim=2) * inv_sqrt(nscrunch)


def inv_sqrt(n: int) -> float:
    """1/sqrt(n) evaluated in f32 arithmetic."""
    return float(np.float32(1.0) / np.sqrt(np.float32(n)))


def recip(n: int) -> float:
    """1/n in f32.  A mean over n is taken as sum * recip(n), the form
    XLA reduces jnp.mean to: the JAX reference's weights and window
    moments are bit-equal to it, not to sum / n."""
    return float(np.float32(1.0) / np.float32(n))


def tscrunch_weights(x: torch.Tensor, weights: torch.Tensor, nscrunch: int,
                     min_weight: float = C.MIN_WEIGHT) -> torch.Tensor:
    """out = sum(w_t x_t over good t) / sqrt(#good) when the mean good
    weight reaches min_weight, else 0."""
    npol, ntime, nchan = x.shape
    w = weights.reshape(npol, ntime // nscrunch, nscrunch)
    good = w >= min_weight
    wg = torch.where(good, w, torch.zeros_like(w))
    cnt = good.sum(dim=-1)
    wsumf = wg.sum(dim=-1)
    y = x.reshape(npol, ntime // nscrunch, nscrunch, nchan)
    acc = (wg[..., None] * y).sum(dim=2)
    ok = (wsumf * recip(nscrunch)) >= min_weight
    denom = torch.sqrt(cnt.clamp(min=1).to(x.dtype))
    return torch.where(ok[..., None], acc / denom[..., None],
                       torch.zeros_like(acc))
