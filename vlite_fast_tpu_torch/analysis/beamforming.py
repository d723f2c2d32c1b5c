"""Coherent beamforming of multi-antenna voltage dumps.

The offline phased-array step of the reference (analysis/beamforming.py,
and the purpose of the voltage dumps: coherent reanalysis of triggers).
Antenna streams are aligned with sub-sample precision by Fourier-domain
phase shifts (delay -> linear phase), then summed; the coherent S/N of a
common signal grows ~linearly with N antennas versus sqrt(N) for the
incoherent coadd.

Port of vlite_fast_tpu/analysis/beamforming.py: the shifts and the sum
are torch ops on `device` ('cuda' by default), in the JAX code's float32
arithmetic.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from vlite_fast_tpu_torch.analysis.baseband import VoltageDump, re_order
from vlite_fast_tpu_torch.analysis.localization import (C_LIGHT,
                                                        direction_unit)


def fractional_shift(x: torch.Tensor, delay_samples: float) -> torch.Tensor:
    """Shift x (..., n) earlier by delay_samples (may be fractional) using
    an rfft phase ramp.  The phase 2*pi*f*delay/n is float32, in the JAX
    code's order of operations."""
    n = x.shape[-1]
    spec = torch.fft.rfft(x, dim=-1)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=x.device)
    f = torch.arange(spec.shape[-1], dtype=torch.float32, device=x.device)
    theta = f32(2.0 * np.pi) * f * f32(delay_samples) / f32(n)
    rot = torch.complex(torch.cos(theta), torch.sin(theta))
    return torch.fft.irfft(spec * rot, n=n, dim=-1)


def geometric_delays(positions_m: np.ndarray, az: float, el: float,
                     ref_ant: int = 0) -> np.ndarray:
    """Plane-wave arrival delays (s) per antenna relative to ref_ant for a
    source at (az, el)."""
    s = direction_unit(np.array(az), np.array(el))
    tau = positions_m @ s / C_LIGHT
    return tau - tau[ref_ant]


def beamform(dumps: Sequence[VoltageDump],
             delays_s: Optional[np.ndarray] = None,
             weights: Optional[np.ndarray] = None,
             device="cuda") -> VoltageDump:
    """Coherent sum of aligned antenna streams.

    delays_s[i]: how much EARLIER antenna i received the wavefront than
    the reference.  An early stream's features sit at earlier sample
    indices, so alignment DELAYS it by tau (shift toward later t) — a
    +tau advance here would double the misalignment instead of removing
    it (measured: beam peak 0.126 vs 0.98, below a single antenna).
    Returns a synthetic 'dump' whose samples are the re-digitized beam
    (scaled to keep unit variance).
    """
    dumps = re_order(dumps)
    nant = len(dumps)
    if delays_s is None:
        delays_s = np.zeros(nant)
    if weights is None:
        weights = np.ones(nant)
    rate = dumps[0].sample_rate
    acc = None
    for d, tau, wgt in zip(dumps, delays_s, weights):
        x = fractional_shift(d.voltages_on(device),
                             float(np.float32(-tau * rate)))
        acc = float(wgt) * x if acc is None else acc + float(wgt) * x
    norm = float(np.sqrt(np.sum(np.asarray(weights) ** 2)))
    beam = acc.cpu().numpy() / norm
    # exact inverse of the voltages() decode (u/128 - 1): keeps the beam in
    # the same count scale as the inputs
    u = np.clip(beam * 128.0 + 128.5, 0, 255).astype(np.uint8)
    return VoltageDump(samples=u, start_time=dumps[0].start_time,
                       station_id=0, sample_rate=rate)


def beamform_toward(dumps: Sequence[VoltageDump], positions_m: np.ndarray,
                    az: float, el: float, device="cuda") -> VoltageDump:
    """Beamform at a sky direction using antenna positions."""
    tau = geometric_delays(positions_m, az, el)
    return beamform(dumps, delays_s=tau, device=device)
