"""FRB injection into the channelized data (production-path signal test).

Port of vlite_fast_tpu/ops/injection.py (ref set_frb_delays + inject_frb,
src/pb_kernels.cu:338-391): every 60 s an FRB at DM 80, 2 ms wide, is
swept through the band by multiplying the spectra inside its dispersed
time-channel track.
"""

from __future__ import annotations

import numpy as np
import torch


def frb_delays(nchan: int, dm: float, spectra_per_sec: float,
               freq_top_ghz: float = 0.384,
               bandwidth_ghz: float = 0.064) -> np.ndarray:
    """Dispersion delay per channel in spectra:
    4.15e-3 * dm * spectra_per_sec * (f_i^-2 - f_top^-2) [GHz]."""
    i = np.arange(nchan, dtype=np.float64)
    freq = freq_top_ghz - (i * bandwidth_ghz) / nchan
    scale = 4.15e-3 * dm * spectra_per_sec
    return (scale / (freq * freq) - scale / (freq_top_ghz ** 2)).astype(
        np.float32)


def track_bounds(delays: torch.Tensor, frb_width_spectra: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per channel, the first and last spectrum of the track counted from
    the burst's top-of-band arrival, inclusive: floor(d + 0.5) and
    floor(d + width + 0.5), int32, in f32 arithmetic."""
    return (torch.floor(delays + 0.5).to(torch.int32),
            torch.floor(delays + frb_width_spectra + 0.5).to(torch.int32))


def inject_frb(spec: torch.Tensor, delays: torch.Tensor, nfft_since_frb: int,
               frb_width_spectra: float, frb_amp: float) -> torch.Tensor:
    """Multiply the dispersed track by frb_amp.

    spec: (npol, nspec, nchan) complex; delays: (nchan,) f32 in spectra;
    nfft_since_frb: spectra elapsed since the burst's top-of-band arrival.
    Per channel the track spans spectra [floor(d+0.5), floor(d+width+0.5)]
    - nfft_since_frb, inclusive."""
    npol, nspec, nchan = spec.shape
    lo, hi = track_bounds(delays, frb_width_spectra)
    lo, hi = lo - nfft_since_frb, hi - nfft_since_frb
    t = torch.arange(nspec, dtype=torch.int32, device=spec.device)[:, None]
    mask = (t >= lo[None, :]) & (t <= hi[None, :])
    amp = torch.where(mask, torch.tensor(frb_amp, dtype=torch.float32,
                                         device=spec.device),
                      torch.tensor(1.0, dtype=torch.float32,
                                   device=spec.device))
    return spec * amp[None, :, :]
