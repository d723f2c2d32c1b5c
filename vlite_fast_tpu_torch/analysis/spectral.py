"""Voltage-domain spectral tools: analytic signal, cyclic spectra, MUOS
band filtering, frequency scrunching.

Clean-room reimplementation of the remaining offline utilities of the
reference's analysis/baseband.py: real_to_complex (:911-941), fscrunch
(:942-958), cyclic_spectrum (:1069-1092), filter_muos (:1140-1190).
The MUOS military satcom bands (360-380 MHz) are the dominant persistent
RFI in the VLITE band; filter_muos isolates/excises one of the four 5 MHz
MUOS downlink bands.

The port's own copy of the JAX package's
vlite_fast_tpu/analysis/spectral.py, kept whole so that the port imports
nothing of that package.
"""

from __future__ import annotations

import numpy as np


def real_to_complex(samples: np.ndarray, shift_band: bool = True,
                    flip_sideband: bool = False) -> np.ndarray:
    """Real -> analytic (complex baseband at half rate).

    Keeps only positive frequencies, downsamples by 2; shift_band rotates
    by fs/4 so the band halves are frequency-ordered
    (ref analysis/baseband.py:911-941)."""
    t = np.fft.fft(samples)
    n = len(t)
    t[1:n // 2] *= 2
    t[n // 2 + 1:] = 0
    x = np.fft.ifft(t)[::2].astype(np.complex64)
    if shift_band:
        x[1::2] *= -1
    if flip_sideband:
        x = x.real - 1j * x.imag
    return x


def fscrunch(fb: np.ndarray, n: int = 1) -> np.ndarray:
    """Halve the channel count n times by pairwise averaging
    (ref analysis/baseband.py:942-958)."""
    single = fb.ndim == 1
    if single:
        fb = fb[None]
    for _ in range(n):
        rest = fb[:, 1:]                    # DC stays unpaired
        npair = rest.shape[1] // 2
        cols = [fb[:, :1],
                0.5 * (rest[:, 0:2 * npair:2] + rest[:, 1:2 * npair:2])]
        if rest.shape[1] % 2:
            # odd remainder (happens on the second halving of an
            # nfft//2+1-channel filterbank): carry the last channel
            cols.append(rest[:, -1:])
        fb = np.concatenate(cols, axis=1)
    return fb[0] if single else fb


def cyclic_spectrum(samples: np.ndarray, nfft: int = 100_000,
                    lags: int = 100) -> np.ndarray:
    """Lag-resolved cyclic spectrum from blockwise spectra
    (ref analysis/baseband.py:1069-1092, including the odd-lag block
    twiddle of (-1)^iblock that compensates the per-block time origin)."""
    nspec = len(samples) // nfft
    spec = np.fft.rfft(samples[:nspec * nfft].reshape(nspec, nfft),
                       axis=-1).astype(np.complex64)
    conj = spec.conj()
    tw = np.ones((2, nspec), np.float32)
    tw[1, 1::2] = -1
    out = np.zeros((lags, nfft // 2 + 1), np.complex64)
    for lag in range(lags):
        out[lag] = np.mean(
            spec * np.roll(conj, lag, axis=1) * tw[lag % 2][:, None],
            axis=0)
    return out


def filter_muos(samples: np.ndarray, band: int = 1, bw_mhz: float = 5.0,
                sample_rate: float = 128e6) -> np.ndarray:
    """Isolate one MUOS downlink band as a complex baseband signal
    (ref analysis/baseband.py:1140-1190).

    Band centers below the 384 MHz band top: band 4 -> 377.5 MHz,
    3 -> 372.5, 2 -> 367.5, 1 -> 362.5.  Returns a full-rate analytic
    signal with the selected band rotated to just above 0 Hz and
    everything else zeroed.
    """
    x = samples if np.iscomplexobj(samples) else real_to_complex(
        samples, shift_band=False)
    fsamp = sample_rate / 2.0          # complex rate after real_to_complex
    freq_shift = (4 + 5 * (band - 1)) * 1e6
    tone = np.exp(-2j * np.pi * freq_shift / fsamp
                  * np.arange(len(x))).astype(np.complex64)
    x = x * tone
    t = np.fft.fft(x)
    nchan = int(bw_mhz / (fsamp / 1e6) * len(t))
    t[nchan:] = 0
    t = np.roll(t, -nchan // 2)
    return np.fft.ifft(t).astype(np.complex64)
