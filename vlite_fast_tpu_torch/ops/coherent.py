"""Coherent dispersion/dedispersion via overlap-save FFT convolution.

The dispersion kernel and overlap-save halo pattern mirror genbase's
synthesis path (ref src/genbase.cu:525-552 init_dm_kernel, :204-237,366-390
overlap logic) and the offline coherent dedispersion of analysis/loc_step1.py
(:39-160).  This is the "long receptive field" op of the system: a block of
voltages is convolved with a chirp whose length is the DM smearing time, so
blockwise processing needs an n_dm_samp-wide halo.

The port of vlite_fast_tpu/ops/coherent.py on torch.fft (the JAX module
has no Pallas kernel): the chirp ops run on the device of the block they
are given; the kernel's phases and the smearing arithmetic stay numpy.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from vlite_fast_tpu_torch import devices


@lru_cache(maxsize=16)
def _dm_kernel_np(nfreq: int, dm: float, bandwidth_mhz: float,
                  freq_bot_mhz: float, taper: bool) -> np.ndarray:
    """Dispersion transfer function on rfft bins 0..nfreq-1.

    Ref src/genbase.cu:525-552: phase = 2*pi*(dm/2.41e-10) * f^2 /
    (f0^2 (f0+f)) with f the offset from the band bottom f0 in MHz, plus the
    1/N inverse-FFT normalization and (optionally) a synthetic asymmetric
    bandpass taper.
    """
    i = np.arange(nfreq, dtype=np.float64)
    # physical rfft bin mapping: bin nfreq-1 = Nyquist = band top.  (The
    # reference uses bw*i/nfreq, genbase.cu:535 — self-consistent within
    # one block length but wrong across lengths; the 1/(nfreq-1) mapping
    # makes kernels of different block sizes interoperable.)
    f = bandwidth_mhz * i / (nfreq - 1)
    f0 = freq_bot_mhz
    arg = (2 * np.pi * dm / 2.41e-10) * f * f / (f0 * f0 * (f0 + f))
    ker = (np.cos(arg) + 1j * np.sin(arg)) / (2 * (nfreq - 1))
    if taper:
        fn = f / bandwidth_mhz
        scale = 1 - np.exp(-(fn * fn) / 0.05 ** 2)
        scale -= np.exp(-((1 - fn) ** 2) / 0.10 ** 2)
        scale *= 1 + 0.20 * fn
        ker *= scale
    return ker.astype(np.complex64)


def dispersion_kernel(buflen: int, dm: float, bandwidth_mhz: float = 64.0,
                      freq_bot_mhz: float = 320.0, taper: bool = True,
                      device="cuda") -> torch.Tensor:
    """Kernel for a buflen-sample real block (nfreq = buflen//2 + 1), a
    complex64 tensor on `device`."""
    return torch.from_numpy(
        _dm_kernel_np(buflen // 2 + 1, float(dm), float(bandwidth_mhz),
                      float(freq_bot_mhz), bool(taper))).to(
        devices.resolve(device))


def smearing_samples(dm: float, sample_rate: float,
                     freq_lo_mhz: float = 320.0, freq_mid_mhz: float = 352.0,
                     freq_hi_mhz: float = 384.0) -> tuple[int, int]:
    """(n_lo, n_hi): DM smearing in samples from band center to each edge,
    rounded up to even (ref src/genbase.cu:174-196).  After the reference's
    swap, n_lo is the top-half smearing and n_hi the bottom-half; the total
    overlap is their sum."""
    t_lo = dm / 2.41e-10 * (freq_lo_mhz ** -2 - freq_mid_mhz ** -2)  # mus
    t_hi = dm / 2.41e-10 * (freq_mid_mhz ** -2 - freq_hi_mhz ** -2)
    n_lo = int(t_lo * 1e-6 * sample_rate)
    n_hi = int(t_hi * 1e-6 * sample_rate)
    n_lo += n_lo & 1
    n_hi += n_hi & 1
    return n_hi, n_lo  # swapped as in genbase.cu:190-194


def apply_chirp(block: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """One overlap-save step: rfft -> multiply -> irfft on a real block.

    block: (..., buflen) float32. Only the central
    [n_dm_lo : buflen - n_dm_hi] samples of the result are valid; the caller
    manages the overlap copy (models/synthesis.py).
    """
    spec = torch.fft.rfft(block, dim=-1)
    # cuFFT C2R is unnormalized and the kernel carries 1/N (see
    # _dm_kernel_np); torch.fft.irfft normalizes by 1/N itself, so multiply
    # the N back in to keep kernels interchangeable with the reference's.
    n = block.shape[-1]
    return torch.fft.irfft(spec * kernel.to(block.device), n=n, dim=-1) * n


def swap_sideband(x: torch.Tensor) -> torch.Tensor:
    """Negate odd samples: shift spectrum by fs/2 to the VLITE sideband
    sense (ref src/genbase.cu:651-661)."""
    n = x.shape[-1]
    sign = torch.where(torch.arange(n, device=x.device) % 2 == 1, -1.0, 1.0)
    return x * sign.to(x.dtype)


def coherent_dedisperse(block: torch.Tensor, dm: float, sample_rate: float,
                        bandwidth_mhz: float = 64.0,
                        freq_bot_mhz: float = 320.0) -> torch.Tensor:
    """Inverse chirp (no taper, conjugate phase): offline coherent
    dedispersion of a voltage block (ref analysis/loc_step1.py:39-160)."""
    n = block.shape[-1]
    ker = torch.conj(dispersion_kernel(n, dm, bandwidth_mhz, freq_bot_mhz,
                                       taper=False, device=block.device))
    return apply_chirp(block, ker)
