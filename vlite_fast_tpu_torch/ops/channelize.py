"""Channelization: (npol, nsamp) real voltages -> (npol, nspec, nchan) spectra.

Port of vlite_fast_tpu/ops/channelize.py, methods 'fft' and 'matmul'.
'matmul' is the two-stage Cooley-Tukey DFT (nfft = n1*n2, 100x125 at
production) as f32 matrix products on real/imag planes; the tables are
built once per nfft in float64 and cast, as the JAX package does.  Both
forms run in full f32: callers on the card set
torch.backends.cuda.matmul.allow_tf32 = False (models/baseband_dsp does).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def channelize(x: torch.Tensor, nfft: int, method: str = "fft"
               ) -> torch.Tensor:
    """Spectrum s covers samples [s*nfft, (s+1)*nfft); nchan = nfft//2+1."""
    npol, nsamp = x.shape
    frames = x.reshape(npol, nsamp // nfft, nfft)
    if method == "matmul":
        return matmul_rfft(frames, nfft)
    if method == "fft":
        return torch.fft.rfft(frames, dim=-1)
    raise NotImplementedError(f"channelizer {method!r} is not ported")


@lru_cache(maxsize=8)
def _ct_split(nfft: int) -> tuple:
    """Factor nfft = n1 * n2 with the factors as close as possible."""
    f = int(np.sqrt(nfft))
    for n1 in range(f, 0, -1):
        if nfft % n1 == 0:
            if n1 == 1:
                break
            return n1, nfft // n1
    raise ValueError(f"nfft {nfft} has no useful factorization")


@lru_cache(maxsize=8)
def _ct_tables(nfft: int) -> tuple:
    """DFT + twiddle matrices of the two-stage transform, complex64 numpy:
    w1 (n1, n1) [m1, k1], tw (n1, n2) [k1, m2], w2 (n2, n2) [m2, k2]."""
    n1, n2 = _ct_split(nfft)
    i1 = np.arange(n1)
    i2 = np.arange(n2)
    w1 = np.exp(-2j * np.pi * np.outer(i1, i1) / n1).astype(np.complex64)
    tw = np.exp(-2j * np.pi * np.outer(i1, i2) / nfft).astype(np.complex64)
    w2 = np.exp(-2j * np.pi * np.outer(i2, i2) / n2).astype(np.complex64)
    return w1, tw, w2


_PLANES: dict = {}


def _planes(nfft: int, device: torch.device) -> tuple:
    """Real/imag f32 planes of the tables on `device`, stage-2 matrix
    sliced to the rfft-needed k2 columns."""
    key = (nfft, str(device))
    if key not in _PLANES:
        n1, _ = _ct_split(nfft)
        w1, tw, w2 = _ct_tables(nfft)
        w2 = w2[:, :nfft // 2 // n1 + 1]
        _PLANES[key] = tuple(
            torch.from_numpy(np.ascontiguousarray(p)).to(device)
            for p in (w1.real, w1.imag, tw.real, tw.imag, w2.real, w2.imag))
    return _PLANES[key]


def matmul_rfft(frames: torch.Tensor, nfft: int) -> torch.Tensor:
    """rfft as two DFT stages (decimation in time): with n = n2*m1 + m2
    and k = k1 + n1*k2,

      A[k1, m2] = sum_m1 x[m1, m2] W_n1^{m1 k1}
      B = A * W_nfft^{m2 k1}
      X[k1 + n1 k2] = sum_m2 B[k1, m2] W_n2^{m2 k2}

    frames: (..., nfft) real -> (..., nfft//2+1) complex64."""
    n1, n2 = _ct_split(nfft)
    w1r, w1i, twr, twi, w2r, w2i = _planes(nfft, frames.device)
    batch = frames.shape[:-1]
    nchan = nfft // 2 + 1
    x = frames.reshape(-1, n1, n2).to(torch.float32)      # (b, m1, m2)
    ar = torch.matmul(w1r.T, x)                             # (b, k1, m2)
    ai = torch.matmul(w1i.T, x)
    br = ar * twr - ai * twi
    bi = ar * twi + ai * twr
    pr = torch.matmul(br, w2r) - torch.matmul(bi, w2i)      # (b, k1, k2)
    pi = torch.matmul(br, w2i) + torch.matmul(bi, w2r)
    # linear bin k = k1 + n1*k2: (b, k2, k1) flattened
    lin_r = pr.transpose(1, 2).reshape(x.shape[0], -1)[:, :nchan]
    lin_i = pi.transpose(1, 2).reshape(x.shape[0], -1)[:, :nchan]
    return torch.complex(lin_r, lin_i).reshape(*batch, nchan)
