"""Channelization: (npol, nsamp) real voltages -> (npol, nspec, nchan) spectra.

Port of vlite_fast_tpu/ops/channelize.py: methods 'fft' and 'matmul',
and the WOLA polyphase filterbank (`polyphase_channelize`, `pfb_weights`).
'matmul' is the two-stage Cooley-Tukey DFT (nfft = n1*n2, 100x125 at
production) as f32 matrix products on real/imag planes; the tables are
built once per nfft in float64 and cast, as the JAX package does.  Both
forms run in full f32: callers on the card set
torch.backends.cuda.matmul.allow_tf32 = False (models/baseband_dsp does).
The polyphase filterbank is reached only through the DSP chain's carry
(models/baseband_dsp, channelizer='pfb'), as in the JAX package:
`channelize` refuses method 'pfb'.
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
    raise ValueError(f"channelize: method {method!r} (the polyphase "
                     "filterbank is polyphase_channelize)")


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


@lru_cache(maxsize=8)
def _pfb_window(ntap: int, nfft: int) -> np.ndarray:
    """Sinc-Hamming prototype filter, normalized so that sum(w^2) = nfft:
    white noise then has the plain length-nfft channelizer's power per
    bin (a WOLA spectrum sums ntap*nfft weighted samples)."""
    n = ntap * nfft
    t = (np.arange(n) - n / 2 + 0.5) / nfft
    w = np.sinc(t) * np.hamming(n)
    w *= np.sqrt(nfft / np.sum(w ** 2))
    return w.astype(np.float32)


_WINDOWS: dict = {}


def _window(ntap: int, nfft: int, device: torch.device) -> tuple:
    """(window (ntap, nfft), tap energies (ntap,) summing to 1), f32 on
    `device`."""
    key = (ntap, nfft, str(device))
    if key not in _WINDOWS:
        win = torch.from_numpy(_pfb_window(ntap, nfft)).reshape(ntap, nfft)
        e = (win * win).sum(dim=1)
        _WINDOWS[key] = (win.to(device), (e / e.sum()).to(device))
    return _WINDOWS[key]


def pfb_weights(w_ext: torch.Tensor, ntap: int, nfft: int) -> torch.Tensor:
    """The WOLA spectra's kurtosis weights: spectrum j draws the ntap
    blocks [j, j + ntap) through the window, so its weight is the
    tap-energy-weighted mean of those blocks' surviving fractions.

    w_ext: (npol, nblk + ntap - 1) per-block fractions, the ntap - 1
    carried blocks first -> (npol, nblk)."""
    _, e = _window(ntap, nfft, w_ext.device)
    nblk = w_ext.shape[1] - (ntap - 1)
    out = w_ext[:, 0:nblk] * e[0]
    for t in range(1, ntap):
        out = out + w_ext[:, t:t + nblk] * e[t]
    return out


def _wola_into(dst: torch.Tensor, src: torch.Tensor, win: torch.Tensor
               ) -> None:
    """dst[:, j] = sum_t src[:, j + t] * win[t] over the taps in order
    (static slices, no gather; one pass over dst a tap); dst (npol, n,
    nfft)."""
    n = dst.shape[1]
    torch.mul(src[:, 0:n], win[0], out=dst)
    for t in range(1, win.shape[0]):
        dst.addcmul_(src[:, t:t + n], win[t])


def wola(x: torch.Tensor, nfft: int, ntap: int,
         tail: torch.Tensor | None = None) -> torch.Tensor:
    """The polyphase filterbank's windowed overlap-add: (npol, nsamp) ->
    (npol, nspec, nfft) f32 frames, frame j the window's taps over the
    ntap frames from j on.

    Without `tail`, nspec = nsamp // nfft - (ntap - 1).  With tail (npol,
    (ntap - 1) * nfft), the voltages just before x, nspec = nsamp // nfft:
    the frames of [tail, x], formed without concatenating x (the first
    ntap - 1 from a small [tail, x's first frames], the rest from x
    alone)."""
    win, _ = _window(ntap, nfft, x.device)
    npol, nsamp = x.shape
    frames = x.reshape(npol, nsamp // nfft, nfft)
    nh = ntap - 1
    if tail is None:
        out = torch.empty((npol, frames.shape[1] - nh, nfft),
                          dtype=torch.float32, device=x.device)
        _wola_into(out, frames, win)
        return out
    k = min(nh, frames.shape[1])        # the frames whose taps reach the tail
    out = torch.empty((npol, frames.shape[1], nfft), dtype=torch.float32,
                      device=x.device)
    _wola_into(out[:, :k], torch.cat([tail.reshape(npol, nh, nfft),
                                      frames[:, :k]], dim=1), win)
    _wola_into(out[:, k:], frames, win)
    return out


def polyphase_channelize(x: torch.Tensor, nfft: int, ntap: int = 4,
                         method: str = "fft",
                         tail: torch.Tensor | None = None) -> torch.Tensor:
    """WOLA polyphase filterbank: (npol, nsamp) -> (npol, nspec, nchan),
    each spectrum the window over ntap * nfft samples, advanced by nfft
    (`wola`, then the DFT).  Without `tail` it is the JAX package's
    polyphase_channelize of x; with it, of [tail, x].  method as in
    channelize ('matmul' or 'fft')."""
    frames = wola(x, nfft, ntap, tail)
    if method == "matmul":
        return matmul_rfft(frames, nfft)
    if method == "fft":
        return torch.fft.rfft(frames, dim=-1)
    raise ValueError(f"polyphase_channelize: method {method!r}")
