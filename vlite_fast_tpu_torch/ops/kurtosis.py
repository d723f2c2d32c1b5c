"""Spectral-kurtosis RFI excision.

Port of vlite_fast_tpu/ops/kurtosis.py, flat front only (ref
src/pb_kernels.cu:35-318): fine-window power and kurtosis, the
D'Agostino K^2 test statistic pol-combined by max, block statistics over
each FFT block, the mask and the surviving weight per block.

Shapes: voltages (npol, nsamp); fine-window stats (npol, nwin) with
nwin = nsamp // nkurto; block stats (npol, nblk) with nblk = nsamp // nfft.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vlite_fast_tpu import constants as C
from vlite_fast_tpu_torch.ops.normalize import recip


class KurtosisResult(NamedTuple):
    masked: torch.Tensor    # (npol, nsamp) voltages with bad windows zeroed
    weights: torch.Tensor   # (npol, nblk) surviving fraction per FFT block
    dag: torch.Tensor       # (nwin,) pol-combined fine-window TS
    dag_fb: torch.Tensor    # (nblk,) pol-combined block TS
    pow_w: torch.Tensor     # (npol, nwin) fine-window power
    kur_w: torch.Tensor     # (npol, nwin) fine-window kurtosis


def window_stats(x: torch.Tensor, nkurto: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(npol, nsamp) -> (pow, kur) each (npol, nwin)."""
    npol, nsamp = x.shape
    w = x.reshape(npol, nsamp // nkurto, nkurto)
    x2 = w * w
    m2 = x2.sum(dim=-1) * recip(nkurto)
    m4 = (x2 * x2).sum(dim=-1) * recip(nkurto)
    zero = m2 == 0
    kur = m4 / torch.where(zero, torch.ones_like(m2), m2 * m2)
    kur = torch.where(zero, torch.zeros_like(kur), kur)
    return m2, kur


def dagostino_ts(kur: torch.Tensor, n: int,
                 dag_inf: float = C.DAG_INF) -> torch.Tensor:
    """D'Agostino K^2 kurtosis TS, pol-combined by max: (npol, nwin) ->
    (nwin,)."""
    k = C.dagostino_constants(n)
    t = (1.0 - 2.0 / k["A"]) / (1.0 + (kur - 3.0 - k["mu1"]) * k["Z2_3"])
    # real cube root (torch has no cbrt); only t > 0 is ever used
    cbrt = torch.sign(t) * t.abs().to(torch.float64).pow(1.0 / 3.0).to(
        torch.float32)
    dag = torch.abs(k["Z2_1"] * (k["Z2_2"] - cbrt))
    inf = torch.full_like(dag, dag_inf)
    dag = torch.where(t > 0, dag, inf)
    dag = torch.where(kur == 0.0, inf, dag)
    return dag.max(dim=0).values


def dag_consts(n: int) -> list:
    """The TS constants as the CUDA fronts take them (csrc/front.cuh
    DagK): [1 - 2/A, mu1, Z2_1, Z2_2, Z2_3]."""
    k = C.dagostino_constants(n)
    return [1.0 - 2.0 / k["A"], k["mu1"], k["Z2_1"], k["Z2_2"], k["Z2_3"]]


def block_stats(pow_w: torch.Tensor, kur_w: torch.Tensor, dag: torch.Tensor,
                windows_per_fft: int, dag_thresh: float = C.DAG_THRESH
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """FFT-block power/kurtosis over the fine windows that passed the
    fine gate.  Returns (pow_blk, kur_blk) each (npol, nblk)."""
    npol, nwin = pow_w.shape
    nblk = nwin // windows_per_fft
    wt = (dag < dag_thresh).to(pow_w.dtype).expand(npol, nwin).reshape(
        npol, nblk, windows_per_fft)
    p = pow_w.reshape(npol, nblk, windows_per_fft)
    q = kur_w.reshape(npol, nblk, windows_per_fft)
    wsum = wt.sum(dim=-1)
    psum = (wt * p).sum(dim=-1)
    qsum = (wt * q * p * p).sum(dim=-1)
    good = wsum > 0
    one = torch.ones_like(wsum)
    zero = torch.zeros_like(wsum)
    pblk = torch.where(good, psum / torch.where(good, wsum, one), zero)
    kblk = torch.where(good,
                       qsum / torch.where(good, wsum, one)
                       / torch.where(good, pblk * pblk, one), zero)
    return pblk, kblk


def apply_mask(x: torch.Tensor, dag: torch.Tensor, nkurto: int, nfft: int,
               dag_thresh: float = C.DAG_THRESH,
               block_keep: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero voltages in flagged windows; per-FFT-block surviving weights.
    block_keep: optional (nblk,) bool block gate."""
    npol, nsamp = x.shape
    nwin = nsamp // nkurto
    wpf = nfft // nkurto
    nblk = nwin // wpf
    good = dag < dag_thresh
    if block_keep is not None:
        good = good & block_keep.repeat_interleave(wpf)
    good2 = good.expand(npol, nwin)
    masked = torch.where(good2.repeat_interleave(nkurto, dim=1), x,
                         torch.zeros_like(x))
    weights = good2.to(x.dtype).reshape(npol, nblk, wpf).sum(dim=-1) \
        * recip(wpf)
    return masked, weights


def rfi_excise(x: torch.Tensor, nkurto: int, nfft: int,
               dag_thresh: float = C.DAG_THRESH,
               dag_fb_thresh: float = 0.0) -> KurtosisResult:
    """Full RFI stage: fine stats -> TS -> block stats -> mask + weights.
    dag_fb_thresh > 0 also zero-weights whole FFT blocks whose block TS
    exceeds it."""
    pow_w, kur_w = window_stats(x, nkurto)
    dag = dagostino_ts(kur_w, nkurto)
    wpf = nfft // nkurto
    _, kur_b = block_stats(pow_w, kur_w, dag, wpf, dag_thresh)
    dag_fb = dagostino_ts(kur_b, nfft)
    keep = dag_fb < dag_fb_thresh if dag_fb_thresh > 0 else None
    masked, weights = apply_mask(x, dag, nkurto, nfft, dag_thresh,
                                 block_keep=keep)
    return KurtosisResult(masked, weights, dag, dag_fb, pow_w, kur_w)
