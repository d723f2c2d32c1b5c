"""Offline voltage-domain analysis of triggered dumps.

The researcher-facing layer the reference implements in analysis/baseband.py
(1300 LoC: VDIFHeader/Baseband/iterators, re_order_baseband :656-722,
correlate :807-859, filterbank :960-990, polyphase_filterbank :1207-1238)
and analysis/beamforming.py.  Rebuilt on the framework's own VDIF/DSP ops.

Port of vlite_fast_tpu/analysis/baseband.py: the compute-heavy pieces
(channelizers, correlations, coherent dedispersion) are torch ops on
`device` ('cuda' by default; 'cpu' when the caller asks), through the
port's ops/channelize and ops/coherent; the numpy parts (dump I/O,
alignment, the delay fits, clean_coherent_dedisperse) stay numpy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from vlite_fast_tpu_torch import constants as C
from vlite_fast_tpu_torch import devices
from vlite_fast_tpu_torch.ops import channelize as ch_ops
from vlite_fast_tpu_torch.ops import coherent as coh_ops
from vlite_fast_tpu_torch.utils import vdif


@dataclass
class VoltageDump:
    """One antenna's dumped voltage window."""

    samples: np.ndarray      # (npol, nsamp) uint8
    start_time: float        # unix seconds of first sample
    station_id: int
    sample_rate: int = C.VLITE_RATE

    @classmethod
    def from_file(cls, path: str,
                  sample_rate: int = C.VLITE_RATE) -> "VoltageDump":
        raw = np.fromfile(path, dtype=np.uint8)
        samples, hdr = vdif.frames_to_streams(raw)
        return cls(samples=samples, start_time=hdr.unix_time,
                   station_id=hdr.station_id, sample_rate=sample_rate)

    @property
    def nsamp(self) -> int:
        return self.samples.shape[1]

    @property
    def duration(self) -> float:
        return self.nsamp / self.sample_rate

    def voltages(self) -> np.ndarray:
        """float32 voltages with the gap-fill zero convention."""
        x = self.samples.astype(np.float32) / 128.0 - 1.0
        x[self.samples == 0] = 0.0
        return x

    def voltages_on(self, device) -> torch.Tensor:
        """voltages() as a tensor on `device`, converted there from the
        samples (the same float32 values: u / 128 - 1 is exact)."""
        u = torch.from_numpy(np.ascontiguousarray(self.samples)).to(
            devices.resolve(device))
        x = u.to(torch.float32) / 128.0 - 1.0
        return x.masked_fill_(u == 0, 0.0)


def re_order(dumps: Sequence[VoltageDump]) -> List[VoltageDump]:
    """Align multiple antennas' dumps onto their common time window
    (ref analysis/baseband.py:656-722 re_order_baseband)."""
    t0 = max(d.start_time for d in dumps)
    t1 = min(d.start_time + d.duration for d in dumps)
    if t1 <= t0:
        raise ValueError("dumps do not overlap in time")
    out = []
    for d in dumps:
        i0 = int(round((t0 - d.start_time) * d.sample_rate))
        i1 = int(round((t1 - d.start_time) * d.sample_rate))
        out.append(VoltageDump(samples=d.samples[:, i0:i1],
                               start_time=t0, station_id=d.station_id,
                               sample_rate=d.sample_rate))
    n = min(d.nsamp for d in out)
    for d in out:
        d.samples = d.samples[:, :n]
    return out


def filterbank(dump: VoltageDump, nfft: int = C.NFFT,
               coherent_dm: float = 0.0,
               bandwidth_mhz: float = C.BANDWIDTH_MHZ,
               freq_bot_mhz: float = C.FREQ_BOT_MHZ,
               device="cuda") -> np.ndarray:
    """Detected filterbank from voltages, optionally coherently dedispersed
    first (ref analysis/baseband.py:960-990 + loc_step1 chirp).
    Returns (nspec, nchan) total power (pols summed)."""
    x = dump.voltages_on(device)
    if coherent_dm != 0.0:
        x = coh_ops.swap_sideband(coh_ops.coherent_dedisperse(
            coh_ops.swap_sideband(x), coherent_dm, dump.sample_rate,
            bandwidth_mhz, freq_bot_mhz))
    spec = ch_ops.channelize(x, nfft)
    return (spec.abs() ** 2).sum(dim=0).cpu().numpy()


def _median_smooth(x: np.ndarray, width: int) -> np.ndarray:
    """Running median (odd width) — the bandpass estimator."""
    width = width | 1
    pad = width // 2
    xp = np.pad(x, pad, mode="edge")
    win = np.lib.stride_tricks.sliding_window_view(xp, width)
    return np.median(win, axis=-1)


def clean_coherent_dedisperse(x: np.ndarray, dm: float, sample_rate: int,
                              bandwidth_mhz: float = C.BANDWIDTH_MHZ,
                              freq_bot_mhz: float = C.FREQ_BOT_MHZ,
                              smooth_bins: int = 2001,
                              rfi_sigma: float = 5.0) -> tuple:
    """Production coherent dedispersion: flatten the bandpass and excise
    RFI bins BEFORE applying the inverse dispersion chirp (the loc_step1
    preprocessing, ref analysis/loc_step1.py:39-160 — on real
    MUOS-contaminated P-band data a raw chirp smears narrowband RFI across
    the whole record and the unflattened bandpass distorts the pulse).

    x: (npol, n) float voltages.  Steps per pol:
      1. full-length real FFT -> PSD;
      2. bandpass = running median of the PSD (smooth_bins wide);
      3. flag bins whose PSD exceeds rfi_sigma x bandpass; interpolate the
         bandpass ACROSS flagged runs from clean neighbors (so whitening
         never divides by an RFI-inflated level, ref loc_step1.py:74-101);
      4. whiten the spectrum by 1/sqrt(bandpass), zero flagged bins;
      5. multiply the coherent-dedispersion phase kernel, inverse FFT.

    Returns (cleaned_dedispersed (npol, n) float32, flag_mask (nbin,)).
    """
    x = np.asarray(x, np.float32)
    npol, n = x.shape
    X = np.fft.rfft(x, axis=1)
    psd = np.mean(np.abs(X) ** 2, axis=0)
    bp = _median_smooth(psd, min(smooth_bins, max(3, psd.size // 4)))
    flag = psd > rfi_sigma * np.maximum(bp, 1e-30)
    good = ~flag
    if flag.any() and good.any():
        idx = np.arange(psd.size)
        bp = np.interp(idx, idx[good], bp[good])
    white = 1.0 / np.sqrt(np.maximum(bp, 1e-30))
    white[flag] = 0.0
    # normalize so the mean gain over clean bins is 1 (keeps amplitudes
    # comparable to the un-whitened path)
    scale = np.sqrt(np.mean(psd[good])) if good.any() else 1.0
    Xw = X * (white * scale)[None, :]
    # inverse chirp on the analytic spectrum: rfft bins k map to sky
    # frequency freq_bot + k*rate/n (lower-sideband handling matches
    # ops.coherent via the sideband swap identity used in filterbank())
    kern = coh_ops.dispersion_kernel(
        n, dm, bandwidth_mhz=bandwidth_mhz, freq_bot_mhz=freq_bot_mhz,
        taper=False, device="cpu").numpy()
    out = np.fft.irfft(Xw * np.conj(kern)[None, :], n=n, axis=1)
    return out.astype(np.float32), flag


def polyphase_filterbank(dump: VoltageDump, nfft: int = C.NFFT,
                         ntap: int = 4, device="cuda") -> np.ndarray:
    """WOLA PFB power (ref analysis/baseband.py:1207-1238)."""
    spec = ch_ops.polyphase_channelize(dump.voltages_on(device), nfft, ntap)
    return (spec.abs() ** 2).sum(dim=0).cpu().numpy()


def _alpha_index(alpha_hz: float, sample_rate: int, nfft: int) -> int:
    """Cyclic frequency -> channel shift; must be commensurate with the
    FFT grid (ref analysis/baseband.py:820-824)."""
    df = sample_rate / nfft
    k = int(round(alpha_hz / df))
    if abs(k * df - alpha_hz) > 1e-6 * df:
        raise ValueError("cyclic frequency not commensurate with the "
                         f"FFT grid (df = {df} Hz)")
    return k


def correlate(a: VoltageDump, b: VoltageDump, nfft: int = 2500,
              nav: int = 0, alpha_hz: float = 0.0,
              device="cuda") -> np.ndarray:
    """FX cross-correlation of one baseline
    (ref analysis/baseband.py:807-859 correlate).

    alpha_hz != 0 computes the CYCLIC cross-spectrum at that cyclic
    frequency: the conjugated spectrum is shifted by alpha before the
    product, C(f; alpha) = <S_a(f) S_b*(f - alpha)> — nonzero for
    cyclostationary signals (e.g. the MUOS OFDM symbol rate), the tool
    the reference uses to identify modulated RFI
    (ref analysis/baseband.py:811,842-846 + :1069-1139).

    Returns visibilities (npol, nspec_av, nchan) complex64 where
    nav spectra are averaged (0 = average everything)."""
    sa = ch_ops.channelize(a.voltages_on(device), nfft)  # (npol, nspec, nchan)
    sb = ch_ops.channelize(b.voltages_on(device), nfft)
    sbc = torch.conj(sb)
    if alpha_hz:
        k = _alpha_index(alpha_hz, a.sample_rate, nfft)
        sbc = torch.roll(sbc, k, dims=-1)
    vis = sa * sbc
    if nav == 0:
        return vis.mean(dim=1, keepdim=True).cpu().numpy()
    nspec = vis.shape[1] - vis.shape[1] % nav
    v = vis[:, :nspec].reshape(vis.shape[0], nspec // nav, nav, -1)
    return v.mean(dim=2).cpu().numpy()


def correlation_matrix(dumps: Sequence[VoltageDump],
                       nfft: int = 2500,
                       alpha_hz: float = 0.0,
                       device="cuda") -> np.ndarray:
    """Full cross-correlation matrix over all baselines (incl. autos).
    alpha_hz != 0 gives the cyclic matrix (incl. cyclic AUTOS — the
    reference's modulated-RFI detector, analysis/baseband.py:842-846).
    Returns (nant, nant, npol, nchan) time-averaged visibilities."""
    dumps = re_order(dumps)
    specs = [ch_ops.channelize(d.voltages_on(device), nfft) for d in dumps]
    nant = len(dumps)
    npol, _, nchan = specs[0].shape
    k = _alpha_index(alpha_hz, dumps[0].sample_rate, nfft) \
        if alpha_hz else 0
    out = np.zeros((nant, nant, npol, nchan), np.complex64)
    for i in range(nant):
        for j in range(0 if k else i, nant):
            sjc = torch.conj(specs[j])
            if k:
                sjc = torch.roll(sjc, k, dims=-1)
            out[i, j] = (specs[i] * sjc).mean(dim=1).cpu().numpy()
            if i != j and not k:    # hermitian only without a shift
                out[j, i] = np.conj(out[i, j])
    return out


def fit_delay_phase(vis: np.ndarray, sample_rate: int, nfft: int,
                    coarse_delay: float = 0.0, niter: int = 3
                    ) -> Tuple[float, float, float]:
    """Sub-sample baseline delay from the visibility PHASE SLOPE
    (ref analysis/baseband.py:723-806: the reference fits per-baseline
    delays by regressing visibility phase against frequency, not by the
    integer lag-spectrum peak).

    vis: (nchan,) complex visibility spectrum (a x conj(b), channels
    spanning [0, sample_rate/2) in steps of sample_rate/nfft).
    Starting from `coarse_delay` (seconds), iterates a weighted linear fit
    of the residual phase gradient: the per-channel phase difference
    angle(v[k+1] conj(v[k])) is an unwrap-free local slope estimate,
    weighted by the channel pair's coherence |v|^2.  Returns
    (delay_seconds, phase0_radians, coherence) where coherence in [0, 1]
    is |sum of rotated vis| / sum |vis| — 1.0 for a pure delay.

    Sign convention matches baseline_delay's lag-spectrum peak (so the
    two stages compose): vis = S_a conj(S_b) carries phase
    e^{+2 pi i f tau_ba}, and the returned delay is the lag-peak's.
    """
    v = np.asarray(vis, np.complex128)
    nchan = v.size
    df = sample_rate / nfft                         # Hz per channel
    f = np.arange(nchan) * df
    w = np.abs(v) ** 2
    tau = float(coarse_delay)
    for _ in range(niter):
        resid = v * np.exp(2j * np.pi * f * tau)
        dphi = np.angle(resid[1:] * np.conj(resid[:-1]))
        ww = np.minimum(w[1:], w[:-1])
        if ww.sum() == 0:
            break
        slope = float(np.sum(ww * dphi) / np.sum(ww))  # rad / channel
        tau -= slope / (2 * np.pi * df)
    resid = v * np.exp(2j * np.pi * f * tau)
    tot = np.sum(resid)
    coherence = float(np.abs(tot) / (np.sum(np.abs(v)) + 1e-30))
    return tau, float(np.angle(tot)), coherence


def baseline_delay_precise(a: VoltageDump, b: VoltageDump,
                           nfft: int = 2500,
                           max_lag: Optional[int] = None,
                           device="cuda") -> Tuple[float, float, float]:
    """Two-stage baseline delay: integer-sample lag peak (baseline_delay)
    seeds the phase-slope fit for sub-sample resolution
    (ref analysis/baseband.py:723-806).  Returns
    (delay_seconds, coherence, lag_snr)."""
    coarse, snr = baseline_delay(a, b, nfft=nfft, max_lag=max_lag,
                                 device=device)
    vis = correlate(a, b, nfft=nfft, device=device)[:, 0, :].sum(axis=0)
    tau, _, coh = fit_delay_phase(vis, a.sample_rate, nfft,
                                  coarse_delay=coarse)
    return tau, coh, snr


def baseline_delay(a: VoltageDump, b: VoltageDump, nfft: int = 2500,
                   max_lag: Optional[int] = None,
                   device="cuda") -> Tuple[float, float]:
    """Per-baseline geometric delay from the visibility phase slope
    (ref analysis/baseband.py:723-806 delay fitting, loc_step2 intensity
    cross-power).

    Returns (delay_seconds, peak_correlation).  Uses the lag spectrum of the
    frequency-domain visibility: ifft over channels peaks at the delay.
    """
    vis = correlate(a, b, nfft=nfft, device=device)[:, 0, :]  # (npol, nchan)
    v = vis.sum(axis=0)
    # channels span sample_rate/2 with spacing sample_rate/nfft, so the lag
    # spectrum's bin width is exactly one voltage sample (1/sample_rate)
    lag = np.fft.irfft(v, n=nfft)
    n = lag.shape[0]
    if max_lag is not None:
        keep = np.zeros(n, bool)
        keep[:max_lag] = keep[-max_lag:] = True
        lag = np.where(keep, lag, 0)
    k = int(np.argmax(np.abs(lag)))
    shift = k if k <= n // 2 else k - n
    delay = shift / a.sample_rate
    snr = np.abs(lag[k]) / (np.median(np.abs(lag)) + 1e-12)
    return float(delay), float(snr)
