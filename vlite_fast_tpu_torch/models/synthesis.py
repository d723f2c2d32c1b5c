"""Synthetic baseband generator — the system's test-data backend.

Re-design of genbase (ref src/genbase.cu:79-520): Gaussian voltages with a
periodic pulse (or FRB via skip_period), coherently *dispersed* by an
overlap-save chirp convolution, sideband-swapped to VLITE sense, optionally
polluted with duty-cycled RFI, and digitized to 8-bit offset-binary — either
as raw per-pol sample arrays or framed VDIF.

It doubles as the prototype of the overlap-save halo pattern (SURVEY.md
section 5 "long-context"): blocks of `buflen` samples carry an `n_dm_samp`
overlap between iterations, exactly like a time-sharded TPU mesh exchanging
halos between neighbors.

Host-side numpy by design: this is a fixture/generator, not a hot path.

The port's copy of vlite_fast_tpu/models/synthesis.py (numpy), on the
port's ops/coherent and utils/vdif.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from vlite_fast_tpu_torch import constants as C
from vlite_fast_tpu_torch.ops.coherent import _dm_kernel_np, smearing_samples
from vlite_fast_tpu_torch.utils import vdif


@dataclass
class SynthConfig:
    """Mirrors genbase's getopt flags (ref src/genbase.cu:63-77)."""

    tobs: float = 5.0            # -t seconds to simulate
    dm: float = 30.0             # -d
    pulse_period: float = 0.5    # -p seconds
    skip_period: int = 1         # -k produce a pulse every k periods
    amp: float = 0.05            # -a pulse amplitude as fraction of Tsys
    pol_ratio: float = 1.0       # -s second-pol amplitude scale
    seed: int = 42               # -r
    add_rfi: bool = False        # -f
    sample_rate: int = C.VLITE_RATE
    freq_bot_mhz: float = C.FREQ_BOT_MHZ
    bandwidth_mhz: float = C.BANDWIDTH_MHZ
    npol: int = 2
    duty_phase: float = 0.03     # pulse duty cycle (genbase.cu:576)
    buflen: int = 0              # 0 -> sample_rate // 4 (genbase.cu:204)


def _set_profile(x: np.ndarray, current_sample: int, period: int,
                 skip_period: int, ampl: float, duty: float) -> None:
    """Multiply pulse windows in place (ref src/genbase.cu:554-585)."""
    i = np.arange(x.size, dtype=np.int64) + current_sample
    phasei = i // period
    phasef = (i - phasei * period) / period
    mask = (phasef < duty) & (phasei % skip_period == 0)
    x[mask] *= ampl


def _add_rfi(x: np.ndarray, current_sample: int, tsamp_us: float,
             rng: np.random.Generator) -> None:
    """~1 us of uniform RFI every 11.3 us (ref src/genbase.cu:671-687)."""
    i = np.arange(x.size, dtype=np.int64) + current_sample
    phase = np.mod(i * (tsamp_us / 11.3), 1.0)
    mask = phase < 0.1
    x[mask] += 5.0 * (rng.random(int(mask.sum()), dtype=np.float32) - 0.5)


def generate_baseband(cfg: SynthConfig) -> tuple[np.ndarray, dict]:
    """Generate uint8 voltages (npol, nsamp).

    Returns (samples, info) where info records the sample indices of pulse
    *top-of-band* arrivals and the geometry, for use by recovery tests.
    """
    rng = np.random.default_rng(cfg.seed)
    tsamp = 1.0 / cfg.sample_rate
    buflen = cfg.buflen or cfg.sample_rate // 4
    n_lo, n_hi = smearing_samples(
        cfg.dm, cfg.sample_rate, cfg.freq_bot_mhz,
        cfg.freq_bot_mhz + cfg.bandwidth_mhz / 2,
        cfg.freq_bot_mhz + cfg.bandwidth_mhz)
    n_dm = n_lo + n_hi
    period = max(1, int(round(cfg.pulse_period / tsamp)))
    if buflen < 2 * (n_dm + period):
        raise ValueError("buffer too short for DM smearing + period "
                         "(ref genbase.cu:207-211)")
    ker = _dm_kernel_np(buflen // 2 + 1, cfg.dm, cfg.bandwidth_mhz,
                        cfg.freq_bot_mhz, taper=True)
    new_samps = buflen - n_dm
    end_sample = int(cfg.tobs / tsamp)
    ampls = [1.0 + cfg.amp, 1.0 + cfg.amp * cfg.pol_ratio]

    # per-pol overlap buffers seeded with noise + profile (genbase.cu:312-320)
    ovl = []
    for ipol in range(cfg.npol):
        o = rng.standard_normal(n_dm).astype(np.float32)
        _set_profile(o, 0, period, cfg.skip_period, ampls[ipol], cfg.duty_phase)
        ovl.append(o)
    current = n_dm

    chunks = [[] for _ in range(cfg.npol)]
    while current < end_sample + n_dm:
        for ipol in range(cfg.npol):
            block = np.empty(buflen, np.float32)
            block[:n_dm] = ovl[ipol]
            fresh = rng.standard_normal(new_samps).astype(np.float32)
            _set_profile(fresh, current, period, cfg.skip_period,
                         ampls[ipol], cfg.duty_phase)
            block[n_dm:] = fresh
            ovl[ipol] = block[buflen - n_dm:].copy()
            # disperse: rfft -> chirp (carries 1/N) -> unnormalized irfft
            spec = np.fft.rfft(block)
            disp = np.fft.irfft(spec * ker, n=buflen) * buflen
            # sideband swap (genbase.cu:651-661)
            disp[1::2] *= -1.0
            if cfg.add_rfi:
                _add_rfi(disp, current - n_dm - n_lo, tsamp * 1e6, rng)
            # digitize valid region [n_lo : n_lo + new_samps]
            valid = disp[n_lo:n_lo + new_samps]
            u = np.clip(valid / 0.02957 / 2 + 128.5, 0, 255).astype(np.uint8)
            chunks[ipol].append(u)
        current += new_samps

    samples = np.stack([np.concatenate(c)[:end_sample] for c in chunks])
    # pulse arrival indices (top of band) in the emitted stream: profile
    # peaks at multiples of period (sample counter starts at 0 = first
    # emitted sample + n_lo high-band smearing offset)
    pulses = [p for p in range(0, end_sample, period * cfg.skip_period)]
    moments = measure_moments(samples)
    info = dict(n_dm_samp=n_dm, n_lo=n_lo, n_hi=n_hi, period=period,
                pulse_samples=pulses, tsamp=tsamp, moments=moments)
    return samples, info


def measure_moments(samples: np.ndarray, warn_tol: float = 0.05) -> dict:
    """Runtime statistical self-check of generated baseband (the
    measure_moments role, ref src/genbase.cu:405-420,600-649): the
    digitized stream must look like the intended 8-bit Gaussian —
    mean ~128.5 counts, std ~ the digitizer sigma (1/(2*0.02957) counts).
    Logs a warning when either moment is off by more than warn_tol
    relative (a wrong chirp/profile/digitizer shows up here first)."""
    x = samples.astype(np.float64)
    mean = float(x.mean())
    std = float(x.std())
    expect_mean = 128.5
    expect_std = 1.0 / (2 * 0.02957)
    ok = (abs(mean - expect_mean) / expect_mean <= warn_tol
          and abs(std - expect_std) / expect_std <= warn_tol)
    if not ok:
        import logging
        logging.getLogger("vfast.synth").warning(
            "generated baseband moments off: mean %.2f (expect %.2f), "
            "std %.2f (expect %.2f)", mean, expect_mean, std, expect_std)
    return dict(mean=mean, std=std, expect_mean=expect_mean,
                expect_std=expect_std, ok=ok)


def generate_vdif(cfg: SynthConfig, ref_epoch: int = 40,
                  start_second: int = 0, station_id: int = 1) -> tuple:
    """Full genbase output path: framed VDIF stream (uint8) + info."""
    samples, info = generate_baseband(cfg)
    nsamp = samples.shape[1] - samples.shape[1] % C.VDIF_DATA_BYTES
    stream = vdif.streams_to_frames(samples[:, :nsamp], ref_epoch,
                                    start_second, station_id=station_id,
                                    sample_rate=cfg.sample_rate)
    return stream, info


def white_noise_uint8(nsamp: int, npol: int = 2, seed: int = 0) -> np.ndarray:
    """Flag-free Gaussian 8-bit voltages (no pulse, no dispersion)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((npol, nsamp)).astype(np.float32)
    return np.clip(x / 0.02957 / 2 + 128.5, 0, 255).astype(np.uint8)
