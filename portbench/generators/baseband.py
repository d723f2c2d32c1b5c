"""Baseband traffic: K seconds of one station's raw voltages (unit
Gaussian receiver noise, with what the mix adds), made on the device
from the seed, which a station driver cycles.

A traffic mix (portbench/traffic/<name>.json) names its generator under
"generator"; this one ("baseband") reads:

  seconds        K, the seconds made (second k of the observation is
                 staged[k % K]); K prime to 60 puts each data-minute's
                 injected burst on another of them
  pulsar         optional: genbase's periodic pulse (ref src/genbase.cu
                 defaults), the same on both pols: "dm", "period_s",
                 "amp" (a fraction of Tsys on the voltages of the pulse
                 window), "duty" (the window as a share of the period);
                 the stream is dispersed coherently at "dm" by a chirp
                 (genbase's transfer function and band taper) applied
                 circularly over the K seconds, so that the cycled stream
                 is seamless; K * rate must hold a whole number of periods
  digitize       8-bit offset binary: u = clip(x / "scale" + "offset", 0,
                 255), truncated

Everything is made with a torch.Generator on the device in a few large
calls per second and pol; the same seed gives the same bytes.
"""

from __future__ import annotations

import math

import torch

DM_CONST_GENBASE = 1.0 / 2.41e-10   # genbase's dispersion constant (us MHz^2)


def _chirp(nfreq: int, dm: float, bandwidth_mhz: float, freq_bot_mhz: float,
           lo: int, hi: int, device) -> torch.Tensor:
    """genbase's dispersion transfer function on rfft bins [lo, hi), with
    its asymmetric band taper (ref src/genbase.cu:525-552); bin nfreq - 1
    is the top of the band."""
    i = torch.arange(lo, hi, dtype=torch.float64, device=device)
    f = bandwidth_mhz * i / (nfreq - 1)
    f0 = freq_bot_mhz
    arg = (2 * math.pi * dm * DM_CONST_GENBASE) * f * f / (f0 * f0 * (f0 + f))
    arg = torch.remainder(arg, 2 * math.pi)
    fn = f / bandwidth_mhz
    taper = (1 - torch.exp(-(fn * fn) / 0.05 ** 2)
             - torch.exp(-((1 - fn) ** 2) / 0.10 ** 2)) * (1 + 0.20 * fn)
    return torch.polar(taper, arg).to(torch.complex64)


def _pol_stream(t: dict, dsp: dict, gen: torch.Generator,
                device) -> torch.Tensor:
    """One pol's K seconds as float32 voltages in units of the noise."""
    rate = dsp["sample_rate"]
    n = t["seconds"] * rate
    x = torch.randn(n, generator=gen, device=device)
    p = t.get("pulsar")
    if p:
        period = int(round(p["period_s"] * rate))
        if n % period:
            raise ValueError("the staged seconds must hold whole periods")
        ampl = 1.0 + p["amp"]
        on = int(math.ceil(p["duty"] * period))
        x.view(-1, period)[:, :on] *= ampl
        nfreq = n // 2 + 1
        spec = torch.fft.rfft(x)
        del x
        step = 1 << 25
        for lo in range(0, nfreq, step):
            hi = min(lo + step, nfreq)
            spec[lo:hi] *= _chirp(nfreq, p["dm"], dsp["bandwidth_mhz"],
                                  dsp["freq_top_mhz"] - dsp["bandwidth_mhz"],
                                  lo, hi, device)
        x = torch.fft.irfft(spec, n=n)
        del spec
        x[1::2] *= -1.0          # to VLITE's sideband sense (genbase.cu:651)
    return x


def staged_seconds(t: dict, dsp: dict, seed: int, device) -> list:
    """[K tensors (npol, rate) uint8] of traffic `t` for the configuration's
    "dsp" settings, from `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    rate, npol = dsp["sample_rate"], dsp["npol_in"]
    d = t["digitize"]
    out = torch.empty((t["seconds"], npol, rate), dtype=torch.uint8,
                      device=device)
    for pol in range(npol):
        x = _pol_stream(t, dsp, gen, device)
        for k in range(t["seconds"]):
            seg = x[k * rate:(k + 1) * rate]
            out[k, pol] = torch.clamp(seg / d["scale"] + d["offset"],
                                      0.0, 255.0).to(torch.uint8)
        del x
    return list(out.unbind(0))

