"""Array traffic: one call of N antennas' raw voltages (unit Gaussian
receiver noise), made on the device from the seed; the array driver
writes it in place into the step's own buffer and feeds it again on
every call.

A traffic mix (portbench/traffic/<name>.json) names its generator under
"generator"; this one ("array_baseband") reads:

  seconds        the distinct data-seconds an antenna: the staged call
  digitize       8-bit offset binary: u = clip(x / "scale" + "offset", 0,
                 255), truncated

Antenna a's noise comes from a torch.Generator of its own, seeded with
the a-th 63-bit number that random.Random(seed) draws, so the antennas
are independent, one antenna's stream can be made alone, and the same
seed gives the same bytes.  Each antenna's pols and seconds are made in
turn, one second of one pol at a time, so that nothing beside the
buffer is ever larger than one such second.
"""

from __future__ import annotations

import random

import torch


def antenna_seeds(seed: int, nant: int) -> list:
    """The seed of each of the first `nant` antennas' generators."""
    rng = random.Random(seed)
    return [rng.getrandbits(63) for _ in range(nant)]


def _fill(t: dict, out: torch.Tensor, rate: int, seed: int) -> None:
    """out (npol, seconds * rate) uint8 <- one antenna's voltages."""
    d = t["digitize"]
    if out.shape[1] != t["seconds"] * rate:
        raise ValueError(f"a call of {t['seconds']} s holds "
                         f"{t['seconds'] * rate} samples a pol, not "
                         f"{out.shape[1]}")
    gen = torch.Generator(device=out.device)
    gen.manual_seed(seed)
    for pol in range(out.shape[0]):
        for lo in range(0, out.shape[1], rate):
            x = torch.randn(rate, generator=gen, device=out.device)
            out[pol, lo:lo + rate] = torch.clamp(
                x / d["scale"] + d["offset"], 0.0, 255.0).to(torch.uint8)


def fill_call(t: dict, raw: torch.Tensor, rate: int, seed: int) -> None:
    """raw (nant, npol, seconds * rate) uint8 <- traffic `t`'s call of
    every antenna, from `seed`."""
    for a, s in enumerate(antenna_seeds(seed, raw.shape[0])):
        _fill(t, raw[a], rate, s)


def antenna_call(t: dict, dsp: dict, seed: int, antenna: int,
                 device) -> torch.Tensor:
    """Antenna `antenna`'s staged call alone, (npol, seconds * rate)
    uint8: the bytes fill_call writes in its row."""
    rate = dsp["sample_rate"]
    out = torch.empty((dsp["npol_in"], t["seconds"] * rate),
                      dtype=torch.uint8, device=device)
    _fill(t, out, rate, antenna_seeds(seed, antenna + 1)[antenna])
    return out


def staged_seconds(t: dict, dsp: dict, seed: int, device,
                   antenna: int = 0) -> list:
    """[seconds tensors (npol, rate) uint8]: one antenna's staged call, a
    station's view of it."""
    return list(antenna_call(t, dsp, seed, antenna, device).split(
        dsp["sample_rate"], dim=1))
