"""The comparison that decides `correct` in a cell of the array step.

The run keeps one call of its window (drawn from the seed among the
window's calls) and, in that call, one antenna and one of its seconds
(drawn from the seed before the window, `draw`), and the plain reference
(portbench/reference/) is compared with what the program made there:

  DSP       that antenna's outputs of the drawn second and of the call's
            injected second, against reference/coadd.antenna_seconds
            worked out from the staged call over the warm-up seconds
            before each (taken modulo the call's seconds):
            levels_mismatch, weights_mismatch, bandpass_rel_median, as
            check.py reads them
  beam      that beam's search span (the previous call's last `halo`
            rows, then the call's) from the program's rows, through the
            reference search at the array's quota: crossings_rel_gap and
            cand_snr_gap against that beam's crossings count and
            candidates, as check.py reads them
  coadd     the reference coadd of every antenna's rows of the same span
            (reference/coadd.coadd), searched: coadd_crossings_rel_gap
            and coadd_snr_gap against the program's coadd crossings count
            and candidates, read as the beam's are

The search numbers read the program's own rows, judged by the DSP
numbers of one antenna; the coadd numbers judge the sum, its scale and
its search from every antenna's rows.  Limits: limits/<cell>.json.
"""

from __future__ import annotations

import random
import sys
from dataclasses import dataclass, field

import numpy as np
import torch

from portbench import check as station_check
from portbench.reference import coadd as ref_coadd
from portbench.reference import dsp as ref_dsp
from portbench.reference import search as ref_search

NUMBERS = station_check.NUMBERS + ("coadd_crossings_rel_gap",
                                   "coadd_snr_gap")


@dataclass
class Kept:
    """One call of the window, as the program left it."""

    call: int               # its index in the observation
    ant: int                # the antenna whose DSP is compared
    seconds: dict           # s -> the program's outputs of antenna ant's
                            # second s of the call (packed, packed_kur,
                            # weights, bp, bp_kur)
    rows: np.ndarray        # (nant, T, nbytes) the call's packed rows
    tail: np.ndarray        # (nant, halo, nbytes) the previous call's last
    beam_cands: list        # antenna ant's candidates
    beam_crossings: int     # antenna ant's crossings count
    coadd_cands: list
    coadd_crossings: int


@dataclass
class Result:
    values: dict = field(default_factory=dict)
    limits: dict = field(default_factory=dict)
    calls: int = 0
    masked_share: float = None

    @property
    def correct(self) -> bool:
        return self.calls > 0 and all(
            np.isfinite(self.values[n]) and self.values[n] <= self.limits[n]
            for n in NUMBERS)

    def compared(self) -> dict:
        return {n: {"value": self.values.get(n), "limit": self.limits[n]}
                for n in NUMBERS}


def draw(seed: int, nant: int, nsec: int) -> tuple:
    """(rng, antenna, second) a run with `seed` compares; rng then draws
    the call."""
    rng = random.Random(seed)
    return rng, rng.randrange(nant), rng.randrange(nsec)


def settings(cell):
    """(Geometry, the search's settings at the array's quota, nsec,
    inject_sec) of a cell of the array."""
    s = cell.config["search"]
    arr = cell.config["array"]
    return (ref_dsp.Geometry.from_settings(cell.config["dsp"]),
            dict(s, topk=ref_coadd.topk(s)), arr["nsec_per_call"],
            arr["inject_sec"])


def span_levels(rows, tail, device) -> torch.Tensor:
    """(halo + T, nchanout) levels of a beam's search span, on `device`."""
    return station_check.unpack2(torch.cat([torch.as_tensor(tail),
                                    torch.as_tensor(rows)]).to(device))


def check(cell, stream: torch.Tensor, kept: list) -> Result:
    """The numbers of the kept calls against the reference; `stream` is
    the staged call of the kept antenna, (npol, nsec * rate) uint8."""
    g, s, nsec, inject_sec = settings(cell)
    dev = stream.device
    tally, co_tally = station_check.Tally(), station_check.Tally()
    plan = ref_search.make_plan(s, g, dev)
    for kp in kept:
        for sec, o in sorted(kp.seconds.items()):
            k = kp.call * nsec + sec
            ref = ref_coadd.antenna_seconds(g, stream, nsec, inject_sec, k,
                                            k)[k]
            tally.second(station_check.unpack2(o["packed"]),
                         station_check.unpack2(o["packed_kur"]),
                         o["weights"], o["bp"], o["bp_kur"], ref, k)
            del ref
        t0 = kp.call * kp.rows.shape[1] - kp.tail.shape[1]
        lev = [span_levels(r, t, dev) for r, t in zip(kp.rows, kp.tail)]
        res = ref_search.search(lev[kp.ant], plan, s, t0)
        tally.gulp(kp.beam_cands, res, kp.beam_crossings)
        _log(f"call {kp.call} beam {kp.ant}", kp.beam_cands,
             kp.beam_crossings, res)
        del res
        res = ref_coadd.search_fb(ref_coadd.coadd(lev), plan, s, t0)
        del lev
        co_tally.gulp(kp.coadd_cands, res, kp.coadd_crossings)
        _log(f"call {kp.call} coadd", kp.coadd_cands, kp.coadd_crossings,
             res)
        del res
    print(f"check: widest bandpass difference {tally.bp!r} at "
          f"{tally.worst_bp}", file=sys.stderr, flush=True)
    r = Result(values=numbers(tally, co_tally), limits=dict(cell.limits),
               calls=len(kept))
    r.masked_share = tally.masked / max(tally.masked_n, 1)
    return r


def numbers(tally, co_tally) -> dict:
    """check_array.NUMBERS of the DSP and beam tally and the coadd's."""
    vals = tally.values()
    vals["coadd_crossings_rel_gap"] = co_tally.cross
    vals["coadd_snr_gap"] = co_tally.snr_gap
    return vals


def _log(what: str, cands: list, crossings: int, res) -> None:
    top = lambda cs: ", ".join(f"(S/N {c.snr:.2f} DM {c.dm:.2f} at "
                               f"{c.peak_idx})" for c in cs[:4])
    print(f"check: {what}: program {len(cands)} candidates, {crossings} "
          f"crossings: {top(cands)}; reference {len(res.cands)}, "
          f"{res.n_crossings} crossings: {top(res.cands)}",
          file=sys.stderr, flush=True)
