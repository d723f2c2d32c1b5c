"""The comparison that decides `correct`.

For each gulp the run kept (one drawn from the seed among the window's
gulps, and one that holds an injected burst), the plain reference
(portbench/reference/) works out again, from the raw seconds the
benchmark made, every data-second the gulp spans, and searches the gulp,
and these numbers are compared with their limits
(portbench/limits/<cell>.json):

  levels_mismatch   the share of the 2-bit levels of both streams, over
                    the gulp's seconds, that differ from the reference's
  weights_mismatch  the share of the kurtosis weights that differ by more
                    than 1e-6
  bandpass_rel_median
                    the median relative difference of the bandpasses
                    (both streams, both pols, every channel the
                    reference's seconds determine: reference/dsp.py's
                    bp_known) after each of those seconds
  crossings_rel_gap the relative difference between the program's count
                    of S/N threshold crossings in a gulp's whole S/N cube
                    (before the top-k; vfast_gulp_crossings) and the
                    reference's, over the gulps where the reference counts
                    MIN_CROSSINGS or more
  cand_snr_gap      the largest of: the difference between a program
                    candidate's S/N and the reference's at its width,
                    trial and sample; and, for each reference candidate
                    MISS_MARGIN above the least S/N its DM band kept (the
                    threshold, or the band's k-th S/N where the top-k
                    filled), how far it lies above the best program
                    candidate covering its samples (its whole S/N where
                    none does)

The first three judge the DSP programs (the twin and, in the burst's
gulp, the armed one) against the reference's seconds; the last two the
gulp search, which the reference follows from the program's own rows of
the gulp (the program's state at that step), the rows themselves judged
by the first three.  On the reference's own rows the search could not be
judged: their 5e-5 of differing levels alone move a burst's S/N by up to
0.13 and the crossings by up to 1%, as much as searching in bfloat16
does.

The bandpass is compared by its median and not by its widest gap: a
spectrum whose power lies within rounding of the clip (11x the bandpass)
is clipped on one side and not on the other, and the update it then
makes or skips moves that channel's bandpass by up to s x 10 (0.78% at
production) for about a second; the DC and Nyquist channels, whose
powers have one degree of freedom, meet the clip most.  The widest gap
is printed on standard error beside it.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np
import torch

from portbench.reference import dsp as ref_dsp
from portbench.reference import search as ref_search

MISS_MARGIN = 1.0
NUMBERS = ("levels_mismatch", "weights_mismatch", "bandpass_rel_median",
           "crossings_rel_gap", "cand_snr_gap")
MIN_CROSSINGS = 100


@dataclass
class Result:
    values: dict = field(default_factory=dict)
    limits: dict = field(default_factory=dict)
    gulps: int = 0
    masked_share: float = None

    @property
    def correct(self) -> bool:
        return self.gulps > 0 and all(
            np.isfinite(self.values[n]) and self.values[n] <= self.limits[n]
            for n in NUMBERS)

    def compared(self) -> dict:
        return {n: {"value": self.values.get(n), "limit": self.limits[n]}
                for n in NUMBERS}


def unpack2(packed: torch.Tensor) -> torch.Tensor:
    """(rows, nbytes) uint8 -> (rows, 4 nbytes) levels, earlier channels
    in the lower bits."""
    p = packed.to(torch.int32)
    lev = torch.stack([(p >> s) & 3 for s in (0, 2, 4, 6)], dim=-1)
    return lev.reshape(packed.shape[0], -1).to(torch.uint8)


class Tally:
    """The numbers of a run, accumulated over its gulps."""

    def __init__(self):
        self.lev = self.lev_n = self.w = self.w_n = 0
        self.masked = self.masked_n = 0
        self.bp = self.snr_gap = 0.0
        self.bp_rel = []         # relative bandpass differences, known
        self.cross = 0.0         # relative gap of the crossings' counts
        self.worst_bp = None     # where the widest of them was read
        # bandpass entries the reference's seconds do not determine
        self.bp_unknown = self.bp_n = 0

    def second(self, lev, lev_kur, weights, bp, bp_kur, ref, k=-1) -> None:
        dev = ref.levels.device
        for a, b in ((lev, ref.levels), (lev_kur, ref.levels_kur)):
            self.lev += int((a.to(dev) != b).sum())
            self.lev_n += b.numel()
        w = weights.to(dev, torch.float64)
        self.w += int(((w - ref.weights).abs() > 1e-6).sum())
        self.w_n += w.numel()
        self.masked += int((ref.weights < 1.0).sum())
        self.masked_n += ref.weights.numel()
        for stream, (a, b) in enumerate(((bp, ref.bp), (bp_kur, ref.bp_kur))):
            known = ref.bp_known[stream]
            self.bp_unknown += int((~known).sum())
            self.bp_n += known.numel()
            a = a.to(dev, torch.float64)
            rel = torch.where(known, (a - b).abs() / b.abs(), 0.0)
            self.bp_rel.append(rel[known].float().cpu())
            i = int(rel.argmax())
            if float(rel.flatten()[i]) > self.bp:
                self.bp = float(rel.flatten()[i])
                pol, ch = divmod(i, b.shape[1])
                self.worst_bp = (f"second {k} stream {stream} pol {pol} "
                                 f"channel {ch}: program "
                                 f"{float(a[pol, ch])!r}, reference "
                                 f"{float(b[pol, ch])!r}")

    def gulp(self, cands: list, ref: ref_search.GulpResult,
             crossings: int) -> None:
        if ref.n_crossings >= MIN_CROSSINGS:
            self.cross = max(self.cross, abs(crossings - ref.n_crossings)
                             / ref.n_crossings)
        snr = ref.snr
        nw, ndm, nt = snr.shape
        for c in cands:
            t = c.peak_idx - ref.t_offset
            if not (0 <= c.tfilt < nw and 0 <= c.dmi < ndm and 0 <= t < nt):
                self.snr_gap = float("inf")
                continue
            self.snr_gap = max(self.snr_gap,
                               abs(c.snr - float(snr[c.tfilt, c.dmi, t])))
        for r in ref.cands:
            floor = ref.floors[r.dmi // ref.band_trials]
            if r.snr < floor + MISS_MARGIN:
                continue
            cover = [c.snr for c in cands
                     if c.i0 < r.i1 + 2 and r.i0 < c.i1 + 2]
            self.snr_gap = max(self.snr_gap, r.snr - max(cover, default=0.0))

    def values(self) -> dict:
        rel = torch.cat(self.bp_rel) if self.bp_rel else torch.zeros(0)
        return {"levels_mismatch": self.lev / max(self.lev_n, 1),
                "weights_mismatch": self.w / max(self.w_n, 1),
                "bandpass_rel_median": float(rel.double().median())
                if len(rel) else float("nan"),
                "crossings_rel_gap": self.cross,
                "cand_snr_gap": self.snr_gap}


def reference_seconds(cell, staged: list, start: int, stop: int,
                      rows: int, low: bool = False) -> dict:
    """The reference's seconds {k: SecondOut} that the gulp of rows
    [start, stop) spans; with `low`, the control's."""
    g = ref_dsp.Geometry.from_settings(cell.config["dsp"])
    return ref_dsp.run(g, staged, start // rows, (stop - 1) // rows, low)


def gulp_rows(levels: dict, start: int, stop: int, rows: int):
    """The gulp's rows [start, stop) of {second: (rows, nchan) levels}."""
    lo = start // rows
    lev = torch.cat([levels[k] for k in sorted(levels)])
    return lev[start - lo * rows:stop - lo * rows]


def search(cell, levels, start: int, low: bool = False):
    """The reference's search of a gulp's levels (`low`: the control's)."""
    g = ref_dsp.Geometry.from_settings(cell.config["dsp"])
    plan = ref_search.make_plan(cell.config["search"], g, levels.device)
    return ref_search.search(levels, plan, cell.config["search"], start,
                             low)


def check(cell, staged: list, kept: list, rows: int) -> Result:
    """The numbers of the kept gulps (drivers/station.GulpRecord) against the
    reference, with their limits."""
    tally = Tally()
    dev = staged[0].device
    for rec in kept:
        outs = reference_seconds(cell, staged, rec.start, rec.stop, rows)
        for k, o in rec.seconds.items():
            tally.second(unpack2(o["packed"]), unpack2(o["packed_kur"]),
                         o["weights"], o["bp"], o["bp_kur"], outs[k], k)
        lev = gulp_rows({k: unpack2(o["packed_kur"]).to(dev)
                         for k, o in rec.seconds.items()},
                        rec.start, rec.stop, rows)
        res = search(cell, lev, rec.start)
        tally.gulp(rec.cands, res, rec.crossings)
        top = lambda cs: ", ".join(f"(S/N {c.snr:.2f} DM {c.dm:.2f} at "
                                   f"{c.peak_idx})" for c in cs[:4])
        print(f"check: gulp {rec.index} rows [{rec.start}, {rec.stop}): "
              f"program {len(rec.cands)} candidates, {rec.crossings} "
              f"crossings: {top(rec.cands)}; reference {len(res.cands)}, "
              f"{res.n_crossings} crossings: {top(res.cands)}",
              file=sys.stderr, flush=True)
        del outs, res, lev
    print(f"check: widest bandpass difference {tally.bp!r} at "
          f"{tally.worst_bp}; "
          f"{tally.bp_unknown} of {tally.bp_n} bandpass entries not "
          "determined by the reference's seconds", file=sys.stderr,
          flush=True)
    r = Result(values=tally.values(), limits=dict(cell.limits),
               gulps=len(kept))
    r.masked_share = tally.masked / max(tally.masked_n, 1)
    return r
