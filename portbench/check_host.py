"""The comparison that decides `correct` in a cell of the array host.

The run keeps two gulps of its window: the burst's (the gulp that holds
the window's first data-second, the top of a data-minute, where the FRB
is armed) and one drawn from the seed among the window's others that
the drawn beam and the coadd searched, and one antenna (drawn from the
seed before the run, `draw`); the plain reference
(portbench/reference/host.py) is compared with what the program made.
The run is not correct unless the burst's gulp was searched, and a
trigger raised, in the window:

  DSP       that antenna's outputs of a second of each kept gulp (the
            burst's armed first second, the other's drawn from the seed)
            and of the observation's first second (the armed one, from
            the seeded bandpasses), against the reference's
            seconds worked out from its staged seconds over the warm-up
            before each: levels_mismatch, weights_mismatch,
            bandpass_rel_median, as check.py reads them
  beam      that beam's kept gulps from the program's rows, through the
            reference search: crossings_rel_gap and cand_snr_gap against
            that beam's crossings count and candidates, as check.py reads
            them
  coadd     the reference coadd of every antenna's rows of each gulp,
            searched: coadd_crossings_rel_gap and coadd_snr_gap against
            the coadd's crossings count and candidates (the program sums
            in float32 and keeps float16; the reference sums in float64)
  dumps     dump_bytes_mismatch: the share of the bytes that differ
            between each dump and the fed seconds it lists, a second the
            dumps of a trigger at the injected DM should hold and do not
            counting as a second of differing bytes
  trigger   trigger_dm_rel_gap: the relative distance to the injected DM
            of the nearest DM of the triggers raised in the window, so
            with their dumps queued in it (inf without one)

Limits: limits/<cell>.json.
"""

from __future__ import annotations

import os
import random
import sys
from dataclasses import dataclass, field

import numpy as np
import torch

from portbench import check as station_check
from portbench import check_array
from portbench.reference import dsp as ref_dsp
from portbench.reference import host as ref_host
from portbench.reference import search as ref_search

NUMBERS = check_array.NUMBERS + ("dump_bytes_mismatch",
                                 "trigger_dm_rel_gap")


@dataclass
class Kept:
    """One gulp of the window, as the program left it."""

    gulp: int               # its index in the observation
    start: int              # its first row
    ant: int                # the antenna whose DSP and beam are compared
    seconds: dict           # k -> the program's outputs of antenna ant's
                            # second k (packed, packed_kur, weights, bp,
                            # bp_kur)
    rows: list              # each antenna's packed rows of the gulp
    beam_cands: list
    beam_crossings: int
    coadd_cands: list
    coadd_crossings: int
    burst: bool = False     # the window's burst's gulp


@dataclass
class Result:
    values: dict = field(default_factory=dict)
    limits: dict = field(default_factory=dict)
    gulps: int = 0
    burst: bool = False     # the burst's gulp compared
    masked_share: float = None

    @property
    def correct(self) -> bool:
        return self.burst and all(
            np.isfinite(self.values[n]) and self.values[n] <= self.limits[n]
            for n in NUMBERS)

    def compared(self) -> dict:
        return {n: {"value": self.values.get(n), "limit": self.limits[n]}
                for n in NUMBERS}


def draw(seed: int, nant: int) -> tuple:
    """(rng, antenna) a run with `seed` compares; rng then draws the gulp
    and its second."""
    rng = random.Random(seed)
    return rng, rng.randrange(nant)


def dump_mismatch(dumps: list, staged: dict, unix0: float, triggers: list,
                  inject_dm: float) -> float:
    """dump_bytes_mismatch of `dumps` (DumpRecords, files named
    ..._ea<station>_...) against the fed seconds (`staged`: station id ->
    its staged seconds as host arrays, second k being staged[k % K])."""
    bad = total = 0
    holds = {}              # (station, second) of the dumps
    for rec in dumps:
        sid = int(os.path.basename(rec.path).split("_ea")[1][:2])
        with open(rec.path, "rb") as fp:
            got = np.frombuffer(fp.read(), np.uint8)
        secs = staged[sid]
        want = np.concatenate([secs[int(s - unix0) % len(secs)].reshape(-1)
                               for s in rec.seconds]) if rec.seconds \
            else np.zeros(0, np.uint8)
        n = min(len(got), len(want))
        bad += int(np.count_nonzero(got[:n] != want[:n])) \
            + abs(len(got) - len(want))
        total += max(len(got), len(want))
        holds.update({(sid, int(s)): True for s in rec.seconds})
    per_second = next(iter(staged.values()))[0].size
    for t in triggers:
        if abs(t.dm - inject_dm) > 0.1 * inject_dm:
            continue
        burst = int(unix0 + t.peak_time)
        for sid in staged:
            if (sid, burst) not in holds:
                bad += per_second
                total += per_second
    return bad / total if total else float("nan")


def in_window(triggers: list, raised: list, k0: int, n: int) -> list:
    """The triggers raised after one of data-seconds k0..k0 + n - 1 was
    fed (`raised`: each one's data-seconds fed when it was raised), so
    with their dumps queued inside the window."""
    return [t for t, at in zip(triggers, raised) if k0 < at <= k0 + n]


def trigger_gap(triggers: list, inject_dm: float) -> float:
    return min((abs(t.dm - inject_dm) / inject_dm for t in triggers),
               default=float("inf"))


def check(cell, staged: list, kept: list, dumps_bad: float,
          trig_gap: float) -> Result:
    """The numbers of the kept gulps against the reference; `staged` is
    the kept antenna's staged seconds on the device where the reference
    runs."""
    g = ref_dsp.Geometry.from_settings(cell.config["dsp"])
    s = cell.config["search"]
    dev = staged[0].device
    tally, co_tally = station_check.Tally(), station_check.Tally()
    plan = ref_search.make_plan(s, g, dev)
    for kp in kept:
        for k, o in sorted(kp.seconds.items()):
            ref = ref_host.antenna_seconds(g, staged, k, k)[k]
            tally.second(station_check.unpack2(o["packed"]),
                         station_check.unpack2(o["packed_kur"]),
                         o["weights"], o["bp"], o["bp_kur"], ref, k)
            del ref
        lev = [station_check.unpack2(torch.as_tensor(r).to(dev))
               for r in kp.rows]
        res = ref_host.search_beam(lev[kp.ant], plan, s, kp.start)
        tally.gulp(kp.beam_cands, res, kp.beam_crossings)
        check_array._log(f"gulp {kp.gulp} beam {kp.ant}", kp.beam_cands,
                         kp.beam_crossings, res)
        del res
        res = ref_host.search_coadd(lev, plan, s, kp.start)
        del lev
        co_tally.gulp(kp.coadd_cands, res, kp.coadd_crossings)
        check_array._log(f"gulp {kp.gulp} coadd", kp.coadd_cands,
                         kp.coadd_crossings, res)
        del res
    print(f"check: widest bandpass difference {tally.bp!r} at "
          f"{tally.worst_bp}", file=sys.stderr, flush=True)
    vals = check_array.numbers(tally, co_tally)
    vals["dump_bytes_mismatch"] = dumps_bad
    vals["trigger_dm_rel_gap"] = trig_gap
    r = Result(values=vals, limits=dict(cell.limits), gulps=len(kept),
               burst=any(kp.burst for kp in kept))
    r.masked_share = tally.masked / max(tally.masked_n, 1)
    return r
