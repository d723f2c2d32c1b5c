"""The plain float64 reference of an array host: N antennas on the
station's schedule, each beam searched, the incoherent coadd of the
beams searched, and the coincidencer's cuts (kerrm/vlite-fast's one-host
array: process_baseband a stream, heimdall a beam, agdadacoadd's sum
searched by agtriggerhook -N 8, trigger.py's cuts).

Written from the deployment as the configuration file states it, in plain
torch on any device, importing nothing of the program; what the array's
and the station's references already compute is theirs:

  - antenna a's observation second k is its staged[k % K] (K staged
    seconds), the FRB armed at the top of every data-minute, the
    bandpasses seeded at second 0: reference/dsp.run;
  - every beam is searched in gulps of gulp_samps rows plus the DM
    overlap, keeping min(16 x max_candidates, 20000) crossings over the
    DM bands: reference/search.search;
  - the coadd is the sum over the antennas of each beam's dequantized
    2-bit rows scaled by 1 / sqrt(nant) (reference/coadd.coadd), searched
    on the same gulps (reference/coadd.search_fb, at the same quota);
  - a trigger (src/trigger.py:45-65,148-173) is raised by a candidate
    with S/N above snr_thresh that overlaps candidates of at least
    min_beams beams (itself included: DM within delta_dm of each other,
    widths within a ratio delta_w, sample ranges that meet), or by a
    coadd candidate with S/N above coadd_snr_thresh; its width under
    max_width_s and its DM above min_dm.  Its window runs from buffer_pre_s
    before its first sample to buffer_post_s after its last plus the DM
    sweep, at most max_dump_s long; windows that overlap merge, keeping
    the brighter candidate's S/N and DM.
"""

from __future__ import annotations

import torch

from portbench.reference import coadd as ref_coadd
from portbench.reference import dsp as ref_dsp
from portbench.reference import search as ref_search

# seconds of sweep a unit of DM adds to a dump window: src/trigger.py:33's
# 4.15e-3 s GHz^2 over the 320-384 MHz band
DM_DELAY_S = 4.15e-3 * (0.320 ** -2 - 0.384 ** -2)


def antenna_seconds(g: ref_dsp.Geometry, staged: list, first: int,
                    last: int, low: bool = False) -> dict:
    """{k: SecondOut} of one antenna's observation seconds first..last
    (reference/dsp.run on its staged seconds)."""
    return ref_dsp.run(g, staged, first, last, low)


def gulp_span(s: dict, plan: ref_search.Plan, g: int) -> tuple:
    """Rows [start, stop) gulp g of a stream searches."""
    start = g * s["gulp_samps"]
    return start, start + s["gulp_samps"] + plan.max_delay


def search_beam(levels: torch.Tensor, plan: ref_search.Plan, s: dict,
                t_offset: int, low: bool = False) -> ref_search.GulpResult:
    """One beam's gulp of (rows, nchanout) 2-bit levels."""
    return ref_search.search(levels, plan, s, t_offset, low)


def search_coadd(levels: list, plan: ref_search.Plan, s: dict,
                 t_offset: int, low: bool = False) -> ref_search.GulpResult:
    """The coadd of the beams' levels over one gulp, searched."""
    return ref_coadd.search_fb(ref_coadd.coadd(levels, low), plan, s,
                               t_offset, low)


def _meets(a, b, tsamp: float, delta_dm: float, delta_w: float) -> bool:
    """Two candidates of a coincidence (src/candidate.py:49-64)."""
    if b.dm == 0 or abs(a.dm / b.dm - 1.0) > delta_dm:
        return False
    wa = max((a.i1 - a.i0) * tsamp, 1e-9)
    wb = max((b.i1 - b.i0) * tsamp, 1e-9)
    if max(wa, wb) / min(wa, wb) > delta_w:
        return False
    return a.i0 < b.i1 and b.i0 < a.i1


def triggers(per_beam: dict, coadd_beam: int, tsamp: float, t: dict,
             utc0: float) -> list:
    """The triggers of candidates {beam: [candidate]} (each with dm, snr,
    i0, i1, the first and one past the last sample), as dicts of t0, t1,
    dm, sn; `t` holds the cuts (TriggerConfig's fields)."""
    allc = [(b, c) for b in sorted(per_beam) for c in per_beam[b]]
    raised = []
    for b, c in allc:
        coadd = b == coadd_beam
        beams = {b2 for b2, c2 in allc
                 if _meets(c, c2, tsamp, t["delta_dm"], t["delta_w"])}
        width = (c.i1 - c.i0) * tsamp
        if (not coadd and len(beams) < t["min_beams"]) \
                or width >= t["max_width_s"] or c.dm <= t["min_dm"] \
                or c.snr <= (t["coadd_snr_thresh"] if coadd
                             else t["snr_thresh"]):
            continue
        t0 = utc0 + c.i0 * tsamp - t["buffer_pre_s"]
        t1 = t0 + width + c.dm * DM_DELAY_S + t["buffer_pre_s"] \
            + t["buffer_post_s"]
        raised.append({"t0": t0, "t1": min(t1, t0 + t["max_dump_s"]),
                       "dm": c.dm, "sn": c.snr})
    merged = []
    for r in sorted(raised, key=lambda r: r["t0"]):
        last = merged[-1] if merged else None
        if last and r["t0"] < last["t1"] \
                and max(r["t1"], last["t1"]) - last["t0"] <= t["max_dump_s"]:
            last["t1"] = max(last["t1"], r["t1"])
            if r["sn"] > last["sn"]:
                last["sn"], last["dm"] = r["sn"], r["dm"]
        else:
            merged.append(dict(r))
    return merged
