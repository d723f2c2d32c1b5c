"""The plain float64 reference of the array: one antenna's DSP on the
array's schedule, and the incoherent coadd of the antennas' filterbanks
and its search (agdadacoadd's sum, scripts/start_coadd:22-57, searched by
agtriggerhook -N 8, scripts/start_process:21).

Written from the deployment as the configuration file states it, in plain
torch on any device, importing nothing of the program:

  - an antenna's observation is the staged call fed again and again:
    observation second k is the call's second k % nsec, the FRB armed at
    the top of second inject_sec of every call (the array step's in-graph
    signal test), the bandpasses seeded at the observation's first second
    (reference/dsp.seed) and carried from call to call;
  - the coadd is the sum over the antennas of each beam's dequantized
    2-bit rows, scaled by 1 / sqrt(nant) (the step's agdadacoadd sum),
    over the span a call's search reads: the previous call's last `halo`
    rows, then the call's;
  - every search keeps the array's quota of crossings (`topk`) in each DM
    band, and is otherwise reference/search.search.

`low` computes the control instead (reference/dsp and reference/search's
`low`; the coadd summed in bfloat16, each add rounded).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import dsp as ref_dsp
from portbench.reference import search as ref_search


def since_of(g: ref_dsp.Geometry, k: int, nsec: int, inject_sec: int
             ) -> int:
    """Spectra from the burst's arrival to observation second k's first
    spectrum (-1 before the call's arming second, or without injection)."""
    s = k % nsec
    return (s - inject_sec) * g.spectra if g.inject and s >= inject_sec \
        else -1


def antenna_seconds(g: ref_dsp.Geometry, stream: torch.Tensor, nsec: int,
                    inject_sec: int, first: int, last: int,
                    low: bool = False) -> dict:
    """{k: SecondOut} of observation seconds first..last of one antenna
    whose staged call is `stream` (npol, nsec * rate) uint8, computed from
    Geometry.warmup seconds before `first` (from zero bandpasses) or from
    the observation's start and its seeded bandpasses."""
    rate = g.rate
    sec = lambda k: stream[:, (k % nsec) * rate:(k % nsec + 1) * rate]
    st = ref_dsp.fresh_state(g, stream.device)
    outs = {}
    for k in range(max(0, first - g.warmup), last + 1):
        if k == 0:
            st = ref_dsp.seed(g, sec(0), st, low)
        o, st = ref_dsp.second(g, sec(k), st,
                               since_of(g, k, nsec, inject_sec), low)
        if k >= first:
            outs[k] = o
    return outs


def topk(s: dict) -> int:
    """The crossings a search of the array keeps, before their split into
    DM bands: 16 x max_candidates (a one-card mesh searches each beam's
    whole call, and the coadd's, at one quota)."""
    return max(512, 16 * s["max_candidates"])


def coadd(levels: list, low: bool = False) -> torch.Tensor:
    """The incoherent sum of the beams' (rows, nchanout) 2-bit levels:
    sum_a dequantize(levels_a) / sqrt(nant), float64 (low: bfloat16)."""
    dtype = torch.bfloat16 if low else torch.float64
    fb = ref_search.dequantize(levels[0], dtype)
    for lev in levels[1:]:
        fb = fb + ref_search.dequantize(lev, dtype)
    return fb * torch.tensor(1.0 / math.sqrt(len(levels)), dtype=dtype,
                             device=fb.device)


def search_fb(fb: torch.Tensor, plan: ref_search.Plan, s: dict,
              t_offset: int, low: bool = False) -> ref_search.GulpResult:
    """reference/search.search of a float filterbank (rows, nchanout)."""
    ntime_out = fb.shape[0] - plan.max_delay
    ws = ref_search.widths(s)
    if low:
        snr = ref_search._boxcar_low(ref_search._dedisperse_low(
            fb.to(torch.bfloat16), plan, ntime_out), ws)
    else:
        snr = ref_search.boxcar_snr(ref_search.dedisperse(
            fb.to(torch.float64), plan, ntime_out), ws)
    snr = snr.to(torch.float64)
    nw, ndm, nt = snr.shape
    k = s["topk"] or min(16 * s["max_candidates"], 20000)
    nb = s["topk_dm_bands"]
    nb = nb if nb >= 1 and ndm % nb == 0 else 1
    kb = max(1, min(k // nb, nw * (ndm // nb) * nt))
    thresh = s["snr_thresh"]
    banded = snr.reshape(nw, nb, ndm // nb, nt).transpose(0, 1).reshape(
        nb, -1)
    vals, idx = torch.topk(banded, kb, dim=1)
    vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
    dmb = ndm // nb
    full = kb >= nw * dmb * nt
    floors = np.where((vals.min(axis=1) > thresh) & (not full),
                      vals.min(axis=1), thresh)
    keep = vals > thresh
    band = np.broadcast_to(np.arange(nb)[:, None], vals.shape)[keep]
    j = idx[keep]
    hits = np.stack([j // (dmb * nt), band * dmb + (j // nt) % dmb, j % nt],
                    axis=1)
    cands = ref_search.cluster(hits, vals[keep], plan.dms, ws, t_offset,
                               s["max_candidates"])
    return ref_search.GulpResult(snr=snr, cands=cands, floors=floors,
                                 band_trials=dmb,
                                 n_crossings=int((snr > thresh).sum()),
                                 t_offset=t_offset)
