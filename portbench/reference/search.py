"""The plain float64 reference of one gulp's single-pulse search.

Written from the algorithm as the configuration file's "search" settings
state it (heimdall's role, scripts/start_heimdall_single_antenna:21),
importing nothing of the program: dequantize the 2-bit rows to their
level centroids -> two-stage subband dedispersion over the DM grid (the
subband decomposition, nsub and the stage-1 batches, is the search's
definition: each trial's delays are those of its batch's representative
within a subband) -> boxcar matched filter S/N (mean removed, noise from
the median absolute deviation) -> the k largest S/N of each contiguous
DM band -> friends-of-friends clustering into candidates.

Every sum is float64; the gather form of the shift-and-sum runs on any
device.  `low` computes the control instead (check.py): the float32
search one step lower, in bfloat16 throughout as a kernel without
float32 accumulators would run it (`_dedisperse_low`, `_boxcar_low`):
every add of the subband sums, the trials' sums and the boxcars' doubling
rounds to bfloat16.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.dsp import LEVEL2_CENTROIDS, Geometry

DM_CONST_S = 4.148808e3          # s MHz^2 / (pc cm^-3)
MAD_TO_SIGMA = 1.4826
NOISE_SUBSAMPLE = 8192


def dm_grid(s: dict, tsamp: float, freqs_mhz: np.ndarray) -> np.ndarray:
    """'tol': trials stepped so that the smearing stays within dm_tol of
    matched (dedisp's -dm_tol), padded past dm_max by the last step to a
    multiple of 128; 'linear': ndm even trials."""
    if s["dm_grid_mode"] != "tol":
        return np.linspace(s["dm_min"], s["dm_max"], s["ndm"])
    f = np.asarray(freqs_mhz, np.float64)
    sweep = DM_CONST_S * (f.min() ** -2.0 - f.max() ** -2.0)
    chan_sweep = sweep / len(f)
    tol = s["dm_tol"]
    dms = [s["dm_min"]]
    while dms[-1] < s["dm_max"]:
        weff2 = tsamp ** 2 + (dms[-1] * chan_sweep) ** 2
        dms.append(dms[-1] + 2.0 * np.sqrt((tol * tol - 1.0) * weff2)
                   / sweep)
    dms = np.asarray(dms, np.float64)
    pad = (-len(dms)) % 128
    if pad and len(dms) >= 2:
        dms = np.concatenate([dms, dms[-1] + (dms[-1] - dms[-2])
                              * np.arange(1, pad + 1)])
    return dms


@dataclass
class Plan:
    dms: np.ndarray
    rel: torch.Tensor        # (nbatch, nchan) in-subband delays
    sub: torch.Tensor        # (ndm, nsub) subband delays
    per_batch: int           # trials a batch
    weights: torch.Tensor    # (nchan,) 0 where zapped
    max_delay: int
    max_sub_delay: int
    nsub: int
    nchan_eff: float


def make_plan(s: dict, g: Geometry, device) -> Plan:
    freqs = g.freqs_mhz()
    dms = dm_grid(s, g.tsamp, freqs)
    nchan, ndm = len(freqs), len(dms)
    # the station's search: nsub subbands, min(ndm, nbatch) stage-1
    # batches, each lowered until it divides
    nsub = min(s["nsub"], nchan)
    while nchan % nsub:
        nsub -= 1
    nbatch = min(ndm, s["ndm"], s["nbatch"])
    while ndm % nbatch:
        nbatch -= 1
    fref = float(np.max(freqs))
    full = np.round(DM_CONST_S * dms[:, None] * (freqs[None, :] ** -2.0
                                                 - fref ** -2.0)
                    / g.tsamp).astype(np.int64)
    w = nchan // nsub
    sub = full[:, np.arange(nsub) * w]
    per = ndm // nbatch
    rep = np.arange(nbatch) * per + (per - 1) // 2
    rel = full[rep] - np.repeat(sub[rep], w, axis=1)
    mask = np.ones(nchan)
    for lo, hi in s["zap_ranges"]:
        mask[lo:hi] = 0.0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return Plan(dms=dms, rel=t(rel), sub=t(sub), per_batch=per,
                weights=t(mask), max_delay=int(full.max()),
                max_sub_delay=int(sub.max()), nsub=nsub,
                nchan_eff=float(mask.sum()))


def dequantize(levels: torch.Tensor, dtype=torch.float64
               ) -> torch.Tensor:
    cent = torch.tensor(LEVEL2_CENTROIDS, dtype=dtype, device=levels.device)
    return cent[levels.to(torch.int64)]


def dedisperse(fb: torch.Tensor, plan: Plan, ntime_out: int) -> torch.Tensor:
    """(ntime, nchan) f64 -> (ndm, ntime_out) DM-time sums."""
    ntime, nchan = fb.shape
    w = nchan // plan.nsub
    dev = fb.device
    fbz = fb * plan.weights[None, :]
    t1_len = ntime_out + plan.max_sub_delay
    t1 = torch.arange(t1_len, device=dev)
    t = torch.arange(ntime_out, device=dev)
    out = torch.empty((len(plan.dms), ntime_out), dtype=fb.dtype,
                      device=dev)
    per = plan.per_batch
    for b, rel_b in enumerate(plan.rel):
        idx = (t1[:, None] + rel_b[None, :]).clamp(0, ntime - 1)
        y = torch.gather(fbz, 0, idx).reshape(t1_len, plan.nsub, w).sum(-1)
        sub_b = plan.sub[b * per:(b + 1) * per]              # (per, nsub)
        for lo in range(0, per, 8):
            d = sub_b[lo:lo + 8]
            gi = t[None, :, None] + d[:, None, :]           # (c, T, nsub)
            out[b * per + lo:b * per + lo + len(d)] = torch.gather(
                y.expand(len(d), t1_len, plan.nsub), 1, gi).sum(-1)
    return out


def _dedisperse_low(fb: torch.Tensor, plan: Plan, ntime_out: int
                    ) -> torch.Tensor:
    """dedisperse with every add rounded to bfloat16, term by term."""
    ntime, nchan = fb.shape
    w = nchan // plan.nsub
    dev = fb.device
    fbz = (fb * plan.weights.to(fb.dtype)[None, :]).to(torch.bfloat16)
    t1_len = ntime_out + plan.max_sub_delay
    t1 = torch.arange(t1_len, device=dev)
    ys = []
    for rel_b in plan.rel:
        idx = (t1[:, None] + rel_b[None, :]).clamp(0, ntime - 1)
        g = torch.gather(fbz, 0, idx).reshape(t1_len, plan.nsub, w)
        y = g[:, :, 0]
        for c in range(1, w):
            y = y + g[:, :, c]
        ys.append(y)
    y = torch.stack(ys)                               # (nbatch, t1, nsub)
    b_idx = torch.arange(len(plan.dms), device=dev) // plan.per_batch
    t = torch.arange(ntime_out, device=dev)
    out = torch.zeros((len(plan.dms), ntime_out), dtype=torch.bfloat16,
                      device=dev)
    for sb in range(plan.nsub):
        ti = t[None, :] + plan.sub[:, sb:sb + 1]
        out = out + y[b_idx[:, None], ti, sb]
    return out


def _boxcar_low(dmt: torch.Tensor, widths: tuple) -> torch.Tensor:
    """boxcar_snr in bfloat16: the boxes by doubling, box_2w[t] = box_w[t]
    + box_w[t - w], each add rounded."""
    ndm, ntime = dmt.shape
    x = (dmt.float() - dmt.float().mean(dim=1, keepdim=True)).to(
        torch.bfloat16)
    step = max(1, ntime // NOISE_SUBSAMPLE)
    srt = x[:, ::step].abs().sort(dim=1).values
    n = srt.shape[1]
    sigma = (MAD_TO_SIGMA * 0.5 * (srt[:, (n - 1) // 2] + srt[:, n // 2])
             ).clamp(min=1e-6)[:, None]
    outs, box, cur = [], x, 1
    for w in widths:
        while cur < w:
            nxt = torch.zeros_like(box)
            nxt[:, cur:] = box[:, cur:] + box[:, :-cur]
            box, cur = nxt, 2 * cur
        valid = torch.zeros_like(box)
        valid[:, w - 1:] = box[:, w - 1:]
        outs.append(valid / (sigma * np.sqrt(w)).to(torch.bfloat16))
    return torch.stack(outs)


def boxcar_snr(dmt: torch.Tensor, widths: tuple) -> torch.Tensor:
    """(ndm, ntime) -> (nwidth, ndm, ntime) S/N of the box [t-w+1, t]
    (0 for t < w - 1): mean removed per trial, noise 1.4826 x the median
    |deviation| of every (ntime // 8192)-th sample (the mean of the two
    middle values for an even count)."""
    ndm, ntime = dmt.shape
    x = dmt - dmt.mean(dim=1, keepdim=True)
    step = max(1, ntime // NOISE_SUBSAMPLE)
    srt = x[:, ::step].abs().sort(dim=1).values
    n = srt.shape[1]
    sigma = MAD_TO_SIGMA * 0.5 * (srt[:, (n - 1) // 2] + srt[:, n // 2])
    sigma = sigma.clamp(min=1e-6)[:, None]
    cs = torch.cat([torch.zeros((ndm, 1), dtype=x.dtype, device=x.device),
                    torch.cumsum(x, dim=1)], dim=1)
    outs = []
    for w in widths:
        box = torch.zeros_like(x)
        box[:, w - 1:] = cs[:, w:] - cs[:, :-w]
        outs.append(box / (sigma * np.sqrt(w)))
    return torch.stack(outs)


class Candidate(NamedTuple):
    snr: float
    peak_idx: int
    tfilt: int
    dmi: int
    dm: float
    ngiant: int
    i0: int
    i1: int


def cluster(hits: np.ndarray, vals: np.ndarray, dms: np.ndarray,
            widths: tuple, t_offset: int, max_cands: int,
            dm_link: int = 4, time_gap: int = 2) -> list:
    """Friends of friends: two crossings [width, trial, box end] are
    friends when their boxes overlap within time_gap samples and their
    trials lie within dm_link; each cluster is one candidate at its
    largest S/N; the max_cands largest are kept."""
    n = len(vals)
    if n == 0:
        return []
    parent = np.arange(n)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    w_arr = np.asarray(widths)[hits[:, 0]]
    lo = hits[:, 2] - w_arr + 1
    hi = hits[:, 2] + 1
    dmi = hits[:, 1]
    by_trial: dict = {}
    for i in np.argsort(lo, kind="stable"):
        by_trial.setdefault(int(dmi[i]), []).append(int(i))
    for d, members in by_trial.items():
        for delta in range(dm_link + 1):
            other = by_trial.get(d + delta)
            if other is None or (delta == 0 and len(members) < 2):
                continue
            merged = members if delta == 0 else sorted(
                members + other, key=lambda i: lo[i])
            rep, run_hi = merged[0], hi[merged[0]]
            for i in merged[1:]:
                if lo[i] < run_hi + time_gap:
                    ra, rb = find(rep), find(i)
                    if ra != rb:
                        parent[rb] = ra
                    run_hi = max(run_hi, int(hi[i]))
                else:
                    rep, run_hi = i, int(hi[i])
    groups: dict = {}
    for i in range(n):
        groups.setdefault(find(i), []).append(i)
    cands = []
    for m in groups.values():
        m = np.asarray(m)
        k = m[np.argmax(vals[m])]
        iw, idm, it = (int(v) for v in hits[k])
        cands.append(Candidate(
            snr=float(vals[k]), peak_idx=it + t_offset,
            tfilt=int(np.log2(widths[iw])), dmi=idm, dm=float(dms[idm]),
            ngiant=len(m), i0=int(lo[m].min()) + t_offset,
            i1=int(hi[m].max()) + t_offset))
    cands.sort(key=lambda c: -c.snr)
    return cands[:max_cands]


@dataclass
class GulpResult:
    snr: torch.Tensor        # (nwidth, ndm, ntime_out) f64
    cands: list
    floors: np.ndarray       # (nbands,) the least S/N a band kept
    band_trials: int         # trials a band
    n_crossings: int
    t_offset: int


def widths(s: dict) -> tuple:
    out, w = [], 1
    while w <= s["boxcar_max"]:
        out.append(w)
        w *= 2
    return tuple(out)


def search(levels: torch.Tensor, plan: Plan, s: dict, t_offset: int,
           low: bool = False) -> GulpResult:
    """One gulp of (rows, nchanout) 2-bit levels."""
    ntime_out = levels.shape[0] - plan.max_delay
    ws = widths(s)
    if low:
        fb = dequantize(levels, torch.bfloat16)
        snr = _boxcar_low(_dedisperse_low(fb, plan, ntime_out), ws)
    else:
        snr = boxcar_snr(dedisperse(dequantize(levels), plan, ntime_out), ws)
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
    cands = cluster(hits, vals[keep], plan.dms, ws, t_offset,
                    s["max_candidates"])
    return GulpResult(snr=snr, cands=cands, floors=floors, band_trials=dmb,
                      n_crossings=int((snr > thresh).sum()),
                      t_offset=t_offset)
