"""Incoherent dedispersion, boxcar matched filtering and candidate clustering.

Port of vlite_fast_tpu/ops/dedisperse.py (heimdall's role in the
reference, scripts/start_heimdall_single_antenna:21).  The DM transform is
the two-stage subband shift-and-sum; `dedisperse` here is the gather
form, the plain version of the CUDA kernel in ops/dedisperse_pallas.
`Candidate` and `cluster_hits` are numpy copies of the JAX package's
(whose module imports jax).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import torch

from vlite_fast_tpu_torch import constants as C
from vlite_fast_tpu_torch import devices


# ---------------------------------------------------------------------------
# DM grid and delay tables (host-side, numpy)
# ---------------------------------------------------------------------------

def dm_grid(dm_min: float, dm_max: float, ndm: int) -> np.ndarray:
    """Linear DM trial grid."""
    return np.linspace(dm_min, dm_max, ndm, dtype=np.float64)


def dm_grid_tol(dm_min: float, dm_max: float, tsamp: float,
                freqs_mhz: np.ndarray, tol: float = 1.25,
                pulse_width_s: float = 0.0) -> np.ndarray:
    """Adaptive DM grid with bounded S/N loss (dedisp/heimdall -dm_tol):
    the step keeps the effective width within `tol` of matched."""
    if tol <= 1.0:
        raise ValueError(f"dm_tol must be > 1 (an S/N-loss factor; got "
                         f"{tol})")
    f = np.asarray(freqs_mhz, np.float64)
    sweep = C.DM_CONST_S * (f.min() ** -2.0 - f.max() ** -2.0)  # s per DM
    chan_sweep = sweep / len(f)
    dms = [dm_min]
    while dms[-1] < dm_max:
        dm = dms[-1]
        weff2 = tsamp ** 2 + pulse_width_s ** 2 + (dm * chan_sweep) ** 2
        step = 2.0 * np.sqrt((tol * tol - 1.0) * weff2) / sweep
        dms.append(dm + step)
    return np.asarray(dms, np.float64)


def delay_table(dms: np.ndarray, freqs_mhz: np.ndarray,
                tsamp: float) -> np.ndarray:
    """(ndm, nchan) int32 delays in samples relative to the highest
    frequency."""
    fref = float(np.max(freqs_mhz))
    d = C.DM_CONST_S * dms[:, None] * (freqs_mhz[None, :] ** -2.0
                                       - fref ** -2.0)
    return np.round(d / tsamp).astype(np.int32)


# ---------------------------------------------------------------------------
# Subband two-stage dedispersion
# ---------------------------------------------------------------------------

@dataclass
class DedispPlan:
    """Index tables (tensors) and static geometry of one DM grid."""

    rel_delays: torch.Tensor    # (nbatch, nchan) int32 in-subband delays
    sub_delays: torch.Tensor    # (ndm, nsub) int32 subband delays
    batch_of_dm: torch.Tensor   # (ndm,) int32 stage-1 batch index
    chan_weights: torch.Tensor  # (nchan,) f32 0/1 zap mask
    dms: tuple
    max_delay: int
    max_sub_delay: int
    nsub: int
    nchan_eff: float
    rel_delays_max: int = 0
    rel_delays_min: int = 0
    # the largest spread of one subband's delays over the trials of one
    # batch (-1: the batches are not d // (ndm // nbatch))
    sub_spread: int = -1


def batch_sub_spread(sub_delays: np.ndarray, batch_of_dm: np.ndarray,
                     nbatch: int) -> int:
    """DedispPlan.sub_spread from the plan's numpy tables."""
    ndm, nsub = sub_delays.shape
    if ndm % nbatch or not np.array_equal(
            batch_of_dm, np.arange(ndm) // (ndm // nbatch)):
        return -1
    sd = sub_delays.reshape(nbatch, ndm // nbatch, nsub)
    return int((sd.max(axis=1) - sd.min(axis=1)).max())


def make_plan(dms: np.ndarray, freqs_mhz: np.ndarray, tsamp: float,
              nsub: int = 128, nbatch: int = 128,
              zap_ranges: Sequence[tuple] = (), device="cuda") -> DedispPlan:
    device = devices.resolve(device)
    nchan = len(freqs_mhz)
    ndm = len(dms)
    nbatch = min(nbatch, ndm)
    while ndm % nbatch:      # uniform batches
        nbatch -= 1
    while nchan % nsub:      # nsub must divide nchan
        nsub -= 1
    full = delay_table(np.asarray(dms), np.asarray(freqs_mhz), tsamp)
    # subband reference = first (highest-frequency) channel of each subband
    w = nchan // nsub
    sub_delays = full[:, np.arange(nsub) * w]                 # (ndm, nsub)
    # stage-1 batches: representative DM per batch of contiguous trials
    edges = np.linspace(0, ndm, nbatch + 1).astype(int)
    batch_of_dm = np.zeros(ndm, dtype=np.int32)
    rep = np.zeros(nbatch, dtype=int)
    for b in range(nbatch):
        batch_of_dm[edges[b]:edges[b + 1]] = b
        rep[b] = (edges[b] + edges[b + 1] - 1) // 2
    rel = full[rep] - np.repeat(sub_delays[rep], w, axis=1)  # (nbatch, nchan)
    mask = np.ones(nchan, dtype=np.float32)
    for lo, hi in zap_ranges:
        mask[lo:hi] = 0.0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return DedispPlan(
        rel_delays=t(rel.astype(np.int32)),
        sub_delays=t(sub_delays.astype(np.int32)),
        batch_of_dm=t(batch_of_dm), chan_weights=t(mask),
        dms=tuple(float(d) for d in dms), max_delay=int(full.max()),
        max_sub_delay=int(sub_delays.max()), nsub=nsub,
        nchan_eff=float(mask.sum()),
        rel_delays_max=int(rel.max()) if rel.size else 0,
        rel_delays_min=int(rel.min()) if rel.size else 0,
        sub_spread=batch_sub_spread(sub_delays, batch_of_dm, nbatch))


def dedisperse(fb: torch.Tensor, plan: DedispPlan, ntime_out: int,
               dm_chunk: int = 16) -> torch.Tensor:
    """Gather form of the subband shift-and-sum.

    fb: (ntime, nchan) f32 with ntime >= ntime_out + plan.max_delay ->
    (ndm, ntime_out) DM-time plane (zapped channels excluded).

      stage 1: y[b, t, s] = sum_{ch in s} fbz[min(t + rel[b, ch], ntime-1), ch]
               for t < ntime_out + max_sub_delay
      stage 2: out[dm, t] = sum_s y[batch_of_dm[dm], t + sub_delays[dm, s], s]
    """
    ntime, nchan = fb.shape
    nsub = plan.nsub
    w = nchan // nsub
    dev = fb.device
    fbz = fb * plan.chan_weights[None, :]
    t1_len = ntime_out + plan.max_sub_delay
    t1 = torch.arange(t1_len, device=dev)
    t = torch.arange(ntime_out, device=dev)
    y = []
    for rel_b in plan.rel_delays.to(torch.int64):
        idx = (t1[:, None] + rel_b[None, :]).clamp(0, ntime - 1)
        g = torch.gather(fbz, 0, idx)                       # (t1_len, nchan)
        y.append(g.reshape(t1_len, nsub, w).sum(dim=-1))
    y = torch.stack(y)                                # (nbatch, t1, nsub)
    ndm = plan.sub_delays.shape[0]
    out = torch.empty((ndm, ntime_out), dtype=torch.float32, device=dev)
    sub_d = plan.sub_delays.to(torch.int64)
    b_idx = plan.batch_of_dm.to(torch.int64)
    for lo in range(0, ndm, dm_chunk):
        hi = min(lo + dm_chunk, ndm)
        yb = y[b_idx[lo:hi]]                                # (c, t1, nsub)
        idx = t[None, :, None] + sub_d[lo:hi, None, :]      # (c, T, nsub)
        out[lo:hi] = torch.gather(yb, 1, idx).sum(dim=-1)
    return out


# ---------------------------------------------------------------------------
# Boxcar matched filter
# ---------------------------------------------------------------------------

def _median_rows(a: torch.Tensor) -> torch.Tensor:
    """Row median averaging the two middle values for even length (numpy
    and jnp.median semantics; torch.median takes the lower one)."""
    s = a.sort(dim=1).values
    n = s.shape[1]
    return (s[:, (n - 1) // 2] + s[:, n // 2]) * 0.5


def boxcar_snr(dmt: torch.Tensor, nchan_eff: float,
               widths: tuple = (1, 2, 4, 8, 16, 32, 64),
               noise: str = "measured",
               noise_subsample: int = 8192) -> torch.Tensor:
    """Matched-filter S/N over boxcar widths.

    dmt: (ndm, ntime); per-DM mean subtracted; noise from 1.4826 * the
    median |deviation| over a strided subsample (step max(1, ntime //
    noise_subsample)), or sqrt(nchan_eff) for noise='expected'.  Returns
    (nwidth, ndm, ntime), the box covering [t-w+1, t], zero for t < w-1."""
    ndm, ntime = dmt.shape
    x = dmt - dmt.mean(dim=1, keepdim=True)
    if noise == "measured":
        step = max(1, ntime // noise_subsample) if noise_subsample else 1
        sigma = 1.4826 * _median_rows(x[:, ::step].abs())
        sigma = sigma.clamp(min=1e-6)
    else:
        sigma = torch.full((ndm,), float(np.sqrt(np.float32(nchan_eff))),
                           device=dmt.device)
    cs = torch.cumsum(x, dim=1)
    cs = torch.cat([torch.zeros((ndm, 1), dtype=cs.dtype, device=cs.device),
                    cs], dim=1)
    inv_sigma = (1.0 / sigma)[:, None]
    outs = []
    for w_ in widths:
        box = cs[:, w_:] - cs[:, :-w_]
        box = torch.cat([torch.zeros((ndm, w_ - 1), dtype=box.dtype,
                                     device=box.device), box], dim=1)
        outs.append(box * inv_sigma
                    * torch.rsqrt(torch.tensor(float(w_))).item())
    return torch.stack(outs)


# ---------------------------------------------------------------------------
# Candidate extraction (host-side numpy)
# ---------------------------------------------------------------------------

class Candidate(NamedTuple):
    """One single-pulse candidate, field-compatible with a heimdall line."""

    snr: float
    peak_idx: int        # sample index of peak (gulp-absolute)
    peak_time: float     # seconds from observation start
    tfilt: int           # log2 boxcar width
    dmi: int             # DM trial index
    dm: float
    ngiant: int          # threshold crossings merged
    i0: int              # start sample
    i1: int              # end sample

    def to_line(self) -> str:
        return (f"{self.snr:.2f}\t{self.peak_idx}\t{self.peak_time:.4f}\t"
                f"{self.tfilt}\t{self.dmi}\t{self.dm:.3f}\t{self.ngiant}\t"
                f"{self.i0}\t{self.i1}")


class _UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n)

    def find(self, i: int) -> int:
        p = self.parent
        root = i
        while p[root] != root:
            root = p[root]
        while p[i] != root:
            p[i], i = root, p[i]
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def cluster_hits(hits: np.ndarray, vals: np.ndarray, dms: np.ndarray,
                 tsamp: float,
                 widths: Sequence[int] = (1, 2, 4, 8, 16, 32, 64),
                 t_offset: int = 0, max_cands: int = 4096,
                 dm_link: int = 4, time_gap: int = 2) -> list:
    """Friends-of-friends clustering of threshold crossings.

    hits: (n, 3) [width_idx, dm_idx, t_end]; vals: their S/N.  Two
    crossings are friends when their boxcar intervals overlap (with a
    `time_gap` slack) and their DM trials are within `dm_link`; each
    cluster yields one Candidate at its S/N peak."""
    hits = np.asarray(hits)
    vals = np.asarray(vals)
    if hits.size == 0:
        return []
    n = len(vals)
    w_arr = np.asarray(widths)[hits[:, 0]]
    lo = hits[:, 2] - w_arr + 1                    # interval [lo, hi)
    hi = hits[:, 2] + 1
    dmi = hits[:, 1]
    uf = _UnionFind(n)
    order = np.argsort(lo, kind="stable")
    by_trial: dict = {}
    for idx in order:
        by_trial.setdefault(int(dmi[idx]), []).append(int(idx))
    for d, members in by_trial.items():
        for delta in range(0, dm_link + 1):
            other = by_trial.get(d + delta)
            if other is None or (delta == 0 and len(members) < 2):
                continue
            merged = members if delta == 0 else sorted(
                members + other, key=lambda i: lo[i])
            run_rep, run_hi = merged[0], hi[merged[0]]
            for i in merged[1:]:
                if lo[i] < run_hi + time_gap:
                    uf.union(run_rep, i)
                    if hi[i] > run_hi:
                        run_hi = int(hi[i])
                else:
                    run_rep, run_hi = i, int(hi[i])
    clusters: dict = {}
    for i in range(n):
        clusters.setdefault(uf.find(i), []).append(i)
    cands: list[Candidate] = []
    for members in clusters.values():
        m = np.asarray(members)
        k = m[np.argmax(vals[m])]
        iw, idm, it = hits[k]
        cands.append(Candidate(
            snr=float(vals[k]), peak_idx=int(it) + t_offset,
            peak_time=(int(it) + t_offset) * tsamp,
            tfilt=int(np.log2(widths[iw])), dmi=int(idm),
            dm=float(dms[idm]), ngiant=len(members),
            i0=int(lo[m].min()) + t_offset, i1=int(hi[m].max()) + t_offset))
    cands.sort(key=lambda c: -c.snr)
    return cands[:max_cands]
