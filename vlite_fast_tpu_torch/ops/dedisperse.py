"""Incoherent dedispersion, boxcar matched filtering and candidate clustering.

Port of vlite_fast_tpu/ops/dedisperse.py (heimdall's role in the
reference, scripts/start_heimdall_single_antenna:21).  The DM transform is
the two-stage subband shift-and-sum; `dedisperse` here is the gather
form, the plain version of the CUDA kernel in ops/dedisperse_pallas;
`dedisperse_fourier` the same sums as Fourier phase ramps (torch.fft, as
the JAX package's is XLA and not a TPU kernel); `dedisperse_reference`
the JAX package's exact numpy shift-and-sum, which the offline analysis
(analysis/cutout, analysis/localization.refine_dm) calls.  `Candidate`
and `find_candidates` are numpy copies of the JAX package's (whose module
imports jax); `cluster_hits` gives its candidates by sweeps over whole
arrays where the JAX package loops over DM trials in Python.
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


def dedisperse_fourier(fb: torch.Tensor, plan: DedispPlan, ntime_out: int,
                       batch_chunk: int = 8,
                       phase_table: bool = False) -> torch.Tensor:
    """Gather-free dedispersion: the time shifts as Fourier phase ramps
    (the search's 'fourier' engine).

    A shift by an integer d is exact in the DFT domain:
    irfft(X(f) e^{+2 pi i f d / N})[t] = x[t + d mod N]; padding the time
    axis to N = 2^ceil(log2 ntime) keeps the circular wrap out of the
    valid samples.  Stage 1 multiplies the channels' spectra by each
    batch's rel_delays ramps and sums within each subband; stage 2 ramps
    the subband spectra by each trial's sub_delays and sums them.  The
    batches go batch_chunk at a time: at production (F = 16385
    frequencies, 4096 channels, 38 trials a batch) a chunk of 8 holds
    ~4.3 GB of complex64 factors in stage 1 and ~5.1 GB in stage 2.
    phase_table builds stage 1's factors by indexing a (max_rel + 1, F)
    table of ramps instead of evaluating cos and sin.

    fb: (ntime, nchan) f32, ntime >= ntime_out + plan.max_delay ->
    (ndm, ntime_out); trials of a batch are contiguous and every batch
    holds ndm // nbatch of them (make_plan)."""
    ntime, nchan = fb.shape
    nsub = plan.nsub
    w = nchan // nsub
    dev = fb.device
    npad = 1 << max(4, int(np.ceil(np.log2(ntime))))
    X = torch.fft.rfft(fb * plan.chan_weights[None, :], n=npad, dim=0)
    nfreq = X.shape[0]                                  # (F, nchan)
    omega = (2.0 * np.pi / npad) * torch.arange(nfreq, dtype=torch.float32,
                                                device=dev)
    nbatch = plan.rel_delays.shape[0]
    ndm = plan.sub_delays.shape[0]
    per_batch = ndm // nbatch
    rel_all = plan.rel_delays.to(torch.float32)
    sub_all = plan.sub_delays.to(torch.float32)
    if phase_table:
        rr = torch.arange(max(plan.rel_delays_max, 1) + 1,
                          dtype=torch.float32, device=dev)
        theta = omega[None, :] * rr[:, None]
        table = torch.complex(torch.cos(theta), torch.sin(theta))
        del theta
    out_hat = torch.empty((ndm, nfreq), dtype=torch.complex64, device=dev)
    chunk = min(batch_chunk, nbatch)
    for lo in range(0, nbatch, chunk):
        hi = min(lo + chunk, nbatch)
        c = hi - lo
        if phase_table:
            E = table[plan.rel_delays[lo:hi].to(torch.int64)] \
                .transpose(1, 2)                        # (c, F, nchan)
        else:
            theta = omega[None, :, None] * rel_all[lo:hi, None, :]
            E = torch.complex(torch.cos(theta), torch.sin(theta))
            del theta
        # y_hat[c, f, s] = sum_w' X[f, s*w + w'] E[c, f, s*w + w']
        y_hat = (X[None] * E).reshape(c, nfreq, nsub, w).sum(dim=-1)
        del E
        sub_b = sub_all[lo * per_batch:hi * per_batch].reshape(
            c, per_batch, nsub)
        theta2 = omega[None, None, :, None] * sub_b[:, :, None, :]
        E2 = torch.complex(torch.cos(theta2), torch.sin(theta2))
        del theta2
        out_hat[lo * per_batch:hi * per_batch] = \
            (y_hat[:, None] * E2).sum(dim=-1).reshape(c * per_batch, nfreq)
        del E2, y_hat
    return torch.fft.irfft(out_hat, n=npad, dim=-1)[:, :ntime_out]


def dedisperse_reference(fb: np.ndarray, delays: np.ndarray,
                         ntime_out: int,
                         chan_weights: np.ndarray | None = None) -> np.ndarray:
    """Direct (exact) numpy shift-and-sum oracle for tests."""
    ntime, nchan = fb.shape
    if chan_weights is not None:
        fb = fb * chan_weights[None, :]
    out = np.zeros((delays.shape[0], ntime_out), dtype=np.float64)
    for idm in range(delays.shape[0]):
        for ch in range(nchan):
            d = min(int(delays[idm, ch]), ntime - ntime_out)
            out[idm] += fb[d:d + ntime_out, ch]
    return out.astype(np.float32)


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
        # zero for t < w-1: every t when the box is longer than the row
        box = torch.cat([torch.zeros((ndm, min(w_ - 1, ntime)),
                                     dtype=box.dtype, device=box.device),
                         box], dim=1)
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

    @classmethod
    def from_line(cls, line: str) -> "Candidate":
        f = line.split()
        return cls(float(f[0]), int(f[1]), float(f[2]), int(f[3]),
                   int(f[4]), float(f[5]), int(f[6]), int(f[7]), int(f[8]))


def find_candidates(snr: np.ndarray, dms: np.ndarray, tsamp: float,
                    thresh: float = 6.0,
                    widths: Sequence[int] = (1, 2, 4, 8, 16, 32, 64),
                    t_offset: int = 0, max_cands: int = 4096,
                    dm_link: int = 4, time_gap: int = 2) -> list:
    """Threshold + friends-of-friends cluster a whole (nwidth, ndm, ntime)
    S/N cube (heimdall's giant-finding/clustering stage), on the host."""
    snr = np.asarray(snr)
    hits = np.argwhere(snr > thresh)
    if hits.size == 0:
        return []
    vals = snr[hits[:, 0], hits[:, 1], hits[:, 2]]
    # cap: an RFI storm can produce millions of crossings; keep the
    # strongest (preserves every real event's peak and its neighborhood)
    cap = min(16 * max_cands, 20000)
    if len(vals) > cap:
        keep = np.argsort(-vals)[:cap]
        hits, vals = hits[keep], vals[keep]
    return cluster_hits(hits, vals, dms, tsamp, widths=widths,
                        t_offset=t_offset, max_cands=max_cands,
                        dm_link=dm_link, time_gap=time_gap)


def _components(n: int, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """The connected components of the graph on n nodes with edges
    (u, v): each node's label is the least node of its component (every
    root hooked under the lesser of an edge's roots, then pointers
    jumped to their roots, until no edge joins two roots)."""
    parent = np.arange(n)
    while len(u):
        ru, rv = parent[u], parent[v]
        live = ru != rv
        if not live.any():
            break
        u, v, ru, rv = u[live], v[live], ru[live], rv[live]
        np.minimum.at(parent, np.maximum(ru, rv), np.minimum(ru, rv))
        while True:
            up = parent[parent]
            if np.array_equal(up, parent):
                break
            parent = up
    return parent


def _sweep_edges(key: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                 node: np.ndarray, time_gap: int) -> tuple:
    """The friends one sweep line finds in each group of `key`, its items
    in sweep order (by key, then lo): an item joins the run before it
    where it starts within time_gap of the run's furthest end.  A run
    that starts ends past every earlier end of its group (its start lies
    beyond them, its end beyond its start), so that end is the group's
    running maximum.  Returns (node, node) edges between neighbours of a
    run."""
    first = np.ones(len(key), dtype=bool)
    first[1:] = key[1:] != key[:-1]
    group = np.cumsum(first) - 1
    span = int(hi.max() - lo.min()) + 1
    reach = np.maximum.accumulate(hi + group * span) - group * span
    join = ~first
    join[1:] &= lo[1:] < reach[:-1] + time_gap
    at = np.flatnonzero(join)
    return node[at - 1], node[at]


def cluster_hits(hits: np.ndarray, vals: np.ndarray, dms: np.ndarray,
                 tsamp: float,
                 widths: Sequence[int] = (1, 2, 4, 8, 16, 32, 64),
                 t_offset: int = 0, max_cands: int = 4096,
                 dm_link: int = 4, time_gap: int = 2) -> list:
    """Friends-of-friends clustering of threshold crossings.

    hits: (n, 3) [width_idx, dm_idx, t_end]; vals: their S/N.  Two
    crossings are friends when their boxcar intervals overlap (with a
    `time_gap` slack) and their DM trials are within `dm_link`; each
    cluster yields one Candidate at its S/N peak.

    The JAX package's sweep, on whole arrays: for each DM step delta <=
    dm_link, the crossings of trials d and d + delta are swept in one
    group a trial d (by interval start, trial d's first on a tie), and
    the friends it finds are joined into components.  Clusters, their
    peaks (the first crossing of the greatest S/N), their order (by S/N,
    then by their first crossing) and the candidates are the JAX
    package's."""
    hits = np.asarray(hits)
    vals = np.asarray(vals)
    if hits.size == 0:
        return []
    n = len(vals)
    w_arr = np.asarray(widths)[hits[:, 0]]
    lo = (hits[:, 2] - w_arr + 1).astype(np.int64)   # interval [lo, hi)
    hi = (hits[:, 2] + 1).astype(np.int64)
    dmi = hits[:, 1].astype(np.int64)
    idx = np.arange(n)
    us, vs = [], []
    for delta in range(dm_link + 1):
        # the group of trial d holds trial d's crossings, then those of
        # trial d + delta (for delta 0, trial d's alone)
        key = dmi if delta == 0 else np.concatenate([dmi, dmi - delta])
        node = idx if delta == 0 else np.concatenate([idx, idx])
        side = np.zeros(len(key), dtype=np.int64)
        side[n:] = 1
        o = np.lexsort((node, side, lo[node], key))
        u, v = _sweep_edges(key[o], lo[node[o]], hi[node[o]], node[o],
                            time_gap)
        us.append(u)
        vs.append(v)
    label = _components(n, np.concatenate(us), np.concatenate(vs))
    # each cluster's peak: its first crossing of the greatest S/N
    o = np.lexsort((idx, -vals.astype(np.float64), label))
    first = np.ones(n, dtype=bool)
    first[1:] = label[o][1:] != label[o][:-1]
    peak = o[first]                      # clusters by their first crossing
    starts = np.flatnonzero(first)
    size = np.diff(np.append(starts, n))
    i0 = np.minimum.reduceat(lo[o], starts)
    i1 = np.maximum.reduceat(hi[o], starts)
    keep = np.argsort(-vals[peak].astype(np.float64),
                      kind="stable")[:max_cands]
    k = peak[keep]
    tfilt = [int(np.log2(w)) for w in widths]
    at = (hits[k, 2].astype(np.int64) + t_offset).tolist()
    return [Candidate(snr=s, peak_idx=t, peak_time=t * tsamp,
                      tfilt=tfilt[w], dmi=d, dm=float(dms[d]), ngiant=g,
                      i0=a, i1=b)
            for s, t, w, d, g, a, b in zip(
                vals[k].astype(np.float64).tolist(), at,
                hits[k, 0].tolist(), hits[k, 1].tolist(),
                size[keep].tolist(), (i0[keep] + t_offset).tolist(),
                (i1[keep] + t_offset).tolist())]
