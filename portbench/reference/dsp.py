"""The plain float64 reference of one station's DSP chain.

Written from the algorithm (the reference's src/pb_kernels.cu and
src/process_baseband.cu, as the configuration file states its settings),
in plain torch on any device, importing nothing of the program:

  convert -> spectral kurtosis (fine-window D'Agostino test, block test,
  mask, block weights) -> channelize both streams, the plain and the
  masked one (rfft of each frame, or the WOLA polyphase filterbank) ->
  [armed] FRB track multiply -> detect -> bandpass EMA, one per stream
  (plain; kurtosis-weighted with clipping and stale re-seeding) -> pol and
  time scrunch (weighted for the kurtosis stream) -> channel trim -> 2-bit
  levels; an observation's first bandpasses seeded as `seed` says.

Every quantity is float64.  The bandpass EMA, a recurrence over the
second's spectra, is solved in closed form: with c_t the count of
updates up to spectrum t and d = 1 - s,

  bp_t = d^c_t * (bp_0 + s * sum_{j <= t, updated} d^-c_j * p_j),

exact in exact arithmetic.  Which spectra update (not clipped: p_t <=
11 bp_{t-1}) depends on bp itself, so the update mask is iterated to its
fixed point; the tile starts where a zero or stale bandpass is re-seeded
split the second into runs solved one after another.

The chain keeps no state a run cannot rebuild: the bandpass forgets its
start within ~1 s (e-folding 1/s spectra, 0.125 s at production), so a
second is computed from Geometry.warmup seconds before it, started from
zero bandpasses (a residual below FORGOTTEN of the start's error), and
the WOLA tail is the previous second's last frames.  An entry the
weights kept from updating that often is not determined by those
seconds: SecondOut marks which entries are (`bp_known`).

`Geometry` reads the configuration file's "dsp" settings.  `low` computes
the control instead (check.py): the configuration's float32 stages one
step lower, the DFT as two Cooley-Tukey matrix products whose operands
are rounded to TF32's 10-bit mantissa (the precision a float32 matrix
product takes with TF32 on), and the kurtosis front's moments in
bfloat16 (the voltages squared and their squares rounded to bfloat16,
summed in float32).  The EMA stays in float64 in the control: in
bfloat16 its decay 1 - s rounds to 1 and the recurrence cannot run.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

# 2-bit digitizer thresholds and the level centroids (ref sel_and_dig_2b,
# src/pb_kernels.cu:633-688; Jenet & Anderson 1998)
QUANT2_THRESH = (-0.6109, 0.3970, 1.4050)
LEVEL2_CENTROIDS = (-1.24, -0.098, 0.85, 1.94)
# detect_and_normalize3: a power above 11x the bandpass is clipped to 10
# and does not update it (ref src/pb_kernels.cu:493-494)
CLIP_RATIO = 11.0
CLIP_VALUE = 10.0
# a tile whose mean is this far off the carried bandpass re-seeds it
STALE_HI, STALE_LO = 5.0, 0.2
# FRB injection: once every INJECT_PERIOD_S seconds, the dispersion
# constant the injection uses (ref set_frb_delays, pb_kernels.cu:338-360)
INJECT_PERIOD_S = 60
INJECT_DM_CONST = 4.15e-3
# a bandpass entry is determined by the data once it has been updated
# Geometry.forget times since a start it does not know (its start's error
# is then below FORGOTTEN of itself); before that, and where the weights
# keep it from updating, it carries a history the reference did not see
FORGOTTEN = 1e-8
HORIZON = 8         # tiles of the EMA solved at a time


@dataclass(frozen=True)
class Geometry:
    """The chain's geometry from a configuration's "dsp" settings."""

    rate: int
    npol: int
    nfft: int
    nscrunch: int
    seg_per_sec: int
    nkurto: int
    chanmin: int
    chanmax: int
    nbit: int
    npol_out: int
    rfi_mode: int
    inject: bool
    inject_dm: float
    inject_width_s: float
    inject_amp: float
    channelizer: str
    ntap: int
    dag_thresh: float
    dag_fb_thresh: float
    min_weight: float
    bp_tsmooth: float
    freq_top_mhz: float
    bandwidth_mhz: float

    @classmethod
    def from_settings(cls, d: dict) -> "Geometry":
        g = cls(rate=d["sample_rate"], npol=d["npol_in"], nfft=d["nfft"],
                nscrunch=d["nscrunch"], seg_per_sec=d["seg_per_sec"],
                nkurto=d["nkurto"], chanmin=d["chanmin"],
                chanmax=d["chanmax"], nbit=d["nbit"],
                npol_out=d["npol_out"], rfi_mode=d["rfi_mode"],
                inject=bool(d["inject_frb"]), inject_dm=d["inject_dm"],
                inject_width_s=d["inject_width_s"],
                inject_amp=d["inject_amp"], channelizer=d["channelizer"],
                ntap=d["pfb_ntap"] if d["channelizer"] == "pfb" else 1,
                dag_thresh=d["dag_thresh"], dag_fb_thresh=d["dag_fb_thresh"],
                min_weight=d["min_weight"], bp_tsmooth=d["bp_tsmooth"],
                freq_top_mhz=d["freq_top_mhz"],
                bandwidth_mhz=d["bandwidth_mhz"])
        if g.nbit != 2 or g.npol_out != 1 or g.npol not in (1, 2) \
                or g.rfi_mode != 2:
            raise ValueError("the reference computes the 2-bit, "
                             "single-output-pol chain of rfi_mode 2")
        if g.channelizer not in ("matmul", "fft", "pfb"):
            raise ValueError(f"channelizer {g.channelizer!r}")
        return g

    @property
    def nchan(self) -> int:
        return self.nfft // 2 + 1

    @property
    def nchanout(self) -> int:
        return self.chanmax - self.chanmin + 1

    @property
    def spectra(self) -> int:
        """Spectra a second, per pol."""
        return self.rate // self.nfft

    @property
    def tile(self) -> int:
        """Spectra a segment: the EMA's seeding tile."""
        return self.spectra // self.seg_per_sec

    @property
    def rows(self) -> int:
        """Filterbank rows a second."""
        return self.spectra // self.nscrunch

    @property
    def tsamp(self) -> float:
        return self.nfft / self.rate * self.nscrunch

    @property
    def bp_scale(self) -> float:
        # the EMA weight as the reference's float32 arithmetic rounds it
        return float(np.float32(self.tsamp / self.bp_tsmooth))

    @property
    def forget(self) -> int:
        """Updates after which a bandpass entry's start is forgotten."""
        return int(math.ceil(math.log(FORGOTTEN)
                             / math.log1p(-self.bp_scale)))

    @property
    def warmup(self) -> int:
        """Seconds run before a checked second: `forget` updates."""
        return -(-self.forget // self.spectra)

    def freqs_mhz(self) -> np.ndarray:
        """Centre frequency of each retained channel, descending."""
        chan_bw = -self.bandwidth_mhz / self.nchan
        return self.freq_top_mhz + (
            np.arange(self.chanmin, self.chanmax + 1) - 0.5) * chan_bw


@dataclass
class State:
    """What one second hands the next."""

    bp: torch.Tensor        # (npol, nchan) plain stream's bandpass
    bp_kur: torch.Tensor    # (npol, nchan) kurtosis stream's bandpass
    tail: torch.Tensor      # (2, npol, (ntap - 1) * nfft) WOLA voltages
    wtail: torch.Tensor     # (npol, ntap - 1) WOLA block weights
    n: torch.Tensor         # (2, npol, nchan) updates of bp, bp_kur since
                            # the reference's start (ema)


@dataclass
class SecondOut:
    levels: torch.Tensor      # (rows, nchanout) uint8, plain stream
    levels_kur: torch.Tensor  # (rows, nchanout) uint8, kurtosis stream
    weights: torch.Tensor     # (npol, spectra) f64 kurtosis weights
    bp: torch.Tensor          # (npol, nchan) f64 after the second
    bp_kur: torch.Tensor
    bp_known: torch.Tensor    # (2, npol, nchan) bool: bp, bp_kur entries
                              # the data determine (updated `forget` times)


def fresh_state(g: Geometry, device) -> State:
    f = lambda *s: torch.zeros(s, dtype=torch.float64, device=device)
    nh = g.ntap - 1
    return State(bp=f(g.npol, g.nchan), bp_kur=f(g.npol, g.nchan),
                 tail=f(2, g.npol, nh * g.nfft),
                 wtail=torch.ones((g.npol, nh), dtype=torch.float64,
                                  device=device),
                 n=f(2, g.npol, g.nchan))


# --- the RFI front ------------------------------------------------------

def dagostino_constants(n: int) -> tuple:
    """(1 - 2/A, mu1, Z2_1, Z2_2, Z2_3) of the D'Agostino kurtosis test
    for n samples (ref src/pb_kernels.cu:3-20)."""
    nk = float(n)
    mu1 = -6.0 / (nk + 1)
    mu2 = (24.0 * nk * (nk - 2) * (nk - 3)) / (
        (nk + 1) * (nk + 1) * (nk + 3) * (nk + 5))
    g1 = (6.0 * (nk * nk - 5 * nk + 2) / ((nk + 7) * (nk + 9))
          * math.sqrt((6.0 * (nk + 3) * (nk + 5)) / (nk * (nk - 2)
                                                    * (nk - 3))))
    a = 6.0 + (8.0 / g1) * (2.0 / g1 + math.sqrt(1.0 + 4.0 / (g1 * g1)))
    return (1.0 - 2.0 / a, mu1, math.sqrt(4.5 * a), 1 - 2.0 / (9 * a),
            math.sqrt(2.0 / (mu2 * (a - 4))))


def dagostino(kur: torch.Tensor, n: int, inf: float) -> torch.Tensor:
    """The test statistic of (npol, m) kurtoses, the larger of the pols."""
    c, mu1, z1, z2, z3 = dagostino_constants(n)
    t = c / (1.0 + (kur - 3.0 - mu1) * z3)
    cbrt = torch.sign(t) * t.abs().pow(1.0 / 3.0)
    ts = torch.abs(z1 * (z2 - cbrt))
    ts = torch.where((t > 0) & (kur != 0.0), ts, torch.full_like(ts, inf))
    return ts.max(dim=0).values


def rfi_front(g: Geometry, x: torch.Tensor, low: bool = False) -> tuple:
    """(masked voltages, block weights (npol, nblk)) of (npol, n) voltages."""
    npol, n = x.shape
    nwin, wpf = n // g.nkurto, g.nfft // g.nkurto
    nblk = nwin // wpf
    inf = g.dag_thresh + g.dag_fb_thresh + 1.0
    x2 = x.reshape(npol, nwin, g.nkurto) ** 2
    if low:
        x2 = x2.to(torch.bfloat16)
        m2 = x2.float().mean(dim=-1).double()
        m4 = (x2 * x2).float().mean(dim=-1).double()
    else:
        m2 = x2.mean(dim=-1)
        m4 = (x2 * x2).mean(dim=-1)
    del x2
    zero = m2 == 0
    kur = torch.where(zero, torch.zeros_like(m2),
                      m4 / torch.where(zero, torch.ones_like(m2), m2 * m2))
    fine_ok = dagostino(kur, g.nkurto, inf) < g.dag_thresh      # (nwin,)
    wt = fine_ok.to(x.dtype).reshape(nblk, wpf)
    p = m2.reshape(npol, nblk, wpf)
    q = kur.reshape(npol, nblk, wpf)
    wsum = wt.sum(dim=-1)
    good = wsum > 0
    pblk = torch.where(good, (wt * p).sum(dim=-1) / wsum.clamp(min=1), 0.0)
    kblk = torch.where(good, (wt * q * p * p).sum(dim=-1)
                       / wsum.clamp(min=1)
                       / torch.where(good, pblk * pblk, 1.0), 0.0)
    keep = fine_ok.reshape(nblk, wpf)
    if g.dag_fb_thresh > 0:
        blk_ok = dagostino(kblk, g.nfft, inf) < g.dag_fb_thresh
        keep = keep & blk_ok[:, None]
    masked = x * keep.reshape(1, nwin, 1).to(x.dtype).expand(
        1, nwin, g.nkurto).reshape(1, n)
    weights = keep.to(x.dtype).mean(dim=-1)[None].expand(npol, nblk)
    return masked, weights.contiguous()


# --- the channelizer ----------------------------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float64) rounded to TF32: 10 explicit mantissa bits, to nearest."""
    m, e = torch.frexp(x)
    return torch.ldexp(torch.round(m * 2048.0) / 2048.0, e)


def _split(n: int) -> tuple:
    f = int(math.isqrt(n))
    for n1 in range(f, 1, -1):
        if n % n1 == 0:
            return n1, n // n1
    raise ValueError(f"nfft {n} has no Cooley-Tukey split")


def _dft_tf32(frames: torch.Tensor, nfft: int) -> torch.Tensor:
    """The real DFT of (..., nfft) frames as two Cooley-Tukey matrix
    products with operands rounded to TF32 (the control)."""
    n1, n2 = _split(nfft)
    dev = frames.device
    i1 = torch.arange(n1, dtype=torch.float64, device=dev)
    i2 = torch.arange(n2, dtype=torch.float64, device=dev)
    cis = lambda a: (torch.cos(a), -torch.sin(a))
    w1r, w1i = map(_tf32, cis(2 * math.pi * torch.outer(i1, i1) / n1))
    twr, twi = cis(2 * math.pi * torch.outer(i1, i2) / nfft)
    w2r, w2i = map(_tf32, cis(2 * math.pi * torch.outer(i2, i2) / n2))
    batch = frames.shape[:-1]
    x = _tf32(frames.reshape(-1, n1, n2))             # x[m1, m2]
    ar, ai = w1r.T @ x, w1i.T @ x                      # (b, k1, m2)
    br = _tf32(ar * twr - ai * twi)
    bi = _tf32(ar * twi + ai * twr)
    pr = br @ w2r - bi @ w2i                           # (b, k1, k2)
    pi = br @ w2i + bi @ w2r
    nchan = nfft // 2 + 1
    out = torch.complex(pr.transpose(1, 2).reshape(x.shape[0], -1),
                        pi.transpose(1, 2).reshape(x.shape[0], -1))
    return out[:, :nchan].reshape(*batch, nchan)


def pfb_window(g: Geometry, device) -> tuple:
    """(window (ntap, nfft), tap energies (ntap,)): a sinc-Hamming
    prototype, sum(w^2) = nfft."""
    n = g.ntap * g.nfft
    t = (np.arange(n) - n / 2 + 0.5) / g.nfft
    w = np.sinc(t) * np.hamming(n)
    w *= np.sqrt(g.nfft / np.sum(w ** 2))
    win = torch.from_numpy(w.reshape(g.ntap, g.nfft)).to(device)
    e = (win * win).sum(dim=1)
    return win, e / e.sum()


def channelize(g: Geometry, x: torch.Tensor, tail: torch.Tensor,
               low: bool) -> torch.Tensor:
    """(npol, n) voltages -> (npol, n // nfft, nchan) complex spectra."""
    npol, n = x.shape
    frames = x.reshape(npol, n // g.nfft, g.nfft)
    if g.channelizer == "pfb":
        nh = g.ntap - 1
        ext = torch.cat([tail.reshape(npol, nh, g.nfft), frames], dim=1)
        win, _ = pfb_window(g, x.device)
        frames = ext[:, 0:frames.shape[1]] * win[0]
        for t in range(1, g.ntap):
            frames = frames + ext[:, t:t + ext.shape[1] - nh] * win[t]
    if low:
        return _dft_tf32(frames, g.nfft)
    return torch.fft.rfft(frames, dim=-1)


def _detect(spec: torch.Tensor) -> torch.Tensor:
    return spec.real ** 2 + spec.imag ** 2


def frb_track(g: Geometry, since: int, nspec: int, device) -> torch.Tensor:
    """(nspec, nchan) bool: the injected burst's dispersed track in the
    spectra of a second whose first spectrum lies `since` spectra after
    the burst's top-of-band arrival.  The delays and the track's edges
    are rounded as the reference's float32 arithmetic rounds them."""
    i = np.arange(g.nchan, dtype=np.float64)
    ftop = g.freq_top_mhz / 1e3
    freq = ftop - (i * (g.bandwidth_mhz / 1e3)) / g.nchan
    scale = INJECT_DM_CONST * g.inject_dm * g.spectra
    d = (scale / (freq * freq) - scale / ftop ** 2).astype(np.float32)
    width = np.float32(g.inject_width_s * g.spectra)
    half = np.float32(0.5)
    lo = np.floor(d + half).astype(np.int64) - since
    hi = np.floor((d + width).astype(np.float32) + half).astype(
        np.int64) - since
    t = torch.arange(nspec, device=device)[:, None]
    lo, hi = (torch.from_numpy(a).to(device)[None] for a in (lo, hi))
    return (t >= lo) & (t <= hi)


# --- the bandpass EMA ---------------------------------------------------

def _closed(p, m, bp0, s):
    """bp after each spectrum of p (npol, T, C), updating where m."""
    lnd = math.log1p(-s)
    c = torch.cumsum(m.to(p.dtype), dim=1)
    if float(c.max()) * -lnd > 600.0:
        raise ValueError("a run of spectra too long for the closed form")
    acc = torch.cumsum(torch.where(m, p * torch.exp(-c * lnd), 0.0), dim=1)
    return torch.exp(c * lnd) * (bp0[:, None] + s * acc)


def _tile_seeds(p, good, t0, tile):
    """Each tile's seed from t0 on: (seed (npol, K, C), ngood (npol, K, 1))."""
    npol, T, C = p.shape
    blk = p[:, t0:].reshape(npol, -1, tile, C)
    if good is None:
        seed = blk.mean(dim=2)
        return torch.where(seed == 0.0, 1.0, seed), None
    ng = good[:, t0:T].reshape(npol, -1, tile).sum(dim=2)[..., None]
    seed = torch.where(ng > 0, blk.sum(dim=2) / ng.clamp(min=1), 1.0)
    return seed, ng


def ema(p: torch.Tensor, good, bp: torch.Tensor, s: float, tile: int,
        n: torch.Tensor, forget: int) -> tuple:
    """(normalized (npol, T, C), bp after, n after) of powers p; good
    (npol, T) selects the kurtosis-weighted form (p is then p / w, 0 where
    w = 0), None the plain one.  n counts each entry's updates since the
    reference's cold start; a stale re-seed, which forgets all history,
    sets it to `forget`.  Runs of at most HORIZON tiles are solved at a
    time, so a re-seed wastes little."""
    npol, T, C = p.shape
    out = torch.empty_like(p)
    t0 = 0
    while t0 < T:
        seed, ng = _tile_seeds(p[:, :t0 + tile], good, t0, tile)
        seed, ng = seed[:, 0], None if ng is None else ng[:, 0]
        bp = torch.where(bp == 0.0, seed, bp)
        if good is not None:
            stale = (ng > 0) & ((seed > STALE_HI * bp)
                                | (seed < STALE_LO * bp))
            bp = torch.where(stale, seed, bp)
            n = torch.where(stale, float(forget), n)
        t_end = min(T, t0 + HORIZON * tile)
        seg = p[:, t0:t_end]
        ok = (torch.ones_like(seg, dtype=torch.bool) if good is None
              else good[:, t0:t_end, None].expand_as(seg))
        m = ok
        for _ in range(100):
            bps = _closed(seg, m, bp, s)
            prev = torch.cat([bp[:, None], bps[:, :-1]], dim=1)
            if good is None:
                break
            m_new = ok & ~(seg > prev * CLIP_RATIO)
            if torch.equal(m_new, m):
                break
            m = m_new
        else:
            raise RuntimeError("the EMA's clip mask did not settle")
        # the first later tile whose start re-seeds: a zero or stale carry
        t1 = t_end
        if t0 + tile < t_end:
            seeds, ngs = _tile_seeds(p[:, :t_end], good, t0 + tile, tile)
            carry = bps[:, tile - 1::tile][:, :seeds.shape[1]]
            ev = carry == 0.0
            if good is not None:
                ev = ev | ((ngs > 0) & ((seeds > STALE_HI * carry)
                                        | (seeds < STALE_LO * carry)))
            k = torch.nonzero(ev.any(dim=2).any(dim=0))
            if len(k):
                t1 = t0 + tile * (int(k[0]) + 1)
        j = t1 - t0
        if good is None:
            out[:, t0:t1] = seg[:, :j] / bps[:, :j] - 1.0
        else:
            clipped = seg[:, :j] > prev[:, :j] * CLIP_RATIO
            val = torch.where(clipped, CLIP_VALUE,
                              seg[:, :j] / bps[:, :j] - 1.0)
            out[:, t0:t1] = torch.where(ok[:, :j], val, 0.0)
        n = n + m[:, :j].sum(dim=1)
        bp = bps[:, j - 1]
        t0 = t1
    return out, bp, n


# --- scrunch and quantize -----------------------------------------------

def levels(g: Geometry, out: torch.Tensor, weights) -> torch.Tensor:
    """(npol, T, nchan) normalized -> (rows, nchanout) uint8 2-bit levels."""
    npol, T, C = out.shape
    ns = g.nscrunch
    if weights is None:
        if npol == 2:
            out = math.sqrt(0.5) * (out[0] + out[1])[None]
        y = out.reshape(1, T // ns, ns, C).sum(dim=2) / math.sqrt(ns)
    else:
        w = weights
        if npol == 2:
            g0, g1 = w[0] >= g.min_weight, w[1] >= g.min_weight
            both = (g0 & g1)[:, None]
            xg = out[0] * g0[:, None] + out[1] * g1[:, None]
            out = torch.where(both, math.sqrt(0.5) * (out[0] + out[1]),
                              xg)[None]
            w = torch.where(g0 & g1, 0.5 * (w[0] + w[1]),
                            w[0] * g0 + w[1] * g1)[None]
        w = w.reshape(1, T // ns, ns)
        good = w >= g.min_weight
        wg = torch.where(good, w, 0.0)
        acc = (wg[..., None] * out.reshape(1, T // ns, ns, C)).sum(dim=2)
        cnt = good.sum(dim=-1).clamp(min=1)
        ok = wg.mean(dim=-1) >= g.min_weight
        y = torch.where(ok[..., None], acc / torch.sqrt(cnt[..., None]), 0.0)
    y = y[0, :, g.chanmin:g.chanmax + 1]
    t0, t1, t2 = QUANT2_THRESH
    return ((y >= t0).to(torch.uint8) + (y >= t1).to(torch.uint8)
            + (y >= t2).to(torch.uint8))


# --- one second ---------------------------------------------------------

def second(g: Geometry, raw: torch.Tensor, st: State, since: int,
           low: bool = False) -> tuple:
    """(SecondOut, next State) of raw (npol, rate) uint8; `since` counts
    the spectra from the burst's arrival to the second's first spectrum
    (< 0: none injected)."""
    x = raw.to(torch.float64) / 128.0 - 1.0
    x = torch.where(raw == 0, 0.0, x)
    nh = (g.ntap - 1) * g.nfft
    nspec = g.spectra
    track = (frb_track(g, since, nspec, raw.device)
             if g.inject and since >= 0 else None)
    x_kur, w_blk = rfi_front(g, x, low)
    weights, wtail = w_blk, st.wtail
    if g.channelizer == "pfb":
        _, e = pfb_window(g, x.device)
        ext = torch.cat([st.wtail, w_blk], dim=1)
        weights = sum(ext[:, t:t + nspec] * e[t] for t in range(g.ntap))
        wtail = w_blk[:, nspec - (g.ntap - 1):]

    def power(v, tail):
        spec = channelize(g, v, tail, low)
        if track is not None:
            spec = torch.where(track[None], spec * g.inject_amp, spec)
        return _detect(spec)

    out, bp, n0 = ema(power(x, st.tail[0]), None, st.bp, g.bp_scale,
                      g.tile, st.n[0], g.forget)
    lev = levels(g, out, None)
    del out
    p = power(x_kur, st.tail[1])
    good = weights > 0.0
    pw = torch.where(good[:, :, None],
                     p / torch.where(good, weights, 1.0)[:, :, None], 0.0)
    del p
    out, bp_kur, n1 = ema(pw, good, st.bp_kur, g.bp_scale, g.tile, st.n[1],
                          g.forget)
    lev_kur = levels(g, out, weights)
    del out, pw
    tail = torch.stack([x[:, x.shape[1] - nh:], x_kur[:, x.shape[1] - nh:]])
    n = torch.stack([n0, n1])
    nxt = State(bp=bp, bp_kur=bp_kur, tail=tail, wtail=wtail, n=n)
    return SecondOut(lev, lev_kur, weights, bp, bp_kur,
                     n >= g.forget), nxt


def seed_spectra(g: Geometry) -> int:
    """Spectra an observation's first bandpass is seeded from: the EMA's
    own length (2 - s) / s in whole segments, at most a second's."""
    s = g.tsamp / g.bp_tsmooth
    segs = int(np.ceil((2.0 - s) / s / g.tile))
    return min(segs, g.seg_per_sec) * g.tile


def seed(g: Geometry, raw: torch.Tensor, st: State, low: bool = False
         ) -> State:
    """The observation's first bandpasses: each stream's mean over the
    first seed_spectra(g) spectra of its first second (the kurtosis
    stream's over the spectra of non-zero weight; 1 where there is no
    power), with no burst injected.  With the WOLA the first ntap - 1
    spectra, which draw on the empty tail, are left out."""
    n = seed_spectra(g)
    raw = raw[:, :n * g.nfft]
    x = torch.where(raw == 0, 0.0, raw.to(torch.float64) / 128.0 - 1.0)
    skip = g.ntap - 1
    power = lambda v, tail: _detect(channelize(g, v, tail, low))
    m = power(x, st.tail[0])[:, skip:].mean(dim=1)
    bp = torch.where(st.bp == 0.0, torch.where(m == 0.0, 1.0, m), st.bp)
    x_kur, w = rfi_front(g, x, low)
    if g.channelizer == "pfb":
        _, e = pfb_window(g, x.device)
        ext = torch.cat([st.wtail, w], dim=1)
        w = sum(ext[:, t:t + w.shape[1]] * e[t] for t in range(g.ntap))
    p = power(x_kur, st.tail[1])
    good = (w > 0.0)[:, skip:]
    pw = torch.where(good[:, :, None], p[:, skip:] / torch.where(
        good, w[:, skip:], 1.0)[:, :, None], 0.0)
    ng = good.sum(dim=1)[:, None]
    m = torch.where(ng > 0, pw.sum(dim=1) / ng.clamp(min=1), 1.0)
    bp_kur = torch.where(st.bp_kur == 0.0, m, st.bp_kur)
    return State(bp=bp, bp_kur=bp_kur, tail=st.tail, wtail=st.wtail,
                 n=st.n)


def since_of(g: Geometry, k: int) -> int:
    """`since` of observation second k: spectra after the burst armed at
    the top of the data-minute that holds k (-1 without injection)."""
    return (k % INJECT_PERIOD_S) * g.spectra if g.inject else -1


def run(g: Geometry, staged: list, first: int, last: int, low: bool = False
        ) -> dict:
    """{k: SecondOut} for observation seconds first..last of a stream
    that cycles `staged` (second k is staged[k % len(staged)]), from
    Geometry.warmup seconds before `first`, or from the observation's start and
    its seeded bandpasses (`seed`)."""
    dev = staged[0].device
    st = fresh_state(g, dev)
    outs = {}
    for k in range(max(0, first - g.warmup), last + 1):
        if k == 0:
            st = seed(g, staged[0], st, low)
        o, st = second(g, staged[k % len(staged)], st, since_of(g, k),
                       low)
        if k >= first:
            outs[k] = o
    return outs
