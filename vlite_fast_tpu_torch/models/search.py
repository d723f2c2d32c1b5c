"""Gulp-based single-pulse search engine (the heimdall_stream role).

Port of vlite_fast_tpu/models/search.py.  One gulp on the device:
dedisperse the packed rows (ops/dedisperse_pallas.dedisperse_pallas_packed:
the CUDA kernel on a CUDA tensor, dequantize and the gather engine on a
CPU one) or a float filterbank (the coadd's float16 stream, cast to f32
on the device: the same kernel's f32 entry, dedisperse_pallas) -> boxcar
S/N -> top-k per DM band; only the packed crossings come back to the
host, which clusters them into candidates.  SearchConfig.engine
'fourier' dedisperses by Fourier phase ramps instead
(ops/dedisperse.dedisperse_fourier, on any device; packed rows are
dequantized first); 'auto', 'pallas' and 'subband' all take the fold
kernel on a CUDA tensor and the gather engine on a CPU one
(`resolve_engine` names what 'auto' gives on a device).

A gulp is searched over the rows it is given.  A stream's last gulp,
short of gulp + overlap rows, gives fewer outputs, and each DM's mean and
noise come from those alone.  The JAX package pads it to the full shape
(one TPU program for every gulp); padded rows sum fewer real channels,
read as low noise, and make the real head read hot.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from vlite_fast_tpu_torch import devices
from vlite_fast_tpu_torch.config import SearchConfig
from vlite_fast_tpu_torch.ops import boxcar_topk as bt
from vlite_fast_tpu_torch.ops import dedisperse as dd
from vlite_fast_tpu_torch.ops import dedisperse_pallas as ddp
from vlite_fast_tpu_torch.ops import quantize as q_ops
from vlite_fast_tpu_torch.utils import spans


def make_dm_grid(scfg: SearchConfig, tsamp: float,
                 freqs_mhz: np.ndarray) -> np.ndarray:
    """'tol': the dedisp/heimdall -dm_tol grid, padded past dm_max by the
    final step to a multiple of 128; 'linear': scfg.ndm even trials."""
    if scfg.dm_grid_mode != "tol":
        return dd.dm_grid(scfg.dm_min, scfg.dm_max, scfg.ndm)
    dms = dd.dm_grid_tol(scfg.dm_min, scfg.dm_max, tsamp,
                         np.asarray(freqs_mhz), tol=scfg.dm_tol)
    pad = (-len(dms)) % 128
    if pad and len(dms) >= 2:
        step = dms[-1] - dms[-2]
        dms = np.concatenate([dms, dms[-1] + step * np.arange(1, pad + 1)])
    return dms


def resolve_engine(engine: str, device) -> str:
    """The engine `engine` gives on `device`: 'auto' -> 'pallas' (the
    CUDA fold kernel, ops/dedisperse_pallas) on a CUDA device, 'subband'
    (the gather engine) on the CPU; any other value as it is."""
    if engine != "auto":
        return engine
    return "pallas" if torch.device(device).type == "cuda" else "subband"


def boxcar_widths(boxcar_max: int) -> tuple:
    w, out = 1, []
    while w <= boxcar_max:
        out.append(w)
        w *= 2
    return tuple(out)


def effective_nbands(ndm: int, requested: int) -> int:
    """The per-DM-band top-k layout needs nbands | ndm; else one band.
    Shared by the device packer and the host decoder."""
    return requested if requested >= 1 and ndm % requested == 0 else 1


def pack_topk_banded(snr: torch.Tensor, k: int, nbands: int,
                     thresh: float) -> torch.Tensor:
    """(nw, ndm, ntime) S/N cube -> (2, nbands*kb + 1) int32, kb = k //
    nbands slots per contiguous DM band (exact torch.topk).
    Row 0: the f32 S/N bit patterns, last column the count of threshold
    crossings in the whole cube; row 1: flat indices within each band."""
    nw, ndm, ntime = snr.shape
    nbands = effective_nbands(ndm, nbands)
    kb = max(1, min(k // nbands, nw * (ndm // nbands) * ntime))
    count = (snr > thresh).sum().to(torch.int32)
    banded = snr.reshape(nw, nbands, ndm // nbands, ntime).transpose(0, 1) \
        .reshape(nbands, -1)
    vals, idx = torch.topk(banded, kb, dim=1)
    row0 = torch.cat([vals.reshape(-1).view(torch.int32), count[None]])
    row1 = torch.cat([idx.reshape(-1).to(torch.int32),
                      torch.zeros(1, dtype=torch.int32, device=snr.device)])
    return torch.stack([row0, row1])


def boxcar_topk(dmt: torch.Tensor, nchan_eff: float, widths: tuple, k: int,
                nbands: int, thresh: float, noise: str = "measured",
                skip: int = 0) -> torch.Tensor:
    """pack_topk_banded(boxcar_snr(dmt, ...), k, nbands, thresh) of a
    (ndm, ntime) DM-time plane, whose S/N frame starts `skip` outputs
    before dmt's first (those outputs S/N 0, the time index in the whole
    frame; only dmt's outputs give each DM's mean and noise).  Device
    stages of the bound record (spans.stage): "boxcar", "topk"; the last
    runs on to the caller's next mark.

    A CPU tensor takes the torch passes (the whole S/N cube, then
    torch.topk); a CUDA tensor the two launches of ops/boxcar_topk (no
    cube: the same crossings in float32, rounding aside; ties at a band's
    cutoff taken in no fixed order) or an error."""
    ndm, nt = dmt.shape
    nw = len(widths)
    nbands = effective_nbands(ndm, nbands)
    ntf = skip + nt
    kb = max(1, min(k // nbands, nw * (ndm // nbands) * ntf))
    spans.stage("boxcar")
    if dmt.device.type == "cpu":
        snr = dd.boxcar_snr(dmt, nchan_eff, widths, noise=noise) \
            if nt else None
        if skip or snr is None:
            full = torch.zeros((nw, ndm, ntf), dtype=torch.float32)
            if snr is not None:
                full[:, :, skip:] = snr
            snr = full
        spans.stage("topk")
        return pack_topk_banded(snr, k, nbands, thresh)
    if dmt.device.type != "cuda":
        raise ValueError(f"boxcar_topk: unsupported device {dmt.device}")
    if dmt.dtype != torch.float32 or dmt.dim() != 2:
        raise ValueError("boxcar_topk: dmt must be (ndm, ntime) float32")
    if not nt:          # nothing to search: no crossing, every slot empty
        spans.stage("topk")
        out = torch.zeros((2, nbands * kb + 1), dtype=torch.int32,
                          device=dmt.device)
        out[0, :-1] = bt.NEG_INF_BITS
        return out
    launch = bt.Launch(dmt.contiguous(), nchan_eff, widths, nbands, kb,
                       float(thresh), noise, skip)
    launch.boxcar()
    spans.stage("topk")
    launch.topk()
    return launch.out


def decode_crossings(packed: np.ndarray, nw: int, ndm: int, ntime: int,
                     nbands: int, snr_thresh: float):
    """Host-side inverse of pack_topk_banded: (vals, hits (n, 3)
    [width_idx, dm_idx, t_idx], n_crossings, saturated_bands)."""
    arr = np.asarray(packed)
    n_crossings = int(arr[0, -1])
    vals = arr[0, :-1].view(np.float32)
    idx = arr[1, :-1].astype(np.int64)
    nbands = effective_nbands(ndm, nbands)
    kb = vals.size // nbands
    vals = vals.reshape(nbands, kb)
    idx = idx.reshape(nbands, kb)
    dmb = ndm // nbands
    if kb >= nw * dmb * ntime:
        saturated = 0
    else:
        saturated = int((vals.min(axis=1) > snr_thresh).sum())
    keep = vals > snr_thresh
    band_of = np.broadcast_to(np.arange(nbands)[:, None], vals.shape)
    v, j, b = vals[keep], idx[keep], band_of[keep]
    hits = np.stack([j // (dmb * ntime), b * dmb + (j // ntime) % dmb,
                     j % ntime], axis=1)
    return v, hits, n_crossings, saturated


def dedisperse(fb: torch.Tensor, plan: dd.DedispPlan, ntime_out: int, *,
               engine: str = "auto", nbit: int = 0,
               nchan: int = 0) -> torch.Tensor:
    """The (ndm, ntime_out) DM-time plane of fb by `engine`.  fb is packed
    rows (time, nbytes) when nbit > 0 (the fold kernel dequantizes and
    zaps as it stages them; the Fourier engine dequantizes them first),
    else a float filterbank (time, nchan) of any float dtype, cast to f32
    here."""
    if engine == "fourier":
        if nbit:
            fb = q_ops.dequantize(fb, nbit)
            fb = fb.reshape(fb.shape[0], -1)[:, :nchan]
        return dd.dedisperse_fourier(fb.to(torch.float32), plan, ntime_out)
    if nbit:
        return ddp.dedisperse_pallas_packed(fb, nbit, nchan, plan, ntime_out)
    return ddp.dedisperse_pallas(fb.to(torch.float32), plan, ntime_out)


def _device_gulp(fb: torch.Tensor, plan: dd.DedispPlan, *,
                 widths: tuple, k: int, nbit: int, nchan: int, nbands: int,
                 thresh: float, engine: str = "auto") -> torch.Tensor:
    """One gulp on fb's device: dedisperse (see `dedisperse`) -> boxcar
    S/N -> banded top-k crossings (`boxcar_topk`), each a device stage of
    the bound record (spans.stage; nothing is recorded without one)."""
    ntime_out = fb.shape[0] - plan.max_delay
    spans.stage("dedisperse")
    dmt = dedisperse(fb, plan, ntime_out, engine=engine, nbit=nbit,
                     nchan=nchan)
    out = boxcar_topk(dmt, plan.nchan_eff, widths, k, nbands, thresh)
    spans.stage(None)
    return out


def _gulp_record() -> spans.Record:
    """The gulp record the caller bound (StationPipeline), else one of
    the search's own that nobody reads."""
    rec = spans.bound_record()
    return rec if rec is not None else spans.Record("gulp", -1)


# the host's work of a gulp, by part (SinglePulseSearch.host_seconds): the
# device passes' dispatch, the wait for them and the crossings' copy back,
# decode_crossings, cluster_hits; timed as the gulp record's spans
# "dispatch", "wait", "decode", "cluster"
GULP_HOST_PARTS = ("dispatch", "fetch", "decode", "cluster")


class SinglePulseSearch:
    """One beam's search engine.  Stateless across gulps except the plan
    and host_seconds, the host's seconds by part (GULP_HOST_PARTS) summed
    over every gulp it has searched.  Each gulp's host parts are spans,
    and the rows it hands to the clustering the counter "cluster_rows",
    of the gulp record its caller bound (spans.bound), if any."""

    def __init__(self, scfg: SearchConfig, tsamp: float,
                 freqs_mhz: np.ndarray, nsub: int = 0, nbatch: int = 0,
                 device="cuda"):
        self.scfg = scfg
        self.device = devices.resolve(device)
        self.engine = resolve_engine(scfg.engine, self.device)
        self.tsamp = float(tsamp)
        self.freqs_mhz = np.asarray(freqs_mhz)
        self.dms = make_dm_grid(scfg, self.tsamp, self.freqs_mhz)
        self.widths = boxcar_widths(scfg.boxcar_max)
        self.plan = dd.make_plan(self.dms, self.freqs_mhz, self.tsamp,
                                 nsub=nsub or scfg.nsub,
                                 nbatch=nbatch or scfg.nbatch,
                                 zap_ranges=scfg.zap_ranges,
                                 device=self.device)
        self.nbands = effective_nbands(len(self.dms), scfg.topk_dm_bands)
        self.last_gulp_stats = {"n_crossings": 0, "saturated_bands": 0}
        self.host_seconds = dict.fromkeys(GULP_HOST_PARTS, 0.0)

    @property
    def overlap(self) -> int:
        """Lookahead samples a gulp needs beyond its own span."""
        return self.plan.max_delay

    def snr_cube(self, fb_block) -> torch.Tensor:
        """(gulp + overlap, nchan) float32 -> (nwidth, ndm, gulp) S/N on
        the search's device."""
        fb = torch.as_tensor(np.asarray(fb_block, dtype=np.float32),
                             device=self.device)
        ntime_out = fb.shape[0] - self.plan.max_delay
        dmt = dedisperse(fb, self.plan, ntime_out, engine=self.engine)
        return dd.boxcar_snr(dmt, self.plan.nchan_eff, self.widths)

    def _top_crossings(self, fb_dev: torch.Tensor, nbit: int = 0):
        """fb_dev: packed rows when nbit > 0, else a float filterbank."""
        k = self.scfg.topk or min(16 * self.scfg.max_candidates, 20000)
        with _gulp_record().span("dispatch") as dispatch:
            packed = _device_gulp(
                fb_dev, self.plan, widths=self.widths, k=k, nbit=nbit,
                nchan=len(self.freqs_mhz), nbands=self.nbands,
                thresh=float(self.scfg.snr_thresh), engine=self.engine)
        ntime_out = fb_dev.shape[0] - self.plan.max_delay
        self.host_seconds["dispatch"] += dispatch.seconds
        return packed, (len(self.widths), len(self.dms), ntime_out)

    def _check_rows(self, rows: int) -> None:
        if rows <= self.overlap:
            raise ValueError(f"a gulp of {rows} rows has no output: it "
                             f"needs more than the overlap {self.overlap}")

    def _cands_from_crossings(self, packed, shape, t_offset
                              ) -> List[dd.Candidate]:
        nw, ndm, ntime = [int(s) for s in shape]
        rec = _gulp_record()
        with rec.span("wait") as wait:
            packed = packed.cpu().numpy()
        with rec.span("decode") as decode:
            vals, hits, n_cross, saturated = decode_crossings(
                packed, nw, ndm, ntime, self.nbands, self.scfg.snr_thresh)
        self.last_gulp_stats = {"n_crossings": n_cross,
                                "saturated_bands": saturated}
        with rec.span("cluster") as cluster:
            cands = dd.cluster_hits(
                hits, vals, self.dms, self.tsamp, widths=self.widths,
                t_offset=t_offset, max_cands=self.scfg.max_candidates)
        rec.counters["cluster_rows"] = len(hits)
        for k, sp in zip(GULP_HOST_PARTS[1:], (wait, decode, cluster)):
            self.host_seconds[k] += sp.seconds
        return cands

    def search_gulp(self, fb_block: np.ndarray,
                    t_offset: int = 0) -> List[dd.Candidate]:
        """Search one gulp of a float filterbank (time, nchan).  The
        caller's dtype ships as it is (the coadd stream's float16: half
        the bytes of f32) and is cast to f32 on the device."""
        self._check_rows(fb_block.shape[0])
        crossings, shape = self._top_crossings(
            torch.as_tensor(fb_block, device=self.device))
        return self._cands_from_crossings(crossings, shape, t_offset)

    def search_gulp_packed(self, packed_block: np.ndarray, nbit: int,
                           t_offset: int = 0) -> List[dd.Candidate]:
        """Search one gulp from packed host rows (time, nbytes),
        dequantized on the device."""
        self._check_rows(packed_block.shape[0])
        crossings, shape = self._top_crossings(
            torch.as_tensor(packed_block, device=self.device), nbit=nbit)
        return self._cands_from_crossings(crossings, shape, t_offset)

    def search_gulp_device(self, packed_dev: torch.Tensor, nbit: int,
                           t_offset: int = 0) -> List[dd.Candidate]:
        """Search one gulp whose packed rows are already on the device."""
        self._check_rows(int(packed_dev.shape[0]))
        crossings, shape = self._top_crossings(packed_dev, nbit=nbit)
        return self._cands_from_crossings(crossings, shape, t_offset)

    def search_stream(self, fb: np.ndarray) -> List[dd.Candidate]:
        """Search a long (ntime, nchan) filterbank in overlapping gulps."""
        gulp = self.scfg.gulp_samps
        cands: List[dd.Candidate] = []
        t = 0
        while t < fb.shape[0]:
            block = fb[t:t + gulp + self.overlap]
            if block.shape[0] <= self.overlap + max(self.widths):
                break
            cands.extend(self.search_gulp(block, t_offset=t))
            t += gulp
        return cands


def filterbank_from_packed(packed: np.ndarray, nbit: int,
                           nchanout: int) -> np.ndarray:
    """Unpack a quantized filterbank block (time, bytes) -> (time, chan)
    float recentered to ~zero mean.  Pure numpy, for host readers."""
    packed = np.asarray(packed, dtype=np.uint8)
    if nbit == 8:
        lev = packed
    else:
        per_byte = 8 // nbit
        shifts = np.arange(per_byte, dtype=np.uint8) * nbit
        mask = np.uint8((1 << nbit) - 1)
        lev = ((packed[..., None] >> shifts) & mask).reshape(
            packed.shape[0], -1)
    lev = lev.reshape(packed.shape[0], -1)[:, :nchanout]
    if nbit == 2:
        centroids = np.array([-1.24, -0.098, 0.85, 1.94], np.float32)
        return centroids[lev.astype(np.int32)]
    if nbit == 4:
        return (lev.astype(np.float32) - 7.5) * np.float32(0.3188)
    return (lev.astype(np.float32) - 127.5) * np.float32(0.02957)
