"""Gulp-based single-pulse search engine (the heimdall_stream role).

Port of vlite_fast_tpu/models/search.py.  One gulp on the device:
dedisperse the packed rows (ops/dedisperse_pallas.dedisperse_pallas_packed:
the CUDA kernel on a CUDA tensor, dequantize and the gather engine on a
CPU one) -> boxcar S/N -> top-k per DM band; only the packed crossings come back to the host, which clusters
them into candidates.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from vlite_fast_tpu_torch import devices
from vlite_fast_tpu_torch.config import SearchConfig
from vlite_fast_tpu_torch.ops import dedisperse as dd
from vlite_fast_tpu_torch.ops import dedisperse_pallas as ddp
from vlite_fast_tpu_torch.ops import quantize as q_ops


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


def _device_gulp(packed: torch.Tensor, plan: dd.DedispPlan, *,
                 widths: tuple, k: int, nbit: int, nchan: int, nbands: int,
                 thresh: float) -> torch.Tensor:
    """One gulp on the packed rows' device: dedisperse the packed rows
    (the kernel dequantizes and zaps as it stages them) -> boxcar S/N ->
    banded top-k crossings."""
    ntime_out = packed.shape[0] - plan.max_delay
    dmt = ddp.dedisperse_pallas_packed(packed, nbit, nchan, plan, ntime_out)
    snr = dd.boxcar_snr(dmt, plan.nchan_eff, widths)
    return pack_topk_banded(snr, k, nbands, thresh)


class SinglePulseSearch:
    """One beam's search engine.  Stateless across gulps except the plan."""

    def __init__(self, scfg: SearchConfig, tsamp: float,
                 freqs_mhz: np.ndarray, nsub: int = 0, nbatch: int = 0,
                 device="cuda"):
        if scfg.engine == "fourier":
            raise NotImplementedError("the 'fourier' engine is not ported")
        self.scfg = scfg
        self.device = devices.resolve(device)
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

    @property
    def overlap(self) -> int:
        """Lookahead samples a gulp needs beyond its own span."""
        return self.plan.max_delay

    def _top_crossings(self, packed_dev: torch.Tensor, nbit: int):
        k = self.scfg.topk or min(16 * self.scfg.max_candidates, 20000)
        packed = _device_gulp(
            packed_dev, self.plan, widths=self.widths, k=k, nbit=nbit,
            nchan=len(self.freqs_mhz), nbands=self.nbands,
            thresh=float(self.scfg.snr_thresh))
        ntime_out = packed_dev.shape[0] - self.plan.max_delay
        return packed, (len(self.widths), len(self.dms), ntime_out)

    def _cands_from_crossings(self, packed, shape, t_offset, nvalid
                              ) -> List[dd.Candidate]:
        nw, ndm, ntime = [int(s) for s in shape]
        vals, hits, n_cross, saturated = decode_crossings(
            packed.cpu().numpy(), nw, ndm, ntime, self.nbands,
            self.scfg.snr_thresh)
        self.last_gulp_stats = {"n_crossings": n_cross,
                                "saturated_bands": saturated}
        cands = dd.cluster_hits(
            hits, vals, self.dms, self.tsamp, widths=self.widths,
            t_offset=t_offset, max_cands=self.scfg.max_candidates)
        limit = t_offset + nvalid      # drop anything inside the padding
        return [c for c in cands if c.peak_idx < limit]

    def search_gulp_packed(self, packed_block: np.ndarray, nbit: int,
                           t_offset: int = 0) -> List[dd.Candidate]:
        """Search one gulp from packed host rows (time, nbytes), padded
        with the quantizer's near-zero level and dequantized on the
        device."""
        full = self.scfg.gulp_samps + self.overlap
        nvalid = packed_block.shape[0] - self.overlap
        if packed_block.shape[0] < full:
            pad = np.full((full - packed_block.shape[0],
                           packed_block.shape[1]), q_ops.NEAR_ZERO_FILL[nbit],
                          np.uint8)
            packed_block = np.concatenate([packed_block, pad], axis=0)
        crossings, shape = self._top_crossings(
            torch.as_tensor(packed_block, device=self.device), nbit=nbit)
        return self._cands_from_crossings(crossings, shape, t_offset, nvalid)

    def search_gulp_device(self, packed_dev: torch.Tensor, nbit: int,
                           t_offset: int, nvalid: int) -> List[dd.Candidate]:
        """Search one gulp whose packed rows are already on the device,
        exactly (gulp + overlap, nbytes)."""
        full = self.scfg.gulp_samps + self.overlap
        if int(packed_dev.shape[0]) != full:
            raise ValueError(f"device gulp must be padded to {full} rows")
        crossings, shape = self._top_crossings(packed_dev, nbit=nbit)
        return self._cands_from_crossings(crossings, shape, t_offset, nvalid)


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
