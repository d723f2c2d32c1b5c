"""Host-side orchestration of one antenna stream on a torch device.

Port of vlite_fast_tpu/runtime/pipeline.py (GulpStream, DeviceGulpStream,
ObservationProducts, StationPipeline):

  seconds -> DSP chain (models/baseband_dsp) -> .fil file
          -> packed filterbank kept on the device -> gulp search
          (models/search) -> candidates

Host gating of the FRB injection is the JAX pipeline's: for the
inject_window_seconds after each minute's arm the armed program
(baseband_dsp.process_second with injection) runs; every other second
runs the injection-free twin, resolved once at construction from
chain_impl and twin_chain_impl as the JAX pipeline resolves them
(baseband_dsp.twin_config / twin_program: a fused chain kernel through
twin_second, or process_second with injection off).  A configuration the
resolution refuses raises ValueError here, not at its first second.  The
baseband ring (keep_ring) and the coadd/trigger/dumper roles are not
ported yet.
"""

from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass
from typing import Iterable, List, Optional

import numpy as np
import torch

from vlite_fast_tpu_torch import _build, devices
from vlite_fast_tpu_torch import constants as C
from vlite_fast_tpu_torch.config import PipelineConfig, SearchConfig
from vlite_fast_tpu_torch.models import baseband_dsp as dsp
from vlite_fast_tpu_torch.models import search as search_mod
from vlite_fast_tpu_torch.ops import dedisperse as dd
from vlite_fast_tpu_torch.ops import quantize as q_ops
from vlite_fast_tpu_torch.utils import sigproc
from vlite_fast_tpu_torch.utils.log import Metrics, RTMonitor, make_logger


@dataclass
class ObservationDocument:
    """The scan metadata the filterbank header needs (the fields of
    vlite_fast_tpu.runtime.control.ObservationDocument that
    StationPipeline reads)."""

    name: str = ""
    ra: float = 0.0              # radians
    dec: float = 0.0             # radians
    start_time: float = 0.0      # unix seconds


class GulpStream:
    """Bounded host block accumulator: consecutive (nsamp, ...) blocks
    with absolute sample offsets, pruned as gulps complete."""

    def __init__(self):
        self.blocks: List[np.ndarray] = []
        self.start = 0          # absolute sample index of blocks[0][0]

    @property
    def total(self) -> int:
        return self.start + sum(b.shape[0] for b in self.blocks)

    def append(self, block: np.ndarray) -> None:
        self.blocks.append(block)

    def window(self, start: int, stop: int) -> np.ndarray:
        parts = []
        off = self.start
        for blk in self.blocks:
            lo, hi = max(start - off, 0), min(stop - off, blk.shape[0])
            if lo < hi:
                parts.append(blk[lo:hi])
            off += blk.shape[0]
            if off >= stop:
                break
        return np.concatenate(parts, axis=0) if len(parts) != 1 else parts[0]

    def prune(self, keep_from: int) -> None:
        while self.blocks and (
                self.start + self.blocks[0].shape[0] <= keep_from):
            self.start += self.blocks[0].shape[0]
            self.blocks.pop(0)


class DeviceGulpStream:
    """Device-side mirror of GulpStream: the chain's packed output stays
    on the device and the search reads it in place.  Windows are served
    only when they start on a stored block boundary; other requests get
    None and the caller takes the host path."""

    def __init__(self):
        self.blocks: List[torch.Tensor] = []
        self.start = 0

    @property
    def total(self) -> int:
        return self.start + sum(int(b.shape[0]) for b in self.blocks)

    def append(self, block: torch.Tensor) -> None:
        self.blocks.append(block)

    def window(self, start: int, stop: int, pad_to: int = 0,
               fill: int = 0) -> Optional[torch.Tensor]:
        """[start, stop) as one device tensor, padded on the device with
        `fill` bytes up to pad_to rows; None if not resident/aligned."""
        off = self.start
        if start < off:
            return None
        i = 0
        while (i < len(self.blocks)
               and off + int(self.blocks[i].shape[0]) <= start):
            off += int(self.blocks[i].shape[0])
            i += 1
        if off != start:
            return None
        parts, have = [], 0
        j = i
        while j < len(self.blocks) and have < stop - start:
            parts.append(self.blocks[j])
            have += int(self.blocks[j].shape[0])
            j += 1
        if have < stop - start:
            return None
        cat = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
        cat = cat[:stop - start]
        if pad_to > stop - start:
            cat = torch.cat([cat, torch.full(
                (pad_to - (stop - start), int(cat.shape[1])), fill,
                dtype=torch.uint8, device=cat.device)], dim=0)
        return cat

    def host_window(self, start: int, stop: int) -> np.ndarray:
        parts = []
        off = self.start
        for blk in self.blocks:
            n = int(blk.shape[0])
            lo, hi = max(start - off, 0), min(stop - off, n)
            if lo < hi:
                parts.append(blk[lo:hi].cpu().numpy())
            off += n
            if off >= stop:
                break
        return (np.concatenate(parts, axis=0) if len(parts) != 1
                else parts[0])

    def prune(self, keep_from: int) -> None:
        while self.blocks and (
                self.start + int(self.blocks[0].shape[0]) <= keep_from):
            self.start += int(self.blocks[0].shape[0])
            self.blocks.pop(0)


@dataclass
class ObservationProducts:
    fil_path: Optional[str]
    candidates: List[dd.Candidate]
    seconds: int
    rt_factor: float
    start_unix: float = 0.0   # unix time of the first processed second


class StationPipeline:
    """One antenna stream end to end on `device`."""

    def __init__(self, station_id: int, cfg: PipelineConfig,
                 scfg: SearchConfig, out_dir: Optional[str] = None,
                 keep_ring: bool = False, write_cands: bool = True,
                 device="cuda"):
        if keep_ring:
            raise NotImplementedError(
                "keep_ring=True needs the baseband ring "
                "(vlite_fast_tpu.runtime.ring), which imports jax; the "
                "port does not have it yet")
        self.station_id = station_id
        self.cfg = cfg
        self.scfg = scfg
        self.device = devices.resolve(device)
        self.out_dir = out_dir or os.path.join(tempfile.gettempdir(),
                                               "vfast")
        os.makedirs(self.out_dir, exist_ok=True)
        self.log = make_logger(f"station{station_id:02d}")
        self.metrics = Metrics()
        self.search = search_mod.SinglePulseSearch(
            scfg, cfg.tsamp, cfg.freqs_mhz(),
            nsub=min(128, cfg.nchanout), nbatch=min(scfg.ndm, 128),
            device=self.device)
        self.write_cands = write_cands
        self.state = dsp.init_state(cfg, self.device)
        # the injection-free twin runs outside the window after each arm
        self._cfg_noinject = dsp.twin_config(cfg)
        self._twin = dsp.twin_program(cfg)
        self._inject_until = -1
        self._fb = GulpStream()
        self._fb_dev = DeviceGulpStream()
        self._searched_to = 0
        self._pending = None
        # wall seconds per fed second, by program ('armed' / 'twin')
        self.feed_seconds = {"armed": [], "twin": []}

    def _fil_header(self, od: ObservationDocument,
                    tstart_unix: float) -> sigproc.FilterbankHeader:
        cfg = self.cfg
        return sigproc.FilterbankHeader(
            source_name=od.name or "unknown",
            telescope_id=self.station_id,
            src_raj=sigproc.radians_to_sigproc(od.ra, True),
            src_dej=sigproc.radians_to_sigproc(od.dec, False),
            fch1=cfg.fch1_mhz, foff=cfg.chan_bw_mhz, nchans=cfg.nchanout,
            nbits=cfg.nbit, tstart=tstart_unix / 86400.0 + 40587.0,
            tsamp=cfg.tsamp, nifs=cfg.npol_out)

    def run_observation(self, seconds: Iterable, od: ObservationDocument,
                        write_fil: bool = True, search_live: bool = True
                        ) -> ObservationProducts:
        """seconds: iterable of (unix_second, samples[npol, rate] uint8)."""
        self.begin_observation(od, write_fil=write_fil,
                               search_live=search_live)
        for sec, buf in seconds:
            self.feed_second(sec, buf)
        return self.end_observation()

    def begin_observation(self, od: ObservationDocument,
                          write_fil: bool = True,
                          search_live: bool = True) -> None:
        self.state = dsp.init_state(self.cfg, self.device)
        self._fb, self._searched_to = GulpStream(), 0
        self._fb_dev = DeviceGulpStream()
        self._pending = None
        self._od = od
        self._write_fil = write_fil
        self._search_live = search_live
        self._rt = RTMonitor()
        self._fil = None
        self._fil_plain = None
        self._fil_path = None
        self._cands: List[dd.Candidate] = []
        self._nsec = 0
        self._t0_unix = None
        self._inject_until = -1
        self.feed_seconds = {"armed": [], "twin": []}
        self._prewarm()

    def _prewarm(self) -> None:
        """Build the CUDA kernels before the first second is fed, so no
        build stalls the stream mid-observation (a no-op once loaded)."""
        if self.device.type == "cuda":
            _build.load_all()

    def feed_second(self, sec: float, buf) -> List[dd.Candidate]:
        """Run one second; returns candidates that became final while it
        was processed."""
        cfg = self.cfg
        t_start = time.perf_counter()
        if self._t0_unix is None:
            self._t0_unix = float(sec)
            if self._write_fil:
                stamp = time.strftime("%Y%m%d_%H%M%S",
                                      time.gmtime(self._t0_unix))
                self._fil_path = os.path.join(
                    self.out_dir, f"{stamp}_ea{self.station_id:02d}.fil")
                self._fil = sigproc.FilterbankWriter(
                    self._fil_path, self._fil_header(self._od,
                                                     self._t0_unix))
                if cfg.rfi_mode == 2:
                    # mode 2 writes both streams; the excised one is the
                    # searched primary
                    self._fil_plain = sigproc.FilterbankWriter(
                        self._fil_path.replace(".fil", "_plain.fil"),
                        self._fil_header(self._od, self._t0_unix))
        raw = torch.as_tensor(buf).to(self.device)
        arm = bool(cfg.inject_frb and self._nsec % C.INJECT_PERIOD_S == 0)
        if arm:
            self._inject_until = self._nsec + dsp.inject_window_seconds(cfg)
        # host-side injection gating: outside the window after arming the
        # track cannot intersect this second, so the injection-free twin
        # runs (byte-exact: the skipped path multiplies by all-ones)
        armed = cfg.inject_frb and self._nsec < self._inject_until
        if armed:
            out, self.state = dsp.process_second(cfg, raw, self.state, arm)
        else:
            out, self.state = self._twin(self._cfg_noinject, raw,
                                         self.state, arm)
        pending_new = out.packed_kur if cfg.rfi_mode else out.packed
        plain_new = (out.packed if (cfg.rfi_mode == 2
                                    and self._fil_plain is not None)
                     else None)
        before = len(self._cands)
        if self._pending is not None:
            self._drain(*self._pending)
        self._pending = (pending_new, plain_new)
        self._nsec += 1
        deficit = self._rt.add(1.0)
        if deficit is not None:
            self.log.warning("falling behind real time by %.2f s", deficit)
        if self.device.type == "cuda":
            # so feed_seconds times the device work of this second
            torch.cuda.synchronize(self.device)
        self.feed_seconds["armed" if armed else "twin"].append(
            time.perf_counter() - t_start)
        return self._cands[before:]

    def end_observation(self) -> ObservationProducts:
        if self._pending is not None:
            self._drain(*self._pending)
            self._pending = None
        if self._search_live:
            self._cands.extend(self._search_ready(flush=True))
        if self._fil is not None:
            self._fil.close()
        if self._fil_plain is not None:
            self._fil_plain.close()
        cands, fil_path = self._cands, self._fil_path
        self.metrics.set("vfast_rt_factor", self._rt.realtime_factor)
        self.metrics.set("vfast_candidates", len(cands))
        if fil_path and self.write_cands and cands:
            with open(fil_path.replace(".fil", ".cand"), "w") as fp:
                for c in cands:
                    fp.write(c.to_line() + "\n")
        return ObservationProducts(
            fil_path=fil_path, candidates=cands, seconds=self._nsec,
            rt_factor=self._rt.realtime_factor,
            start_unix=self._t0_unix or 0.0)

    def _drain(self, packed_dev: torch.Tensor,
               plain_dev: Optional[torch.Tensor] = None) -> None:
        if self._search_live:
            # kept on the device only while a search will consume it
            self._fb_dev.append(packed_dev)
        if self._fil is not None:
            packed = packed_dev.cpu().numpy()
            self._fil.write_block(packed)
            if plain_dev is not None and self._fil_plain is not None:
                self._fil_plain.write_block(plain_dev.cpu().numpy())
            if self._search_live:
                self._fb.append(packed)
        if self._search_live:
            self._cands.extend(self._search_ready())

    def _search_ready(self, flush: bool = False) -> List[dd.Candidate]:
        """Search every complete gulp accumulated since the last call."""
        gulp = self.scfg.gulp_samps
        overlap = self.search.overlap
        total = max(self._fb.total, self._fb_dev.total)
        out: List[dd.Candidate] = []
        while total - self._searched_to >= gulp + overlap or (
                flush and total - self._searched_to > overlap + 64):
            stop = min(self._searched_to + gulp + overlap, total)
            nrows = stop - self._searched_to
            fill = q_ops.NEAR_ZERO_FILL[self.cfg.nbit]
            dev_win = self._fb_dev.window(self._searched_to, stop,
                                          pad_to=gulp + overlap, fill=fill)
            if dev_win is not None:
                found = self.search.search_gulp_device(
                    dev_win, self.cfg.nbit, t_offset=self._searched_to,
                    nvalid=nrows - overlap)
            else:
                packed = (self._fb.window(self._searched_to, stop)
                          if self._fb.total >= stop
                          else self._fb_dev.host_window(
                              self._searched_to, stop))
                found = self.search.search_gulp_packed(
                    packed, self.cfg.nbit, t_offset=self._searched_to)
            out.extend(found)
            st = self.search.last_gulp_stats
            self.metrics.set("vfast_gulp_crossings", st["n_crossings"])
            if st["saturated_bands"]:
                self.metrics.inc("vfast_topk_saturated_total",
                                 st["saturated_bands"])
            if found:
                lat = max((stop * self.cfg.tsamp) - c.peak_time
                          for c in found)
                self.metrics.set("vfast_cand_latency_data_s",
                                 round(lat, 2))
            self.metrics.inc("vfast_gulps_searched")
            self._searched_to += min(gulp, nrows - overlap)
            self._fb.prune(self._searched_to)
            self._fb_dev.prune(self._searched_to)
            if flush and total - self._searched_to <= overlap + 64:
                break
        return out
