"""Host-side orchestration of antenna streams on a torch device.

Port of vlite_fast_tpu/runtime/pipeline.py (GulpStream, DeviceGulpStream,
ObservationProducts, StationPipeline, CoaddSearcher, ArrayPipeline):

  seconds -> baseband ring (C++ shm, pre-faulted, written on a thread
             of its own, for triggered dumps)
          -> DSP chain (models/baseband_dsp) -> .fil file, block taps
          -> packed filterbank kept on the device -> device taps, gulp
          search (models/search) -> candidates

and an ArrayPipeline fans N stations on one device into the coadd
search (summed on the device from the stations' device taps), the
coincidencer and the triggered dumper (on the rings' threads).

An observation's first second starts from baseband_dsp.seed_bandpass:
its bandpasses are seeded from the EMA's own length of spectra (0.25 s at
production) before the first program runs, where the JAX pipeline seeds
each from the first segment's tile.

Each second runs the program baseband_dsp.second_program gives for the
state's segments since the minute's arm (the armed program or the
injection-free twin; its docstring is the one account of the routing).
A configuration the twin's resolution refuses raises ValueError here,
not at its first second.

Nothing in the per-second loop waits for the device except the drain of
the previous second: at dispatch each second's packed rows (and the plain
stream's in rfi_mode 2) start an asynchronous copy into a pinned host
tensor of their own, followed by an event; the next second's drain waits
on that event only, then writes the .fil and feeds the block taps from
those bytes.  Each second gets a fresh pinned tensor, never a reused
one: the coadd and the host gulp stream keep a second's bytes after its
drain.  With do_histo each second's raw-sample histogram is added on the
device and written at the observation's end beside the .fil
(`*_histo.npz`, key `histogram`).

`run_observation(profile_dir=...)` records the observation with
torch.profiler (CPU and CUDA activities) and exports a Chrome trace
there; each second's program, each gulp's search and each drain is a
`record_function` range: "vfast.armed_second" / "vfast.twin_second",
"vfast.gulp_search", "vfast.drain" (the wait for a second's bytes,
the .fil and the taps; PROFILE_RANGES).

Each fed second and each gulp is a record of utils/spans: its host
spans (the second's parts, HOST_PARTS and the program's dispatch; the
gulp's latency from the start of the call that handed over its last row,
split into lag, dispatch, wait, decode and cluster, and the card's stall
after its fetch), counters (the seconds queued ahead of a gulp on the
card, the rows the clustering took, whether the gulp holds an injected
second) and device stages (process_second's and the gulp's, marked
while the record is bound).  host_seconds, feed_seconds and the search's
host_seconds are read from them; end_observation publishes the
observation's records (spans.last_observation).  While torch.profiler
records, the host spans are "vfast/..." ranges too.
"""

from __future__ import annotations

import collections
import os
import secrets
import tempfile
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from vlite_fast_tpu_torch import _build, devices
from vlite_fast_tpu_torch import constants as C
from vlite_fast_tpu_torch.config import (ArrayConfig, PipelineConfig,
                                         SearchConfig)
from vlite_fast_tpu_torch.models import baseband_dsp as dsp
from vlite_fast_tpu_torch.models import search as search_mod
from vlite_fast_tpu_torch.ops import dedisperse as dd
from vlite_fast_tpu_torch.ops import quantize as q_ops
from vlite_fast_tpu_torch.utils import spans
from vlite_fast_tpu_torch.runtime import trigger as trig
# ObservationDocument is imported from here too (chip_smoke, the tests)
from vlite_fast_tpu_torch.runtime.control import ObservationDocument
from vlite_fast_tpu_torch.runtime.dumper import TriggeredDumper
from vlite_fast_tpu_torch.runtime.ring import FLAG_OBS_START, RingBuffer
from vlite_fast_tpu_torch.utils import sigproc
from vlite_fast_tpu_torch.utils.log import Metrics, RTMonitor, make_logger

# the port's baseband rings are /vfast_torch_bb_<station>_<pid>_<random>:
# never a name the JAX package's rings (/vfast_bb_<station>) take, since
# creating a ring unlinks any segment of its name, and never the name of a
# ring of another process, even one of another pid namespace that shares
# /dev/shm
RING_PREFIX = "/vfast_torch_bb"


class GulpStream:
    """Bounded block accumulator: consecutive (nsamp, ...) blocks (host
    arrays, or tensors of one device) with absolute sample offsets,
    pruned as gulps complete."""

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
        if len(parts) == 1:
            return parts[0]
        if isinstance(parts[0], torch.Tensor):
            return torch.cat(parts, dim=0)
        return np.concatenate(parts, axis=0)

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

    def window(self, start: int, stop: int) -> Optional[torch.Tensor]:
        """[start, stop) as one device tensor; None if not
        resident/aligned."""
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
        return cat[:stop - start]

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
    dropped: int = 0
    start_unix: float = 0.0   # unix time of the first processed second


# the record_function ranges of a profiled observation
PROFILE_RANGES = ("vfast.armed_second", "vfast.twin_second",
                  "vfast.gulp_search", "vfast.drain")

# the host's work of each fed second, by part (StationPipeline.host_seconds)
HOST_PARTS = ("ring", "staging", "copy", "wait", "drain", "search")


class StationPipeline:
    """One antenna stream end to end on `device`.

    ring_seconds of baseband stay in a shared-memory ring for triggered
    dumps (keep_ring): it must exceed the gulp-bound candidate latency,
    or a dump always misses the event (40 s of production baseband is
    10.24 GB of /dev/shm).  A pipeline with a ring takes each second as
    host bytes (a numpy array or a CPU tensor), which the ring holds;
    without one a second may also be a tensor already on the device.

    The ring has a thread of its own, the reference's writer beside its
    pipeline: feed_second hands each second's bytes to it and goes on,
    and whatever reads the ring (a dump) runs on that thread too, after
    the writes queued before it (`on_ring`), so that it sees every second
    fed before it and no later write overwrites a slot under it.  The
    caller must not change a second's bytes once fed (the thread holds
    them until written); end_observation and close wait for the thread."""

    def __init__(self, station_id: int, cfg: PipelineConfig,
                 scfg: SearchConfig, out_dir: Optional[str] = None,
                 ring_seconds: int = 40, keep_ring: bool = True,
                 write_cands: bool = True, write_kurto: bool = False,
                 device="cuda"):
        self.station_id = station_id
        self.cfg = cfg
        self.scfg = scfg
        self.device = devices.resolve(device)
        self.out_dir = out_dir or os.path.join(tempfile.gettempdir(),
                                               "vfast")
        os.makedirs(self.out_dir, exist_ok=True)
        self.log = make_logger(f"station{station_id:02d}")
        self.metrics = Metrics()
        self.ring: Optional[RingBuffer] = None
        self._ring_thread: Optional[ThreadPoolExecutor] = None
        self._ring_jobs: collections.deque = collections.deque()
        if keep_ring:
            self.ring = RingBuffer(
                f"{RING_PREFIX}_{station_id:02d}_{os.getpid()}_"
                f"{secrets.token_hex(4)}",
                bufsz=cfg.npol_in * cfg.sample_rate, nbufs=ring_seconds,
                create=True)
            self._ring_thread = ThreadPoolExecutor(
                1, thread_name_prefix=f"vfast_ring{station_id:02d}")
        self.search = search_mod.SinglePulseSearch(
            scfg, cfg.tsamp, cfg.freqs_mhz(),
            nsub=min(128, cfg.nchanout), nbatch=min(scfg.ndm, 128),
            device=self.device)
        self.write_cands = write_cands
        self.write_kurto = write_kurto   # WRITE_KURTO role (weights dump)
        self._weights_accum: List[torch.Tensor] = []
        self._histo_accum: Optional[torch.Tensor] = None
        self.profile_path: Optional[str] = None   # the last trace written
        self.state = dsp.init_state(cfg, self.device)
        dsp.twin_config(cfg)        # raises on a configuration it refuses
        self._fb = GulpStream()
        self._fb_dev = DeviceGulpStream()
        self._searched_to = 0
        self._pending = None
        self._prewarmed = False
        self._staging = []      # pinned host copies of fed seconds
        self._new_records()
        # seconds per fed second, by program ('armed' / 'twin'): on a
        # card, the span on the device's timeline from the start to the
        # end of the work feed_second enqueued for that second (its device
        # time, plus any time the device waited on the host inside it),
        # read from CUDA events once they have completed; on the CPU, the
        # host's wall time of feed_second
        self.feed_seconds = {"armed": [], "twin": []}
        # the host's seconds of each fed second by part (HOST_PARTS): the
        # ring write, the pinned staging of a host second, the start of the
        # copies of its products to the host, the wait for the previous
        # second's bytes, the drain (.fil and block taps) and the gulp
        # searches the drain started
        self.host_seconds = {k: [] for k in HOST_PARTS}
        # taps: callables (station_id, abs_offset, packed_block) called on
        # every drained block, as host bytes (block_taps) or as the
        # program's rows where they are, on the device (device_taps: the
        # coadd-ring writer role)
        self.block_taps: List = []
        self.device_taps: List = []

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
                        write_fil: bool = True, search_live: bool = True,
                        profile_dir: Optional[str] = None
                        ) -> ObservationProducts:
        """seconds: iterable of (unix_second, samples[npol, rate] uint8).

        profile_dir: record the observation with torch.profiler (CPU, and
        CUDA on a card) and export a Chrome trace into that directory,
        named station<id>_<first unix second>.pt.trace.json
        (`self.profile_path`); open it in Perfetto or chrome://tracing."""
        if profile_dir:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            with profile(activities=acts) as prof:
                products = self.run_observation(seconds, od, write_fil,
                                                search_live)
            os.makedirs(profile_dir, exist_ok=True)
            self.profile_path = os.path.join(
                profile_dir, f"station{self.station_id:02d}_"
                f"{int(products.start_unix)}.pt.trace.json")
            prof.export_chrome_trace(self.profile_path)
            self.log.info("profile of the observation: %s",
                          self.profile_path)
            return products
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
        self._taps_offset = 0
        self._pending = None
        self._weights_accum = []
        self._histo_accum = None
        self._new_records()
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
        self.feed_seconds = {"armed": [], "twin": []}
        self.host_seconds = {k: [] for k in HOST_PARTS}
        self.prewarm()
        if self.ring is not None:
            self.ring.set_obs_header(od.to_ascii_header(self.station_id))

    def prewarm(self) -> None:
        """Before the first second is fed (once per pipeline;
        begin_observation calls it, a caller may call it before): build the
        CUDA kernels, then run the bandpass seed and each program the
        observation dispatches (the armed one if the configuration
        injects, and the twin) on a zero second from a fresh state, and
        one near-zero gulp through the search, discarding what they
        return.  The stream's first
        seconds then pay no first-use cost (cuBLAS handles, the caching
        allocator's first blocks, the kernels' attributes); the JAX
        package's _prewarm compiles both programs the same way."""
        if self.device.type != "cuda" or self._prewarmed:
            return
        _build.load_all()
        cfg = self.cfg
        zero = torch.zeros((cfg.npol_in, cfg.sample_rate), dtype=torch.uint8,
                           device=self.device)
        dsp.seed_bandpass(cfg, zero, dsp.init_state(cfg, self.device))
        if cfg.inject_frb:
            _, program, pcfg = dsp.second_program(cfg, 0)
            program(pcfg, zero, dsp.init_state(cfg, self.device), True)
        _, program, pcfg = dsp.second_program(cfg, -1)
        out, _ = program(pcfg, zero, dsp.init_state(cfg, self.device), False)
        row = (out.packed_kur if cfg.rfi_mode else out.packed).shape[1]
        gulp = self.scfg.gulp_samps
        self.search.search_gulp_device(
            torch.full((gulp + self.search.overlap, row),
                       q_ops.NEAR_ZERO_FILL[cfg.nbit], dtype=torch.uint8,
                       device=self.device), cfg.nbit)
        # the pinned host blocks of the seconds' rows that the stream
        # holds at once (the host gulp window, and a few in flight to the
        # .fil and the taps), allocated once here: the caching host
        # allocator keeps them when they are freed, so that no second
        # pays for pinning fresh pages
        rows = out.packed.shape[0]
        held = 2 * (-(-(gulp + self.search.overlap) // rows) + 4)
        blocks = [torch.empty(out.packed.shape, dtype=torch.uint8,
                              pin_memory=True) for _ in range(held)]
        del blocks
        torch.cuda.synchronize(self.device)
        self._prewarmed = True

    def _to_device(self, buf) -> torch.Tensor:
        """The fed second on the device.  A host array goes through one of
        two pinned buffers by an asynchronous copy; a buffer is refilled
        only once the copy out of it two seconds ago has completed."""
        if isinstance(buf, torch.Tensor) and buf.device == self.device:
            return buf
        if self.device.type != "cuda":
            return torch.as_tensor(buf).to(self.device)
        host = torch.as_tensor(buf)
        slot = self._staging.pop(0) if len(self._staging) == 2 else None
        if slot is None or slot[0].shape != host.shape \
                or slot[0].dtype != host.dtype:
            slot = [torch.empty(host.shape, dtype=host.dtype,
                                pin_memory=True), torch.cuda.Event()]
        pinned, done = slot
        done.synchronize()
        pinned.copy_(host)
        raw = pinned.to(self.device, non_blocking=True)
        done.record()
        self._staging.append(slot)
        return raw

    @staticmethod
    def _to_host(t: torch.Tensor) -> torch.Tensor:
        """t's bytes on the host: a CPU tensor as it is; a device tensor
        into a pinned host tensor of its own by an asynchronous copy (the
        caller records an event after it).  The caching host allocator
        hands a freed block out again only once the copies that used it
        have completed."""
        if t.device.type == "cpu":
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host

    def _new_records(self) -> None:
        """An observation's span records (utils/spans) start empty."""
        self.records = spans.Recorder()
        self._rec = None        # the record of the call in progress
        self._unread = collections.deque()   # records with unread marks
        self._rows = collections.deque()     # (first row, end, second)
        self._rows_in = 0       # rows that have joined the search stream
        self._ngulps = 0
        # the last gulp's stall: (its record, the start of the part now
        # open, None between calls)
        self._stall = None

    def _read_times(self, wait: bool = False) -> None:
        """Read the device marks of the records whose last mark has
        completed (every one with wait, after a synchronize), in order; a
        second's device span joins feed_seconds."""
        while self._unread and self._unread[0].resolve(wait):
            rec = self._unread.popleft()
            if rec.layer == "second":
                self.feed_seconds["armed" if rec.counters["armed"]
                                  else "twin"].append(rec.device_s)

    def _stall_to(self, t: float, dispatch: bool) -> None:
        """The stall after the last gulp's fetch: the card idles while the
        program works on the host, from the fetch's return to the end of
        its call and from the start of each later call to the next
        dispatch onto the card (dispatch: the stall ends at t); the
        caller's time between calls is not the program's."""
        if self._stall is not None:
            gulp, t0 = self._stall
            if t0 is not None:
                gulp.add("stall", t0, t, parent=None)
            self._stall = None if dispatch else (gulp, None)

    def _begin_call(self, rec: spans.Record) -> None:
        """A call into the pipeline starts: its spans go to `rec`, and the
        last gulp's stall goes on."""
        self._rec = rec
        if self._stall is not None:
            self._stall = (self._stall[0], rec.start)

    def feed_second(self, sec: float, buf) -> List[dd.Candidate]:
        """Run one second; returns candidates that became final while it
        was processed."""
        cfg = self.cfg
        if self.ring is not None and isinstance(buf, torch.Tensor) \
                and buf.device.type != "cpu":
            raise ValueError(
                f"station {self.station_id}: a pipeline with a ring takes "
                "each second as host bytes (a numpy array or a CPU tensor), "
                f"not a tensor on {buf.device}: the ring holds the host's "
                "bytes, and copying a device second back would cost a "
                "device-to-host copy of every second")
        rec = spans.Record("second", self._nsec, self.device.type == "cuda")
        self._begin_call(rec)
        rec.mark(None)
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
        if self.ring is not None:
            host = buf.numpy() if isinstance(buf, torch.Tensor) \
                else np.asarray(buf)
            self.on_ring(self._ring_write, host.reshape(-1), float(sec),
                         FLAG_OBS_START if self._nsec == 0 else 0, rec)
        with rec.span("staging"):
            raw = self._to_device(buf)
        arm = bool(cfg.inject_frb and self._nsec % C.INJECT_PERIOD_S == 0)
        kind, program, pcfg = dsp.second_program(
            cfg, 0 if arm else self.state.segs_since_inject)
        rec.counters["armed"] = int(kind == "armed")
        self._stall_to(time.perf_counter(), dispatch=True)
        with rec.span("program"), \
                torch.profiler.record_function(f"vfast.{kind}_second"):
            if self._nsec == 0:
                # the observation's first bandpass (dsp.seed_bandpass)
                self.state = dsp.seed_bandpass(cfg, raw, self.state)
            with spans.bound(rec):
                out, self.state = program(pcfg, raw, self.state, arm)
        if cfg.do_histo:
            # summed on the device; read at the observation's end
            h = out.histo.to(torch.int64)
            self._histo_accum = h if self._histo_accum is None \
                else self._histo_accum + h
        pending_new = out.packed_kur if cfg.rfi_mode else out.packed
        plain_new = (out.packed if (cfg.rfi_mode == 2
                                    and self._fil_plain is not None)
                     else None)
        host_new = plain_host = done = None
        with rec.span("copy"):
            if self._fil is not None or self.block_taps:
                # the copies start now, behind this second's kernels; the
                # next second's drain waits for them, not for the device's
                # queue
                host_new = self._to_host(pending_new)
                if plain_new is not None:
                    plain_host = self._to_host(plain_new)
                if self.device.type == "cuda":
                    done = torch.cuda.Event()
                    done.record()
            if self.write_kurto:
                # read after end_observation's synchronize
                self._weights_accum.append(self._to_host(out.weights))
        before = len(self._cands)
        if self._pending is not None:
            self._drain(*self._pending)
        self._pending = (pending_new, host_new, plain_host, done, rec)
        self._nsec += 1
        deficit = self._rt.add(1.0)
        if deficit is not None:
            self.log.warning("falling behind real time by %.2f s", deficit)
        rec.mark(None)
        self.records.seconds.append(rec)
        self._unread.append(rec)
        self._read_times()
        for k, v in rec.parts(HOST_PARTS).items():
            if k != "ring" or self.ring is None:   # else its thread's
                self.host_seconds[k].append(v)
        t = time.perf_counter()
        rec.add("second", rec.start, t, parent=None)
        self._stall_to(t, dispatch=False)
        return self._cands[before:]

    def end_observation(self) -> ObservationProducts:
        # the last drain and the flush gulp: spans of no fed second
        self._begin_call(spans.Record("end", self._nsec))
        self.sync_ring()
        if self._pending is not None:
            self._drain(*self._pending)
            self._pending = None
        if self._search_live:
            self._cands.extend(self._search_ready(flush=True))
        if self._fil is not None:
            self._fil.close()
        if self._fil_plain is not None:
            self._fil_plain.close()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._read_times(wait=True)
        self._stall = None      # the card waits for the next observation
        spans.publish(self.records)
        cands, fil_path = self._cands, self._fil_path
        if fil_path and self.write_cands and cands:
            with open(fil_path.replace(".fil", ".cand"), "w") as fp:
                for c in cands:
                    fp.write(c.to_line() + "\n")
        if fil_path and self.write_kurto and self._weights_accum:
            np.savez_compressed(fil_path.replace(".fil", "_kurto.npz"),
                                weights=np.concatenate(
                                    [w.numpy() for w in self._weights_accum],
                                    axis=-1))
        self._weights_accum = []
        if fil_path and self._histo_accum is not None:
            # the DOHISTO product (ref pb_kernels.cu:321-336), summed in
            # int64 so that a long observation does not wrap a bin
            np.savez_compressed(fil_path.replace(".fil", "_histo.npz"),
                                histogram=self._histo_accum.cpu().numpy())
        return ObservationProducts(
            fil_path=fil_path, candidates=cands, seconds=self._nsec,
            rt_factor=self._rt.realtime_factor,
            dropped=self.ring.dropped if self.ring else 0,
            start_unix=self._t0_unix or 0.0)

    def _drain(self, packed_dev: torch.Tensor,
               packed_host: Optional[torch.Tensor],
               plain_host: Optional[torch.Tensor],
               done: Optional[torch.cuda.Event],
               second: spans.Record) -> None:
        """The previous second's products (`second` its record): its
        device rows join the search's stream; its host bytes (copied at
        its dispatch) go to the .fil files and the block taps once its
        copy has completed."""
        rec = self._rec
        if self._search_live:
            # kept on the device only while a search will consume it
            self._fb_dev.append(packed_dev)
            rows = int(packed_dev.shape[0])
            self._rows.append((self._rows_in, self._rows_in + rows, second))
            self._rows_in += rows
        if packed_host is not None:
            with torch.profiler.record_function("vfast.drain"):
                with rec.span("wait"):
                    if done is not None:
                        done.synchronize()
                with rec.span("drain"):
                    packed = packed_host.numpy()
                    if self._fil is not None:
                        self._fil.write_block(packed)
                    if plain_host is not None \
                            and self._fil_plain is not None:
                        self._fil_plain.write_block(plain_host.numpy())
                    if self._search_live:
                        self._fb.append(packed)
                    for tap in self.block_taps:
                        tap(self.station_id, self._taps_offset, packed)
        if self.device_taps:
            with rec.span("drain"):
                for tap in self.device_taps:
                    tap(self.station_id, self._taps_offset, packed_dev)
        self._taps_offset += int(packed_dev.shape[0])
        if self._search_live:
            with rec.span("search"):
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
            rec = spans.Record("gulp", self._ngulps,
                               self.device.type == "cuda")
            self._ngulps += 1
            self._read_times()
            rec.counters["ahead_s"] = sum(
                r.layer == "second" for r in self._unread) + (
                self._rec.layer == "second")
            with torch.profiler.record_function("vfast.gulp_search"), \
                    spans.bound(rec):
                found = self._search_window(stop)
            self._gulp_done(rec, stop)
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
            while self._rows and self._rows[0][1] <= self._searched_to:
                self._rows.popleft()
            if flush and total - self._searched_to <= overlap + 64:
                break
        return out

    def _gulp_done(self, rec: spans.Record, stop: int) -> None:
        """The gulp [searched_to, stop) has its candidates: its latency
        from the start of the call that fed its last row, whether it
        holds an armed second, the call it was searched in (none for a
        gulp of end_observation), and the stall it leaves the card in
        (_stall_to)."""
        t = time.perf_counter()
        held = [sec for lo, hi, sec in self._rows
                if lo < stop and hi > self._searched_to]
        dispatch = rec.first("dispatch")
        rec.add("gulp", held[-1].start, t, parent=None)
        rec.add("lag", held[-1].start, dispatch.start)
        rec.counters["injected"] = int(any(sec.counters["armed"]
                                           for sec in held))
        if self._rec.layer == "second":
            rec.counters["searched_in"] = self._rec.id
        self._stall_to(dispatch.start, dispatch=True)
        self._stall = (rec, rec.first("wait").end)
        self.records.gulps.append(rec)
        self._unread.append(rec)

    def _search_window(self, stop: int) -> List[dd.Candidate]:
        """One gulp [searched_to, stop), at its own length, from the
        device stream, else from host bytes."""
        dev_win = self._fb_dev.window(self._searched_to, stop)
        if dev_win is not None:
            return self.search.search_gulp_device(
                dev_win, self.cfg.nbit, t_offset=self._searched_to)
        packed = (self._fb.window(self._searched_to, stop)
                  if self._fb.total >= stop
                  else self._fb_dev.host_window(self._searched_to, stop))
        return self.search.search_gulp_packed(
            packed, self.cfg.nbit, t_offset=self._searched_to)

    def on_ring(self, fn: Callable, *args) -> Future:
        """fn(*args) on the ring's thread, once the writes of the seconds
        fed so far are done; its Future.  A ring more than its depth of
        writes behind makes the caller wait for the oldest."""
        while self._ring_jobs and (self._ring_jobs[0].done()
                                   or len(self._ring_jobs) >= self.ring.nbufs):
            self._ring_jobs.popleft().result()     # raises a job's error
        job = self._ring_thread.submit(fn, *args)
        self._ring_jobs.append(job)
        return job

    def sync_ring(self) -> None:
        """Wait for every job queued on the ring's thread."""
        while self._ring_jobs:
            self._ring_jobs.popleft().result()

    def _ring_write(self, data: np.ndarray, sec: float, flags: int,
                    rec: spans.Record) -> None:
        """The ring's thread: one second into the ring, its span "ring"
        (outside its feed_second call's) in the second's record."""
        t = time.perf_counter()
        self.ring.write(data, timestamp=sec, flags=flags, overwrite=True)
        t1 = time.perf_counter()
        rec.add("ring", t, t1, parent=None)
        self.host_seconds["ring"].append(t1 - t)

    def close(self) -> None:
        """Wait for the ring's thread; unlink the ring's shared memory."""
        if self.ring is not None:
            try:
                self.sync_ring()
            finally:
                self._ring_thread.shutdown()
                self.ring.close(unlink=True)


class _InPlace(np.ndarray):
    """A ring slot's bytes in place (RingBuffer.slot_view).  tobytes gives
    them as a memoryview, which a file's write takes as it is: the
    dumper writes a slot with no copy of it.  A copy of a second of
    production baseband (256 MB into fresh pages) holds the interpreter's
    lock for up to ~0.9 s on an H100's host, and so stalls the station
    loop."""

    def tobytes(self, order="C"):
        return memoryview(self)


class _DumpReader:
    """A station's ring as its TriggeredDumper reads it on the ring's
    thread (StationPipeline.on_ring), where no write runs meanwhile: the
    resident slots and their timestamps as the ring gives them, each
    slot's bytes in place."""

    def __init__(self, ring: RingBuffer):
        self._ring = ring

    def resident(self):
        return self._ring.resident()

    def slot_timestamp(self, seq: int) -> float:
        return self._ring.slot_timestamp(seq)

    def peek(self, seq: int):
        got = self._ring.slot_view(seq)
        return None if got is None else (got[0].view(_InPlace), got[1])


COADD_BEAM = -1   # pseudo-beam id of the coadded stream


class CoaddSearcher:
    """Search the coadded filterbank stream in the host runtime.

    The reference's sqrt(N) sensitivity path (agdadacoadd reduces every
    antenna's coadd ring and agtriggerhook searches the sum): the
    stations' taps feed packed blocks, as the program's rows on the
    device (StationPipeline.device_taps) or as host bytes; once every
    station has delivered a sample range, the dequantized sum, scaled by
    1/sqrt(N) and stored as float16, is made on `device` and enters a
    gulp search identical to the per-beam one, through the dedispersion
    kernel's f32 entry.  Candidates carry beam COADD_BEAM.  The sum adds
    the antennas in turn in float32, as the JAX package's numpy sums a
    stack over its first axis, so the float16 stream is bit-equal to its
    own.

    Each sample range summed is a record of utils/spans (layer "coadd",
    id the range's index since the last reset, in `records`): its spans
    "sum" (the dequantize, sum, scale and cast, dispatched) and "search"
    (the gulp searches the range completed)."""

    def __init__(self, station_ids: List[int], cfg: PipelineConfig,
                 scfg: SearchConfig, nsub: int = 0, nbatch: int = 0,
                 device="cuda"):
        self.cfg, self.scfg = cfg, scfg
        self._all_station_ids = list(station_ids)
        self.station_ids = list(station_ids)
        self.search = search_mod.SinglePulseSearch(
            scfg, cfg.tsamp, cfg.freqs_mhz(),
            nsub=nsub or min(128, cfg.nchanout),
            nbatch=nbatch or min(scfg.ndm, 128), device=device)
        self.device = self.search.device
        self.log = make_logger("coadd")
        self._prewarmed = False
        self.reset()

    def reset(self) -> None:
        self.station_ids = list(self._all_station_ids)  # un-retire
        self._pending: Dict[int, list] = {sid: [] for sid in self.station_ids}
        self._next_offset = {sid: 0 for sid in self.station_ids}
        self._co, self._searched_to = GulpStream(), 0
        self.cands: List[dd.Candidate] = []
        self.gulps = 0          # gulps searched since the last reset
        self.ranges = 0         # sample ranges summed since the last reset
        self.records = collections.deque(maxlen=spans.SECOND_RECORDS)

    def prewarm(self) -> None:
        """Once, before the first block: one near-zero float16 gulp through
        the search on the card (the dedispersion kernel's f32 entry), its
        crossings discarded, so that the first gulp is not a cold one."""
        if self.device.type != "cuda" or self._prewarmed:
            return
        full = self.scfg.gulp_samps + self.search.overlap
        self.search._top_crossings(torch.full(
            (full, self.cfg.nchanout), 1e-3, dtype=torch.float16,
            device=self.device))
        torch.cuda.synchronize(self.device)
        self._prewarmed = True

    def tap(self, station_id: int, offset: int, packed) -> None:
        """StationPipeline tap: collect a packed block (a tensor, or host
        bytes), and coadd whatever sample range every station has now
        delivered.  Blocks of retired stations are dropped.

        Lockstep is checked: each station's `offset` must continue where
        its last block ended.  A gap is zero-filled in filterbank space,
        so every later coadd still sums aligned time ranges; a rewind or a
        duplicate keeps the first-arrival samples only."""
        if station_id not in self._pending:
            return
        exp = self._next_offset[station_id]
        end = offset + packed.shape[0]
        if offset > exp:
            self.log.warning(
                "coadd: station %d jumped %d->%d; zero-filling %d samples "
                "to keep the coadd time-aligned", station_id, exp, offset,
                offset - exp)
            self._pending[station_id].append(("pad", offset - exp))
        elif offset < exp:
            overlap = exp - offset
            if overlap >= packed.shape[0]:
                self.log.warning(
                    "coadd: station %d re-delivered [%d,%d) already "
                    "consumed; dropped", station_id, offset,
                    offset + packed.shape[0])
                return
            self.log.warning(
                "coadd: station %d overlapped %d samples; keeping the "
                "first-arrival range", station_id, overlap)
            packed = packed[overlap:]
        self._pending[station_id].append(packed)
        self._next_offset[station_id] = end
        self._advance()

    def retire(self, station_id: int) -> None:
        """A station's stream ended: drop it from the lockstep set, so the
        coadd keeps covering new data with the stations that remain (the
        per-gulp noise estimate absorbs the sqrt(N) scale change)."""
        if station_id in self.station_ids:
            self.station_ids.remove(station_id)
            self._pending.pop(station_id, None)
            self.log.info("coadd: station %d retired (%d remain)",
                          station_id, len(self.station_ids))
            if self.station_ids:
                self._advance()

    @staticmethod
    def _blk_len(b) -> int:
        return b[1] if isinstance(b, tuple) else b.shape[0]

    @staticmethod
    def _blk_split(b, n: int):
        """(first n samples, remainder or None) of a packed/pad entry."""
        if isinstance(b, tuple):
            rest = b[1] - n
            return ("pad", n), (("pad", rest) if rest > 0 else None)
        return b[:n], (b[n:] if b.shape[0] > n else None)

    def _blk_fb(self, b) -> torch.Tensor:
        """Dequantize a packed entry on the device; a pad is zero
        filterbank (zero adds nothing to the sum)."""
        if isinstance(b, tuple):
            return torch.zeros((b[1], self.cfg.nchanout), dtype=torch.float32,
                               device=self.device)
        return q_ops.dequantize(torch.as_tensor(b, device=self.device),
                                self.cfg.nbit)[:, :self.cfg.nchanout]

    def _advance(self) -> None:
        while self.station_ids and all(
                self._pending[sid] for sid in self.station_ids):
            blocks = [self._pending[sid].pop(0) for sid in self.station_ids]
            n = min(self._blk_len(b) for b in blocks)
            if any(self._blk_len(b) != n for b in blocks):
                # ragged blocks: consume the common prefix and requeue the
                # remainders, so the streams stay sample-aligned
                self.log.warning("ragged coadd blocks: %s",
                                 [self._blk_len(b) for b in blocks])
                head = []
                for sid, b in zip(self.station_ids, blocks):
                    first, rest = self._blk_split(b, n)
                    if rest is not None:
                        self._pending[sid].insert(0, rest)
                    head.append(first)
                blocks = head
            rec = spans.Record("coadd", self.ranges)
            self.ranges += 1
            with rec.span("sum"):
                co = self._blk_fb(blocks[0])
                for b in blocks[1:]:
                    co += self._blk_fb(b)
                co *= float(np.float32(1.0 / np.sqrt(len(blocks))))
                # float16 halves the window's bytes; values are O(10)
                # sums of levels
                self._co.append(co.to(torch.float16))
            with rec.span("search"):
                self.cands.extend(self._search_ready())
            self.records.append(rec)

    def _search_ready(self, flush: bool = False) -> List[dd.Candidate]:
        gulp = self.scfg.gulp_samps
        overlap = self.search.overlap
        total = self._co.total
        out: List[dd.Candidate] = []
        while total - self._searched_to >= gulp + overlap or (
                flush and total - self._searched_to > overlap + 64):
            stop = min(self._searched_to + gulp + overlap, total)
            block = self._co.window(self._searched_to, stop)
            out.extend(self.search.search_gulp(
                block, t_offset=self._searched_to))
            self.gulps += 1
            self._searched_to += min(gulp, block.shape[0] - overlap)
            self._co.prune(self._searched_to)
            if flush and total - self._searched_to <= overlap + 64:
                break
        return out

    def finish(self) -> List[dd.Candidate]:
        self.cands.extend(self._search_ready(flush=True))
        return self.cands


class ArrayPipeline:
    """N stations on one device, the coadd search, the coincidencer and the
    triggered dumps (the cluster roles of messenger, trigger.py and the
    dumper on one host).  Every station's work goes to the device's one
    stream; the coadd sums the stations' rows where they are, on the
    device (their device taps), so that a station copies its rows to the
    host only for a .fil."""

    def __init__(self, acfg: ArrayConfig, out_dir: Optional[str] = None,
                 keep_rings: bool = True, search_coadd: bool = True,
                 device="cuda", ring_seconds: int = 40):
        self.acfg = acfg
        self.out_dir = out_dir or os.path.join(tempfile.gettempdir(),
                                               "vfast")
        self.stations = [
            StationPipeline(a.station_id, acfg.pipeline, acfg.search,
                            out_dir=self.out_dir, ring_seconds=ring_seconds,
                            keep_ring=keep_rings, device=device)
            for a in acfg.antennas]
        self.tcfg = acfg.trigger
        self.log = make_logger("array")
        self._dump_lock = threading.Lock()
        self.coadd: Optional[CoaddSearcher] = None
        if search_coadd and len(self.stations) >= 2:
            self.coadd = CoaddSearcher(
                [st.station_id for st in self.stations], acfg.pipeline,
                acfg.search, device=device)
            for st in self.stations:
                st.device_taps.append(self.coadd.tap)

    def prewarm(self) -> None:
        """Each station's programs and the coadd's search, once (the
        observation's start does it too; a caller may do it before)."""
        for st in self.stations:
            st.prewarm()
        if self.coadd is not None:
            self.coadd.prewarm()

    def run_streaming(self, per_ant_seconds: Dict[int, Iterable],
                      od: ObservationDocument,
                      coincide_every_s: int = 8,
                      write_fil: bool = True) -> dict:
        """Interleaved serving: every data-second is dispatched for all
        stations before any of them drains (the device's queue overlaps
        the antennas), and coincidence and triggering run every
        `coincide_every_s` seconds instead of at the observation's end.
        Each second is taken from its station's iterable when the loop
        comes to it, as it arrives.  A trigger's dumps run on the
        stations' ring threads (StationPipeline.on_ring), behind the ring
        writes of the seconds fed before it and ahead of the later ones,
        and write each slot from the ring in place (_DumpReader), one
        station at a time, so that the loop goes on meanwhile.  The
        result's "trigger_seconds" holds, for each trigger, the data
        seconds fed when it was raised; its "dumps" every dump, once
        done."""
        iters = {st.station_id: iter(per_ant_seconds[st.station_id])
                 for st in self.stations}
        if self.coadd is not None:
            self.coadd.reset()
            self.coadd.prewarm()
        for st in self.stations:
            st.begin_observation(od, write_fil=write_fil)
        dumpers = {st.station_id: TriggeredDumper(
            _DumpReader(st.ring), os.path.join(self.out_dir, "dumps"),
            station_id=st.station_id, max_dump_s=self.tcfg.max_dump_s)
            for st in self.stations if st.ring is not None}
        triggers: List[trig.Trigger] = []
        dumps, at = [], []
        sent = set()
        nsec = 0
        live = dict(iters)
        while live:
            for st in self.stations:
                if st.station_id not in live:
                    continue
                try:
                    sec, buf = next(live[st.station_id])
                except StopIteration:
                    del live[st.station_id]
                    if self.coadd is not None:
                        self.coadd.retire(st.station_id)
                    continue
                st.feed_second(sec, buf)
            nsec += 1
            if nsec % coincide_every_s == 0:
                self._coincide_and_dump(od, triggers, dumps, dumpers, sent)
                at += [nsec] * (len(triggers) - len(at))
        products = {st.station_id: st.end_observation()
                    for st in self.stations}
        if self.coadd is not None:
            self.coadd.finish()
        self._coincide_and_dump(od, triggers, dumps, dumpers, sent)
        at += [nsec] * (len(triggers) - len(at))
        return {"products": products, "triggers": triggers,
                "dumps": [r for r in (d.result() for d in dumps) if r],
                "coadd_candidates": list(self.coadd.cands)
                if self.coadd else [], "trigger_seconds": at}

    def _coincide_and_dump(self, od, triggers, dumps, dumpers, sent):
        """The coincidence of every beam's candidates so far; each new
        trigger's dumps queued on the rings' threads (`dumps`: their
        Futures)."""
        utc0 = min((st._t0_unix or od.start_time for st in self.stations),
                   default=od.start_time)
        per_beam = {st.station_id: list(st._cands) for st in self.stations}
        if self.coadd is not None:
            per_beam[COADD_BEAM] = list(self.coadd.cands)
        coincided = trig.coincidence(per_beam, self.acfg.pipeline.tsamp,
                                     delta_dm=self.tcfg.delta_dm,
                                     delta_w=self.tcfg.delta_w)
        for t in trig.make_triggers(coincided, utc0, self.tcfg,
                                    coadd_beam=COADD_BEAM):
            key = (round(t.t0, 3), round(t.dm, 2))
            if key in sent:
                continue
            sent.add(key)
            triggers.append(t)
            for st in self.stations:
                if st.station_id in dumpers:
                    dumps.append(st.on_ring(self._dump,
                                            dumpers[st.station_id], t))

    def _dump(self, dumper: TriggeredDumper, t: trig.Trigger):
        """One station's dump of trigger t, on its ring's thread.  One
        station dumps at a time: the dumps' file writes then take one of
        the host's cores, not one a station, beside the loop."""
        with self._dump_lock:
            return dumper.dump(t)

    def run_observation(self, per_ant_seconds: Dict[int, Iterable],
                        od: ObservationDocument) -> dict:
        """The stations one after another, then coincidence, triggers and
        dumps over the whole observation."""
        if self.coadd is not None:
            self.coadd.reset()
            self.coadd.prewarm()
        products = {}
        for st in self.stations:
            products[st.station_id] = st.run_observation(
                per_ant_seconds[st.station_id], od)
        per_beam = {sid: p.candidates for sid, p in products.items()}
        if self.coadd is not None:
            per_beam[COADD_BEAM] = self.coadd.finish()
        coincided = trig.coincidence(per_beam, self.acfg.pipeline.tsamp,
                                     delta_dm=self.tcfg.delta_dm,
                                     delta_w=self.tcfg.delta_w)
        # dump windows are referenced to the observation's start time
        triggers = trig.make_triggers(coincided, od.start_time, self.tcfg,
                                      coadd_beam=COADD_BEAM)
        dumps = []
        for st in self.stations:
            if st.ring is None:
                continue
            dmp = TriggeredDumper(st.ring, os.path.join(self.out_dir,
                                                        "dumps"),
                                  station_id=st.station_id,
                                  max_dump_s=self.tcfg.max_dump_s)
            for t in triggers:
                rec = dmp.dump(t)
                if rec:
                    dumps.append(rec)
        return {"products": products, "triggers": triggers, "dumps": dumps,
                "coadd_candidates": list(self.coadd.cands)
                if self.coadd else []}

    def close(self) -> None:
        for st in self.stations:
            st.close()
