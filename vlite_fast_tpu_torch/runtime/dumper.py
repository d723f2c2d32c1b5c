"""Triggered voltage dumps from the baseband ring.

The dumper role (ref src/dumper.c:157-376): receive Trigger windows, map
[t0, t1] unix-time windows to resident ring slots via their timestamps
(trigs_to_utcs semantics), deduplicate against recently-dumped seconds
(180-entry history, ref src/dumper.c:57,211-227), and write the raw VDIF
seconds to per-event files for offline beamforming/localization.

The port's copy of vlite_fast_tpu/runtime/dumper.py, on the port's ring.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import List, Optional

from vlite_fast_tpu_torch import constants as C
from vlite_fast_tpu_torch.runtime.ring import RingBuffer
from vlite_fast_tpu_torch.runtime.trigger import Trigger


@dataclass
class DumpRecord:
    path: str
    t0: float
    t1: float
    seconds: List[int]
    nbytes: int


class TriggeredDumper:
    """Attach to a baseband ring as a viewer and serve dump requests."""

    def __init__(self, ring: RingBuffer, out_dir: str,
                 station_id: int = 0, max_dump_s: float = C.MAX_DUMP_S,
                 dedup_history: int = 180):
        self.ring = ring
        self.out_dir = out_dir
        self.station_id = station_id
        self.max_dump_s = max_dump_s
        self.dedup_history = dedup_history
        self._dumped: List[float] = []     # recently dumped slot timestamps
        os.makedirs(out_dir, exist_ok=True)

    def _already_dumped(self, ts: float) -> bool:
        return any(abs(ts - d) < 0.5 for d in self._dumped)

    def _record(self, ts: float) -> None:
        self._dumped.append(ts)
        if len(self._dumped) > self.dedup_history:
            self._dumped = self._dumped[-self.dedup_history:]

    def window_to_slots(self, t0: float, t1: float) -> List[int]:
        """Resident slot seqs whose [ts, ts+1) second overlaps [t0, t1]
        (ref trigs_to_utcs walking every sub-buffer, src/dumper.c:157-232)."""
        lo, hi = self.ring.resident()
        out = []
        for seq in range(lo, hi):
            ts = self.ring.slot_timestamp(seq)
            if ts < 0:
                continue
            if ts + 1.0 > t0 and ts <= t1:
                out.append(seq)
        return out

    def dump(self, trig: Trigger) -> Optional[DumpRecord]:
        t0, t1 = trig.t0, trig.t1
        if t1 - t0 > self.max_dump_s:
            t1 = t0 + self.max_dump_s
        slots = self.window_to_slots(t0, t1)
        slots = [s for s in slots
                 if not self._already_dumped(self.ring.slot_timestamp(s))]
        if not slots:
            return None
        first_ts = self.ring.slot_timestamp(slots[0])
        stamp = time.strftime("%Y%m%d_%H%M%S", time.gmtime(first_ts))
        path = os.path.join(
            self.out_dir,
            f"{stamp}_ea{self.station_id:02d}_{first_ts:.0f}.vdif")
        nbytes = 0
        secs = []
        with open(path, "wb") as fp:
            for seq in slots:
                got = self.ring.peek(seq)
                if got is None:
                    continue   # slot recycled under us; skip (viewer racy
                               # by design, see csrc/ringbuffer.cpp)
                data, ts = got
                fp.write(data.tobytes())
                nbytes += data.nbytes
                self._record(ts)
                secs.append(int(ts))
            fp.flush()
            os.fsync(fp.fileno())
        if nbytes == 0:
            os.unlink(path)
            return None
        return DumpRecord(path=path, t0=t0, t1=t1, seconds=secs,
                          nbytes=nbytes)
