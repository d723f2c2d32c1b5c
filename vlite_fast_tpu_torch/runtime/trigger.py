"""Cross-beam coincidencing and triggering (the L5b trigger plane).

Re-design of the reference's coincidencer service (src/trigger.py:37-176)
and candidate matching (src/candidate.py:49-114): heimdall's TCP candidate
batches become in-process lists of Candidate records from models/search.py;
the UDP-multicast trigger_t struct (src/utils.h:47-57) becomes a typed
Trigger record with the same binary wire format available for
interoperability.

The port's copy of vlite_fast_tpu/runtime/trigger.py (numpy and the
standard library), on the port's config, constants and Candidate.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from vlite_fast_tpu_torch import constants as C
from vlite_fast_tpu_torch.config import TriggerConfig
from vlite_fast_tpu_torch.ops.dedisperse import Candidate


@dataclass
class BeamCandidate:
    """A search candidate tagged with its beam (antenna stream)."""

    cand: Candidate
    beam: int
    tsamp: float = 1.0 / 1280
    beam_mask: np.ndarray = field(default=None)

    @property
    def width_s(self) -> float:
        return (self.cand.i1 - self.cand.i0) * self.tsamp

    def overlaps(self, other: "BeamCandidate", delta_dm: float = 0.1,
                 delta_w: float = 3.0) -> bool:
        """DM within delta_dm fractionally, width ratio < delta_w, and time
        intervals overlap (ref src/candidate.py:49-64)."""
        a, b = self.cand, other.cand
        if b.dm == 0 or abs(a.dm / b.dm - 1) > delta_dm:
            return False
        w1, w2 = max(self.width_s, 1e-9), max(other.width_s, 1e-9)
        if (w2 / w1 if w1 < w2 else w1 / w2) > delta_w:
            return False
        if a.i0 < b.i0:
            return b.i0 < a.i1
        return a.i0 < b.i1


def coincidence(per_beam: Dict[int, Sequence[Candidate]], tsamp: float,
                delta_dm: float = 0.1, delta_w: float = 3.0,
                tslice_s: float = 1.0) -> List[BeamCandidate]:
    """Cross-beam correlation in time slices (ref src/candidate.py:69-114).

    per_beam: {beam_index: [Candidate, ...]}.  Returns all candidates with
    beam_mask[b] = number of overlapping candidates seen in beam b.
    """
    beams = sorted(per_beam.keys())
    nbeam = len(beams)
    beam_of = {b: i for i, b in enumerate(beams)}
    allc: List[BeamCandidate] = []
    for b in beams:
        for c in per_beam[b]:
            allc.append(BeamCandidate(c, b, tsamp,
                                      np.zeros(nbeam, np.int16)))
    if not allc:
        return []
    allc.sort(key=lambda x: x.cand.i1)
    end_times = np.array([x.cand.i1 * tsamp for x in allc])
    nslice = int(end_times[-1] / tslice_s) + 1
    idx0 = 0
    prev: List[BeamCandidate] = []
    for i in range(nslice):
        idx1 = int(np.searchsorted(end_times, tslice_s * (i + 1)))
        these = allc[idx0:idx1]
        for cand in these:
            for other in these:
                if cand.overlaps(other, delta_dm, delta_w):
                    cand.beam_mask[beam_of[other.beam]] += 1
            for other in prev:
                if cand.overlaps(other, delta_dm, delta_w):
                    # symmetric: the earlier-slice candidate must also
                    # learn about this one, or a pair straddling a slice
                    # boundary can fail min_beams on one side
                    cand.beam_mask[beam_of[other.beam]] += 1
                    other.beam_mask[beam_of[cand.beam]] += 1
        prev = these
        idx0 = idx1
    return allc


@dataclass
class Trigger:
    """Dump-window request (ref trigger_t, src/utils.h:47-57).

    Wire format note: `_FMT` is byte-identical to the reference's C
    trigger_t struct {double t0; double t1; float sn,dm,width,peak_time;
    char meta[128];} — the layout the reference's dumper demands
    (`nbytes != sizeof(trigger_t)` is rejected, src/dumper.c:514-526).
    The reference's *Python* coincidencer packs only `'dd128s'`
    (src/trigger.py:174), a 144-byte datagram the C dumper would drop;
    we treat the C struct as canonical and accept the short Python
    layout on unpack for one-way interop (sn/dm/width/peak_time
    default to 0 since that layout does not carry them).
    """

    t0: float            # window start [unix seconds]
    t1: float            # window end   [unix seconds]
    sn: float
    dm: float
    width: float
    peak_time: float
    meta: str = ""

    _FMT = "<ddffff128s"      # canonical: the C trigger_t layout
    _FMT_LEGACY = "<dd128s"   # the reference coincidencer's short pack

    def pack(self) -> bytes:
        return struct.pack(self._FMT, self.t0, self.t1, self.sn, self.dm,
                           self.width, self.peak_time,
                           self.meta.encode()[:128])

    def pack_legacy(self) -> bytes:
        """The reference Python coincidencer's 'dd128s' layout
        (src/trigger.py:174), for driving legacy consumers."""
        return struct.pack(self._FMT_LEGACY, self.t0, self.t1,
                           self.meta.encode()[:128])

    @classmethod
    def unpack(cls, buf: bytes) -> "Trigger":
        # slice exactly calcsize bytes so senders whose trigger_t carries
        # trailing padding still parse (a longer datagram must not raise)
        n = struct.calcsize(cls._FMT)
        nl = struct.calcsize(cls._FMT_LEGACY)
        if len(buf) < n:
            # only an EXACT-size short datagram is the reference
            # coincidencer's 'dd128s' layout; anything in (nl, n) is a
            # truncated canonical datagram and must raise, not misparse
            if len(buf) != nl:
                raise struct.error(
                    f"trigger datagram of {len(buf)} bytes is neither "
                    f"trigger_t ({n}) nor the legacy layout ({nl})")
            t0, t1, meta = struct.unpack(cls._FMT_LEGACY, buf)
            return cls(t0, t1, 0.0, 0.0, 0.0, 0.0,
                       meta.split(b"\0", 1)[0].decode(errors="replace"))
        t0, t1, sn, dm, w, pt, meta = struct.unpack(cls._FMT, buf[:n])
        return cls(t0, t1, sn, dm, w, pt,
                   meta.split(b"\0", 1)[0].decode(errors="replace"))


class TriggerSender:
    """Fan Trigger structs out to dumper endpoints over UDP (the
    trigger_t multicast of the reference, src/trigger.py:75-84, as a
    unicast list since TPU hosts lack multicast)."""

    def __init__(self, endpoints: Sequence[tuple]):
        import socket as _socket
        self.endpoints = list(endpoints)
        self._sock = _socket.socket(_socket.AF_INET, _socket.SOCK_DGRAM)

    def send(self, trigger: "Trigger") -> None:
        buf = trigger.pack()
        for ep in self.endpoints:
            try:
                self._sock.sendto(buf, ep)
            except OSError:
                pass

    def close(self):
        self._sock.close()


class TriggerReceiver:
    """Dumper-side UDP listener for Trigger structs
    (ref src/dumper.c:487-532 select + MultiCastReceive loop)."""

    def __init__(self, port: int = 20003, host: str = "0.0.0.0"):
        import socket as _socket
        from vlite_fast_tpu_torch.utils.log import make_logger
        self._sock = _socket.socket(_socket.AF_INET, _socket.SOCK_DGRAM)
        self._sock.bind((host, port))
        self._sock.settimeout(0.2)
        self._log = make_logger("trigrecv")
        self.parse_errors = 0

    def poll(self, max_triggers: int = 20) -> List["Trigger"]:
        import socket as _socket
        out = []
        for _ in range(max_triggers):
            try:
                buf, _ = self._sock.recvfrom(512)
            except _socket.timeout:
                break
            except OSError:
                break
            try:
                out.append(Trigger.unpack(buf))
            except Exception as exc:
                # a malformed trigger must be visible, not silently lost
                self.parse_errors += 1
                self._log.warning("dropped unparseable trigger datagram "
                                  "(%d bytes): %s", len(buf), exc)
                continue
        return out

    def close(self):
        self._sock.close()


def make_triggers(coincided: List[BeamCandidate], utc_start: float,
                  cfg: TriggerConfig = TriggerConfig(),
                  coadd_beam: Optional[int] = None) -> List[Trigger]:
    """Apply the trigger cuts and map candidates to dump windows.

    Cuts (ref src/trigger.py:45-65,148): S/N > snr_thresh, >= min_beams
    coincident beams, width < max_width_s, DM > min_dm.  Window mapping
    (ref src/trigger.py:155-173): [i0*tsamp - pre, i0 + width + DM sweep
    + post] relative to utc_start.

    Candidates from `coadd_beam` (the coadded-stream search, the
    agtriggerhook role ref scripts/start_process:21) already carry the
    whole array's sensitivity: they skip the min_beams cut and use
    cfg.coadd_snr_thresh instead.
    """
    out: List[Trigger] = []
    for bc in coincided:
        c = bc.cand
        is_coadd = coadd_beam is not None and bc.beam == coadd_beam
        nbeam = int((bc.beam_mask > 0).sum())
        if not is_coadd and nbeam < cfg.min_beams:
            continue
        if bc.width_s >= cfg.max_width_s:
            continue
        if c.dm <= cfg.min_dm:
            continue
        if c.snr <= (cfg.coadd_snr_thresh if is_coadd else cfg.snr_thresh):
            continue
        dm_delay = c.dm * C.DM_DELAY_PER_DM
        dump_offs = c.i0 * bc.tsamp
        dump_len = (c.i1 - c.i0) * bc.tsamp + dm_delay
        t0 = utc_start + dump_offs - cfg.buffer_pre_s
        t1 = t0 + dump_len + cfg.buffer_pre_s + cfg.buffer_post_s
        if t1 - t0 > cfg.max_dump_s:
            t1 = t0 + cfg.max_dump_s
        out.append(Trigger(t0=t0, t1=t1, sn=c.snr, dm=c.dm,
                           width=bc.width_s, peak_time=c.peak_time,
                           meta=f"beam{bc.beam} nbeam{nbeam}"))
    # dedup: merge overlapping windows (multiple coincident candidates)
    out.sort(key=lambda t: t.t0)
    merged: List[Trigger] = []
    for t in out:
        if merged and t.t0 < merged[-1].t1 and \
                (max(t.t1, merged[-1].t1) - merged[-1].t0) <= cfg.max_dump_s:
            last = merged[-1]
            last.t1 = max(last.t1, t.t1)
            if t.sn > last.sn:
                last.sn, last.dm, last.width = t.sn, t.dm, t.width
        else:
            merged.append(Trigger(**t.__dict__))
    return merged
