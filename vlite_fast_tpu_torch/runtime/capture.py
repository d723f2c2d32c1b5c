"""Capture stage: VDIF frame streams -> gap-filled, 1-s-aligned seconds.

The writer role (ref src/writer.c:344-800): consume VDIF frames (live UDP or
replayed from disk, the readbase role ref src/readbase.c:35-107), detect
drops via dual-pol frame arithmetic (ref src/writer.c:310-342), synthesize
zero-filled gaps (zero is the unpack flag value, ops/unpack.py), align
output to 1-second boundaries (thread 0, frame 0, ref src/writer.c:694),
and emit (npol, sample_rate) uint8 second-buffers into the baseband ring.

Fault semantics match writer.c's fail-fast philosophy (SURVEY.md section 5):
escalating counters for skipped frames (warn at 1000, abort the observation
at 50000, ref writer.c:35-37,663-672) and anomalous packets (100/500, ref
:32-34,626-645); packet-time vs wall-clock divergence > 1 s aborts (ref
:702-717); a full ring aborts (ref :719-727).  `CaptureStats.abort_reason`
is the hook the station daemon polls.

Two live transports behind one poll() surface (open_capture switch):
portable UDP sockets (one VDIF frame per datagram — test rigs, hosts off
the fiber) and AF_PACKET raw capture of UDP/IPv4-framed VDIF straight off
an interface (RawCapture — the reference's production transport, ref
src/utils.c:345-407 openRawSocket).  Either way the hot receive path
drains whole batches per syscall via the C++ recvmmsg helper
(csrc/netcap.cpp, the role of the reference's 20-packet recvfrom burst,
writer.c:611-614) and frame scatter into the second buffer is a single
vectorized assignment.

The port's copy of vlite_fast_tpu/runtime/capture.py, with one change:
the recvmmsg helper is the port's csrc/netcap.cpp, built by _build.py
with g++ on first use, and a helper that does not build or load raises.
The JAX package falls back to a per-datagram recvfrom loop there; the
port has no such mode.
"""

from __future__ import annotations

import ctypes
import socket
import time
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from vlite_fast_tpu_torch import _build
from vlite_fast_tpu_torch import constants as C
from vlite_fast_tpu_torch.utils import vdif
from vlite_fast_tpu_torch.utils.log import make_logger


@dataclass
class CaptureStats:
    """Escalating fault counters (ref src/writer.c:32-37,616-672)."""

    frames: int = 0            # good frames placed
    skipped: int = 0           # gap-filled (missing) frames
    anomalous: int = 0         # bad-size / out-of-order packets
    seconds: int = 0
    clock_skew_s: float = 0.0  # worst |packet time - wall clock| observed
    ring_full: bool = False    # for NON-overwrite ring writers (a stalled
                               # consumer, writer.c:719-727); the station
                               # daemon's history ring overwrites by
                               # design and never sets this
    skip_warn: int = 1000      # ref writer.c:35
    skip_abort: int = 50000    # ref writer.c:36
    anomaly_warn: int = 100    # ref writer.c:32
    anomaly_abort: int = 500   # ref writer.c:33
    max_clock_skew_s: float = 1.0  # ref writer.c:702-717

    def healthy(self) -> bool:
        return self.abort_reason() is None

    def abort_reason(self) -> Optional[str]:
        """Non-None ends the observation (the writer.c abort conditions)."""
        if self.skipped >= self.skip_abort:
            return f"skipped {self.skipped} frames (>= {self.skip_abort})"
        if self.anomalous >= self.anomaly_abort:
            return (f"{self.anomalous} anomalous packets "
                    f"(>= {self.anomaly_abort})")
        if self.clock_skew_s > self.max_clock_skew_s:
            return (f"packet time diverges from wall clock by "
                    f"{self.clock_skew_s:.2f} s")
        if self.ring_full:
            return "baseband ring full"
        return None

    def reset(self) -> None:
        self.frames = self.skipped = self.anomalous = self.seconds = 0
        self.clock_skew_s = 0.0
        self.ring_full = False


class SecondAssembler:
    """Assemble a dual-pol frame stream into whole seconds.

    Feed frames in arrival order; emits (second, samples[2, rate]) once a
    second completes (a frame of a later second arrives).  Missing frames
    stay zero (gap-fill, ref src/writer.c:674-687) and are COUNTED via
    frame-index arithmetic so the escalating skip thresholds can fire.
    """

    def __init__(self, sample_rate: int = C.VLITE_RATE,
                 wallclock_check: bool = False):
        self.sample_rate = sample_rate
        self.frames_per_sec = sample_rate // C.VDIF_DATA_BYTES
        self.stats = CaptureStats()
        self.wallclock_check = wallclock_check
        self.log = make_logger("capture")
        self._current_sec: Optional[int] = None
        self._buf = np.zeros((2, sample_rate), dtype=np.uint8)
        # per-slot first-arrival mask of the in-progress second: dedup is
        # "was this (pol, frame) slot already written", NOT "does the
        # index advance" — benign UDP reordering (multi-queue NICs, the
        # two pol threads swapping) must still land in its empty slot
        self._slot_filled = np.zeros(
            (2, -(-sample_rate // C.VDIF_DATA_BYTES)), dtype=bool)
        self._filled = 0
        self._started = False
        self._last_index: Optional[int] = None  # dual-pol frame counter
        self._warned_skip = False
        self._warned_anom = False
        self.ref_epoch = 0

    # -- fault accounting -------------------------------------------------
    def _frame_index(self, seconds, frames, threads):
        """Dual-pol frame counter at THIS assembler's rate (the
        vdif.frame_index convention, ref writer.c:310-321, generalized to
        shrunken test rates)."""
        thread = (np.asarray(threads) != 0).astype(np.int64)
        return (np.asarray(seconds, np.int64) * (2 * self.frames_per_sec)
                + np.asarray(frames, np.int64) * 2 + thread)

    def _account_gap(self, seconds: int, frame: int, thread: int) -> bool:
        """Dual-pol frame-index arithmetic (ref writer.c:310-342): any jump
        of more than 1 means frames were lost and will stay zero-filled
        unless a reordered arrival fills the hole later.  Returns True if
        the frame ADVANCES the stream's high-water index; False for
        frames at or behind it (duplicates OR benign reordering — the
        caller decides by slot occupancy, not by index order)."""
        idx = int(self._frame_index(seconds, frame, thread))
        if self._last_index is not None:
            diff = idx - self._last_index
            if diff <= 0:
                return False
            if diff > 1:
                self.stats.skipped += diff - 1
                self._maybe_warn()
        self._last_index = idx
        return True

    def _maybe_warn(self) -> None:
        s = self.stats
        if not self._warned_skip and s.skipped >= s.skip_warn:
            self._warned_skip = True
            self.log.warning("skipped %d frames (warn threshold %d)",
                             s.skipped, s.skip_warn)
        if not self._warned_anom and s.anomalous >= s.anomaly_warn:
            self._warned_anom = True
            self.log.warning("%d anomalous packets (warn threshold %d)",
                             s.anomalous, s.anomaly_warn)

    def _check_wallclock(self, seconds: int) -> None:
        """Packet-time vs system-clock divergence (ref writer.c:702-717)."""
        if not self.wallclock_check:
            return
        skew = abs(to_unix(seconds, self.ref_epoch) - time.time())
        if skew > self.stats.clock_skew_s:
            self.stats.clock_skew_s = skew

    # -- assembly ---------------------------------------------------------
    def _flush(self):
        out = (self._current_sec, self._buf)
        self._buf = np.zeros((2, self.sample_rate), dtype=np.uint8)
        self._slot_filled[:] = False
        self._filled = 0
        return out

    def feed(self, seconds: int, frame: int, thread: int,
             payload: np.ndarray):
        """Feed one frame; returns completed (second, samples) tuples."""
        done = []
        if not self._started:
            # wait for a 1 s boundary: thread 0 AND frame 0 (writer.c:694)
            if frame != 0 or thread != 0:
                return done
            self._started = True
            self._current_sec = seconds
            self._check_wallclock(seconds)
        advanced = self._account_gap(seconds, frame, thread)
        if not advanced and seconds != self._current_sec:
            # behind the stream AND not of the in-progress second: the
            # buffer it belonged to is gone — unusable duplicate/rewind
            self.stats.anomalous += 1
            self._maybe_warn()
            return done
        if seconds != self._current_sec:
            while self._current_sec < seconds:
                done.append(self._flush())
                self.stats.seconds += 1
                self._current_sec += 1
            self._check_wallclock(seconds)
        pol = 1 if thread != 0 else 0
        off = frame * C.VDIF_DATA_BYTES
        n = min(C.VDIF_DATA_BYTES, self.sample_rate - off)
        if n <= 0:
            self.stats.anomalous += 1
            self._maybe_warn()
            return done
        if self._slot_filled[pol, frame]:
            # true duplicate: first arrival wins (a corrupt duplicate
            # must not overwrite good samples)
            self.stats.anomalous += 1
            self._maybe_warn()
            return done
        self._buf[pol, off:off + n] = payload[:n]
        self._slot_filled[pol, frame] = True
        if not advanced:
            # a reordered arrival just filled a hole that the jump
            # accounting had already counted as skipped
            self.stats.skipped -= 1
        self._filled += 1
        self.stats.frames += 1
        return done

    def flush(self) -> list:
        """End-of-stream: emit the in-progress second (replay only; live
        capture flushes on the next second's first frame)."""
        if not self._started or self._filled == 0:
            return []
        out = [self._flush()]
        self.stats.seconds += 1
        self._current_sec += 1
        return out

    def feed_stream(self, raw: np.ndarray):
        """Feed a contiguous byte stream of frames; returns completed secs.

        Hot path: frames belonging to the current second are scattered in
        ONE vectorized assignment; only second-boundary frames fall back to
        the per-frame path.  This is what lets a Python host keep up with
        the 51,200 frames/s/antenna wire rate (see tests/test_capture_rate).
        """
        frame_bytes = C.VDIF_FRAME_BYTES
        raw = np.asarray(raw, dtype=np.uint8)
        nframes = raw.size // frame_bytes
        frames = raw[:nframes * frame_bytes].reshape(nframes, frame_bytes)
        fields = vdif.parse_headers(frames[:, :C.VDIF_HEADER_BYTES])
        if nframes:
            self.ref_epoch = int(fields["ref_epoch"][0])
        secs = fields["seconds"].astype(np.int64)
        frm = fields["frame"].astype(np.int64)
        thr = fields["thread_id"].astype(np.int64)
        done: list = []
        i = 0
        fps = self.frames_per_sec
        payload_view = frames[:, C.VDIF_HEADER_BYTES:]
        while i < nframes:
            if not self._started or secs[i] != self._current_sec or \
                    frm[i] * C.VDIF_DATA_BYTES + C.VDIF_DATA_BYTES \
                    > self.sample_rate:
                done.extend(self.feed(int(secs[i]), int(frm[i]),
                                      int(thr[i]), payload_view[i]))
                i += 1
                continue
            # vectorized run: all consecutive frames of the current second
            j = i
            cur = self._current_sec
            while j < nframes and secs[j] == cur and frm[j] < fps:
                j += 1
            # gap + dedup accounting over the run in one pass.  Gaps are
            # counted against the RUNNING MAX index (holes opened by
            # forward jumps); dedup is per (pol, frame) SLOT occupancy —
            # first arrival wins (a corrupt duplicate must not overwrite
            # good samples) but benign reordering still fills its hole,
            # and a refilled hole un-counts its skip
            idx = self._frame_index(secs[i:j], frm[i:j], thr[i:j])
            prev = self._last_index if self._last_index is not None \
                else idx[0] - 1
            run_max = np.maximum.accumulate(
                np.concatenate([[prev], idx]))[:-1]
            advancing = idx > run_max
            jumps = int((idx - run_max - 1)[advancing].sum())
            self.stats.skipped += jumps
            pol = (thr[i:j] != 0).astype(np.int64)
            slot = pol * self._slot_filled.shape[1] + frm[i:j]
            flat = self._slot_filled.reshape(-1)
            first_here = np.zeros(len(slot), dtype=bool)
            first_here[np.unique(slot, return_index=True)[1]] = True
            keep = first_here & ~flat[slot]
            bad = int((~keep).sum())
            self.stats.anomalous += bad
            self.stats.skipped -= int((keep & ~advancing).sum())
            if bad or jumps:
                self._maybe_warn()
            bufv = self._buf.reshape(2, fps, C.VDIF_DATA_BYTES)
            bufv[pol[keep], frm[i:j][keep]] = payload_view[i:j][keep]
            flat[slot[keep]] = True
            self._last_index = int(max(int(idx.max()), prev))
            nkept = int(keep.sum())
            self.stats.frames += nkept
            self._filled += nkept
            i = j
        return done


def to_unix(vdif_seconds: int, ref_epoch: int) -> float:
    """VDIF (ref_epoch, seconds) -> unix seconds (the vdif_to_unixepoch
    conversion every downstream timestamp uses, ref src/utils.c:498-521)."""
    return float(vdif._epoch_unix(ref_epoch)) + float(vdif_seconds)


def replay_file(path: str, chunk_frames: int = 4096,
                sample_rate: int = C.VLITE_RATE) -> Iterator[tuple]:
    """readbase equivalent: stream completed seconds from a recorded .vdif
    dump (ref src/readbase.c:35-107, scripts/readbase_test).
    Yields (unix_second, samples, ref_epoch)."""
    asm = SecondAssembler(sample_rate=sample_rate)
    with open(path, "rb") as fp:
        while True:
            raw = fp.read(chunk_frames * C.VDIF_FRAME_BYTES)
            if not raw:
                break
            for sec, buf in asm.feed_stream(np.frombuffer(raw, np.uint8)):
                yield to_unix(sec, asm.ref_epoch), buf, asm.ref_epoch
    for sec, buf in asm.flush():
        yield to_unix(sec, asm.ref_epoch), buf, asm.ref_epoch


_netcap = None


def netcap_lib() -> ctypes.CDLL:
    """ctypes handle to the batch receive/send helper (csrc/netcap.cpp),
    built on first use; raises if it does not build or load."""
    global _netcap
    if _netcap is not None:
        return _netcap
    lib = _build.load("netcap")
    lib.udp_blast.restype = ctypes.c_int64
    lib.udp_blast.argtypes = [ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_uint64, ctypes.c_uint64]
    lib.udp_drain.restype = ctypes.c_int64
    lib.udp_drain.argtypes = [ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_uint64, ctypes.c_uint64,
                              ctypes.c_int,
                              ctypes.POINTER(ctypes.c_uint64)]
    lib.raw_drain.restype = ctypes.c_int64
    lib.raw_drain.argtypes = [ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_uint64, ctypes.c_uint16,
                              ctypes.c_uint64, ctypes.c_int,
                              ctypes.POINTER(ctypes.c_uint64)]
    _netcap = lib
    return lib


class UDPCapture:
    """Live capture: one VDIF frame per UDP datagram -> SecondAssembler.

    Batches receives through recvmmsg (csrc/netcap.cpp) — one syscall per
    `batch` datagrams instead of one per frame.
    """

    def __init__(self, host: str = "0.0.0.0", port: int = 20000,
                 sample_rate: int = C.VLITE_RATE, batch: int = 256,
                 wallclock_check: bool = False):
        self._lib = netcap_lib()     # raises before a socket is opened
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        # SO_RCVBUF is silently capped by net.core.rmem_max (often a few
        # MB ~ tens of ms at the 256 MB/s wire rate); with CAP_NET_ADMIN,
        # SO_RCVBUFFORCE (33) bypasses the cap so scheduling hiccups don't
        # drop frames (the reference relies on PF_PACKET ring depth here)
        want = 64 * 1024 * 1024
        try:
            self.sock.setsockopt(socket.SOL_SOCKET, 33, want)
        except OSError:
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                 want)
        self.rcvbuf = self.sock.getsockopt(socket.SOL_SOCKET,
                                           socket.SO_RCVBUF)
        self.sock.bind((host, port))
        self.sock.settimeout(0.5)
        self.asm = SecondAssembler(sample_rate,
                                   wallclock_check=wallclock_check)
        self.batch = batch
        self._scratch = np.empty(batch * C.VDIF_FRAME_BYTES, np.uint8)

    def poll(self, max_frames: int = 256) -> list:
        """Receive up to max_frames datagrams (the reference drains 20 per
        select wake, writer.c:611-614); returns completed
        (unix_second, samples) tuples."""
        done = []
        nb = min(max_frames, self.batch)
        bad = ctypes.c_uint64(0)
        got = self._lib.udp_drain(
            self.sock.fileno(),
            self._scratch.ctypes.data_as(ctypes.c_void_p),
            C.VDIF_FRAME_BYTES, nb, 200, ctypes.byref(bad))
        self.asm.stats.anomalous += bad.value
        if got > 0:
            done.extend(self.asm.feed_stream(
                self._scratch[:got * C.VDIF_FRAME_BYTES]))
        return [(to_unix(s, self.asm.ref_epoch), b) for s, b in done]

    def close(self):
        self.sock.close()


class RawCapture:
    """Live capture from an AF_PACKET raw socket — the reference's
    production transport (ref src/utils.c:345-407 openRawSocket binds
    PF_PACKET to the fiber interface; src/writer.c:611-614 drains 20
    packets per wake).  On a deployment where the VLA fiber delivers
    ethernet-framed UDP/IPv4 VDIF, a UDP socket bound to the port never
    sees the traffic unless the host's IP stack owns the destination
    address; a raw socket captures it regardless.

    Same poll() surface as UDPCapture: the C helper (csrc/netcap.cpp
    raw_drain) strips the 42-byte eth+IPv4+UDP encapsulation, filters to
    `port`, and lands VDIF frames contiguously for the identical
    vectorized SecondAssembler path.  Requires CAP_NET_RAW.
    """

    def __init__(self, iface: str = "lo", port: int = 20000,
                 sample_rate: int = C.VLITE_RATE, batch: int = 256,
                 wallclock_check: bool = False):
        self._lib = netcap_lib()     # raises before a socket is opened
        # ETH_P_IP (0x0800): the kernel delivers only IPv4 frames; the
        # helper still re-checks the encapsulation per packet
        self.sock = socket.socket(socket.AF_PACKET, socket.SOCK_RAW,
                                  socket.htons(0x0800))
        # PACKET_IGNORE_OUTGOING: without it every locally-sent packet is
        # delivered AGAIN as a TX echo — on loopback that doubles the
        # queue load and was measured to overflow the receive buffer at
        # wire rate (the C helper's pkttype check only discards them
        # after they already cost a queue slot)
        try:
            self.sock.setsockopt(263, 23, 1)   # SOL_PACKET, IGNORE_OUTGOING
        except OSError:
            pass                               # pre-4.20 kernel: C check
        if port:
            self._attach_bpf(port)
        want = 64 * 1024 * 1024
        try:
            self.sock.setsockopt(socket.SOL_SOCKET, 33, want)  # RCVBUFFORCE
        except OSError:
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                 want)
        self.rcvbuf = self.sock.getsockopt(socket.SOL_SOCKET,
                                           socket.SO_RCVBUF)
        self.sock.bind((iface, 0))
        self.sock.settimeout(0.5)
        self.port = port
        self.asm = SecondAssembler(sample_rate,
                                   wallclock_check=wallclock_check)
        self.batch = batch
        self._scratch = np.empty(batch * C.VDIF_FRAME_BYTES, np.uint8)

    def _attach_bpf(self, port: int) -> None:
        """In-kernel classic-BPF filter: keep only IPv4/UDP, unfragmented,
        destination port == ours.  A raw socket otherwise queues EVERY
        packet on the interface; foreign traffic at line rate would evict
        our frames from the receive buffer before userspace drains them
        (the reference gets the same effect from a dedicated fiber VLAN)."""
        import struct

        def ins(code, jt, jf, k):
            return struct.pack("HBBI", code, jt, jf, k)

        # tcpdump -dd 'udp dst port P' against an ethernet link layer
        prog = b"".join([
            ins(0x28, 0, 0, 12),        # ldh ethertype
            ins(0x15, 0, 7, 0x0800),    # jeq IPv4
            ins(0x30, 0, 0, 23),        # ldb ip proto
            ins(0x15, 0, 5, 17),        # jeq UDP
            ins(0x28, 0, 0, 20),        # ldh frag field
            ins(0x45, 3, 0, 0x1FFF),    # jset frag-offset -> drop
            ins(0xB1, 0, 0, 14),        # ldxb 4*([14]&0xf)
            ins(0x48, 0, 0, 16),        # ldh [x+16] = udp dst port
            ins(0x15, 0, 1, port),      # jeq port
            ins(0x06, 0, 0, 0x40000),   # ret keep
            ins(0x06, 0, 0, 0),         # ret drop
        ])
        buf = ctypes.create_string_buffer(prog)
        fprog = struct.pack("HL", len(prog) // 8,
                            ctypes.addressof(buf))
        try:
            self.sock.setsockopt(socket.SOL_SOCKET, 26, fprog)  # ATTACH_FILTER
        except OSError:
            pass                       # helper-side checks still filter

    def poll(self, max_frames: int = 256) -> list:
        done = []
        nb = min(max_frames, self.batch)
        bad = ctypes.c_uint64(0)
        got = self._lib.raw_drain(
            self.sock.fileno(),
            self._scratch.ctypes.data_as(ctypes.c_void_p),
            C.VDIF_FRAME_BYTES, self.port, nb, 200, ctypes.byref(bad))
        self.asm.stats.anomalous += bad.value
        if got > 0:
            done.extend(self.asm.feed_stream(
                self._scratch[:got * C.VDIF_FRAME_BYTES]))
        return [(to_unix(s, self.asm.ref_epoch), b) for s, b in done]

    def close(self):
        self.sock.close()


def open_capture(source: str, sample_rate: int = C.VLITE_RATE,
                 batch: int = 256, wallclock_check: bool = False):
    """Transport switch for live station sources (AntennaConfig.source):
    'udp:PORT' (portable datagram socket) or 'raw:IFACE:PORT' (AF_PACKET,
    the reference's production transport — ref src/utils.c:345-407)."""
    kind, _, rest = source.partition(":")
    if kind == "udp":
        return UDPCapture(port=int(rest), sample_rate=sample_rate,
                          batch=batch, wallclock_check=wallclock_check)
    if kind == "raw":
        iface, _, port = rest.partition(":")
        return RawCapture(iface=iface or "lo", port=int(port or 0),
                          sample_rate=sample_rate, batch=batch,
                          wallclock_check=wallclock_check)
    raise ValueError(f"unknown live capture source {source!r} "
                     "(expected udp:PORT or raw:IFACE:PORT)")
