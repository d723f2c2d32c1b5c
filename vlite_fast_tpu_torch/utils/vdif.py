"""VDIF frame handling: header pack/parse, frame arithmetic, time conversion.

Replaces the reference's dependence on libvdifio plus the frame bookkeeping
logic in src/writer.c:310-342 (vdif_frame_difference / increment_vdif_header)
and src/utils.c:498-521 (vdif_to_unixepoch / vdif_to_dunixepoch).  Everything
is vectorized numpy so a second of frames (51,200) parses in one call.

VDIF header layout (VDIF spec v1.1, 8 little-endian 32-bit words):
  w0: [29:0] seconds from ref epoch, [30] legacy, [31] invalid
  w1: [23:0] frame number within second, [29:24] ref epoch (half-years y2000)
  w2: [23:0] frame length / 8 bytes,   [28:24] log2 nchan, [31:29] version
  w3: [15:0] station id, [25:16] thread id, [30:26] bits/sample - 1,
      [31] complex flag
  w4-w7: extended user data (zeroed here)

The port's copy of vlite_fast_tpu/utils/vdif.py (numpy and the standard
library), on the port's constants.
"""

from __future__ import annotations

import calendar
import datetime
from dataclasses import dataclass

import numpy as np

from vlite_fast_tpu_torch import constants as C

HEADER_WORDS = 8
HEADER_BYTES = C.VDIF_HEADER_BYTES


def _epoch_unix(ref_epoch: np.ndarray | int) -> np.ndarray:
    """Unix time of VDIF reference epoch(s) (half-years since 2000-01-01).

    Mirrors vdif_to_unixepoch (ref src/utils.c:498-521) without the local
    mktime round-trip: computed directly in UTC.
    """
    ref_epoch = np.asarray(ref_epoch)
    years = 2000 + ref_epoch // 2
    months = 1 + 6 * (ref_epoch % 2)
    out = np.empty(ref_epoch.shape, dtype=np.int64)
    flat_y, flat_m, flat_o = years.ravel(), months.ravel(), out.ravel()
    for i in range(flat_y.size):
        flat_o[i] = calendar.timegm(
            (int(flat_y[i]), int(flat_m[i]), 1, 0, 0, 0))
    return out.reshape(ref_epoch.shape)


def default_ref_epoch(unix_time: float) -> int:
    """The VDIF epoch code for the half-year containing unix_time."""
    dt = datetime.datetime.utcfromtimestamp(unix_time)
    return (dt.year - 2000) * 2 + (1 if dt.month > 6 else 0)


@dataclass
class VDIFHeader:
    """A single parsed VDIF header (scalar convenience wrapper)."""

    seconds: int = 0          # seconds from ref epoch
    frame: int = 0            # frame number within second
    ref_epoch: int = 0
    thread_id: int = 0
    station_id: int = 0
    bits_per_sample: int = 8
    frame_bytes: int = C.VDIF_FRAME_BYTES
    nchan: int = 1
    invalid: bool = False
    complex_data: bool = False

    def pack(self) -> bytes:
        return pack_headers(
            seconds=np.array([self.seconds]),
            frames=np.array([self.frame]),
            ref_epoch=self.ref_epoch,
            thread_ids=np.array([self.thread_id]),
            station_id=self.station_id,
            bits_per_sample=self.bits_per_sample,
            frame_bytes=self.frame_bytes,
            nchan=self.nchan,
        ).tobytes()

    @classmethod
    def parse(cls, buf: bytes) -> "VDIFHeader":
        f = parse_headers(np.frombuffer(buf[:HEADER_BYTES], dtype=np.uint8))
        return cls(seconds=int(f["seconds"][0]), frame=int(f["frame"][0]),
                   ref_epoch=int(f["ref_epoch"][0]),
                   thread_id=int(f["thread_id"][0]),
                   station_id=int(f["station_id"][0]),
                   bits_per_sample=int(f["bits_per_sample"][0]),
                   frame_bytes=int(f["frame_bytes"][0]),
                   nchan=int(f["nchan"][0]),
                   invalid=bool(f["invalid"][0]),
                   complex_data=bool(f["complex"][0]))

    @property
    def unix_time(self) -> float:
        """Fractional unix epoch (ref src/utils.c:516-521)."""
        return float(_epoch_unix(self.ref_epoch)) + self.seconds \
            + self.frame / C.FRAMES_PER_SEC


def pack_headers(seconds: np.ndarray, frames: np.ndarray, ref_epoch: int,
                 thread_ids: np.ndarray, station_id: int = 0,
                 bits_per_sample: int = 8,
                 frame_bytes: int = C.VDIF_FRAME_BYTES,
                 nchan: int = 1) -> np.ndarray:
    """Vectorized header builder -> (n, 32) uint8 array."""
    seconds = np.asarray(seconds, dtype=np.uint32)
    frames = np.asarray(frames, dtype=np.uint32)
    thread_ids = np.broadcast_to(
        np.asarray(thread_ids, dtype=np.uint32), seconds.shape)
    n = seconds.size
    words = np.zeros((n, HEADER_WORDS), dtype=np.uint32)
    words[:, 0] = seconds & 0x3FFFFFFF
    words[:, 1] = (frames & 0xFFFFFF) | ((ref_epoch & 0x3F) << 24)
    log2_nchan = int(np.log2(nchan)) if nchan > 1 else 0
    words[:, 2] = ((frame_bytes // 8) & 0xFFFFFF) | (log2_nchan << 24)
    words[:, 3] = ((station_id & 0xFFFF)
                   | ((thread_ids & 0x3FF) << 16)
                   | (((bits_per_sample - 1) & 0x1F) << 26))
    return words.view(np.uint8).reshape(n, HEADER_BYTES)


def parse_headers(raw: np.ndarray) -> dict:
    """Parse n VDIF headers from uint8 array of shape (..., 32) or flat."""
    raw = np.ascontiguousarray(np.asarray(raw, dtype=np.uint8))
    words = raw.reshape(-1, HEADER_BYTES).view(np.uint32)
    return {
        "seconds": words[:, 0] & 0x3FFFFFFF,
        "invalid": (words[:, 0] >> 31) & 0x1,
        "legacy": (words[:, 0] >> 30) & 0x1,
        "frame": words[:, 1] & 0xFFFFFF,
        "ref_epoch": (words[:, 1] >> 24) & 0x3F,
        "frame_bytes": (words[:, 2] & 0xFFFFFF) * 8,
        "nchan": np.uint32(1) << ((words[:, 2] >> 24) & 0x1F),
        "station_id": words[:, 3] & 0xFFFF,
        "thread_id": (words[:, 3] >> 16) & 0x3FF,
        "bits_per_sample": ((words[:, 3] >> 26) & 0x1F) + 1,
        "complex": (words[:, 3] >> 31) & 0x1,
    }


def frame_index(seconds: np.ndarray, frames: np.ndarray,
                thread_ids: np.ndarray) -> np.ndarray:
    """Absolute dual-pol frame counter used for gap detection.

    Matches the convention of vdif_frame_difference (ref src/writer.c:310-321):
    consecutive frames interleave threads (t0,f) (t1,f) (t0,f+1) ... and any
    nonzero thread id maps to thread 1.
    """
    thread = (np.asarray(thread_ids) != 0).astype(np.int64)
    return (np.asarray(seconds, dtype=np.int64) * (2 * C.FRAMES_PER_SEC)
            + np.asarray(frames, dtype=np.int64) * 2 + thread)


def frame_difference(hdr1: VDIFHeader, hdr2: VDIFHeader) -> int:
    """Difference in dual-pol frames, 1 for contiguous data."""
    i1 = frame_index(np.array(hdr1.seconds), np.array(hdr1.frame),
                     np.array(hdr1.thread_id))
    i2 = frame_index(np.array(hdr2.seconds), np.array(hdr2.frame),
                     np.array(hdr2.thread_id))
    return int(i2 - i1)


def increment_header(hdr: VDIFHeader) -> VDIFHeader:
    """Next frame in the dual-pol stream (ref src/writer.c:323-342)."""
    thread = int(hdr.thread_id != 0)
    out = VDIFHeader(**{**hdr.__dict__})
    if thread == 1:
        out.frame = hdr.frame + 1
        out.thread_id = 0
        if out.frame == C.FRAMES_PER_SEC:
            out.seconds = hdr.seconds + 1
            out.frame = 0
    else:
        out.thread_id = 1
    return out


def unix_times(fields: dict) -> np.ndarray:
    """Fractional unix time per parsed frame."""
    base = _epoch_unix(fields["ref_epoch"].astype(np.int64))
    return (base + fields["seconds"].astype(np.float64)
            + fields["frame"].astype(np.float64) / C.FRAMES_PER_SEC)


# ---------------------------------------------------------------------------
# Stream <-> sample-buffer conversion
# ---------------------------------------------------------------------------

def frames_to_streams(raw: np.ndarray, npol: int = 2,
                      data_bytes: int = C.VDIF_DATA_BYTES) -> tuple:
    """Split a contiguous thread-interleaved VDIF byte stream into
    per-polarization sample arrays.

    raw: uint8 buffer of whole frames (n_frames * frame_bytes).
    Returns (samples[npol, nsamp], first_header: VDIFHeader).
    Assumes the gap-filled, 1-s-aligned output of the capture stage
    (ref writer.c guarantees this ordering into the baseband ring).
    """
    frame_bytes = data_bytes + HEADER_BYTES
    raw = np.asarray(raw, dtype=np.uint8)
    nframes = raw.size // frame_bytes
    raw = raw[:nframes * frame_bytes].reshape(nframes, frame_bytes)
    hdr = VDIFHeader.parse(raw[0, :HEADER_BYTES].tobytes())
    fields = parse_headers(raw[:, :HEADER_BYTES])
    payload = raw[:, HEADER_BYTES:]
    pols = []
    for ipol in range(npol):
        mask = (fields["thread_id"] != 0) == bool(ipol)
        pols.append(payload[mask].reshape(-1))
    n = min(p.size for p in pols)
    return np.stack([p[:n] for p in pols]), hdr


def frames_to_streams_placed(raw: np.ndarray, sample_rate: int,
                             npol: int = 2,
                             data_bytes: int = C.VDIF_DATA_BYTES,
                             max_span_factor: int = 16) -> tuple:
    """Decode frames by their HEADER positions instead of file order.

    Robust to dropped frames (their span stays zero — the capture
    gap-fill convention), out-of-order frames, and ring-wrap rotation
    (the db_unwrap case): each payload lands at the absolute per-pol
    sample index its (seconds, frame#) header encodes.  The blind
    concatenation of frames_to_streams silently shifts every sample
    after an intra-file gap.

    Returns (samples[npol, nsamp], start_sample) where start_sample is
    the absolute per-pol index (since the VDIF ref epoch) of samples[:,0]
    and nsamp spans min..max frame inclusive.  Requires sample_rate to be
    a multiple of data_bytes (true for VLITE's 25600 frames/s and every
    test geometry).
    """
    if sample_rate % data_bytes:
        raise ValueError("sample_rate must be a multiple of the frame "
                         "payload size for placed decoding")
    fps = sample_rate // data_bytes
    frame_bytes = data_bytes + HEADER_BYTES
    raw = np.asarray(raw, dtype=np.uint8)
    nframes = raw.size // frame_bytes
    raw = raw[:nframes * frame_bytes].reshape(nframes, frame_bytes)
    fields = parse_headers(raw[:, :HEADER_BYTES])
    payload = raw[:, HEADER_BYTES:]
    slot = (fields["seconds"].astype(np.int64) * fps
            + fields["frame"].astype(np.int64))
    slot0, slot1 = int(slot.min()), int(slot.max())
    nslot = slot1 - slot0 + 1
    # Header fields are untrusted (a corrupt dump is db_unwrap's whole
    # reason to exist): one garbage seconds/frame value must not size the
    # output to terabytes.  Bound the span to max_span_factor x the frame
    # count and surface a continuity error instead of allocating.
    max_slots = max(nframes, 1) * max(int(max_span_factor), 1)
    if nslot > max_slots:
        raise ValueError(
            f"VDIF frame span {nslot} slots >> {nframes} frames present "
            f"(bound {max_slots}): corrupt header timestamps — run the "
            "unwrap/continuity repair instead of placed decoding")
    out = np.zeros((npol, nslot, data_bytes), np.uint8)
    for ipol in range(npol):
        mask = (fields["thread_id"] != 0) == bool(ipol)
        out[ipol, slot[mask] - slot0] = payload[mask]
    return (out.reshape(npol, nslot * data_bytes),
            slot0 * data_bytes)


def streams_to_frames(samples: np.ndarray, ref_epoch: int, start_second: int,
                      start_frame: int = 0, station_id: int = 0,
                      sample_rate: int = C.VLITE_RATE) -> np.ndarray:
    """Frame per-pol uint8 sample streams into an interleaved VDIF byte
    stream (the genbase framing loop, ref src/genbase.cu:443-486).

    samples: (npol, nsamp) uint8; nsamp must be a multiple of VDIF_DATA_BYTES.
    Frame numbering rolls over at sample_rate/VDIF_DATA_BYTES frames/s
    (25600 at the real VLITE rate, ref src/def.h:22-23).
    Returns uint8 stream of (t0,f)(t1,f)(t0,f+1)... frames.
    """
    samples = np.asarray(samples, dtype=np.uint8)
    npol, nsamp = samples.shape
    if nsamp % C.VDIF_DATA_BYTES:
        raise ValueError("nsamp must be a multiple of VDIF_DATA_BYTES")
    frames_per_sec = sample_rate // C.VDIF_DATA_BYTES
    nframes = nsamp // C.VDIF_DATA_BYTES
    abs_frame = start_frame + np.arange(nframes)
    seconds = start_second + abs_frame // frames_per_sec
    frames = abs_frame % frames_per_sec
    out = np.empty((nframes, npol, C.VDIF_FRAME_BYTES), dtype=np.uint8)
    for ipol in range(npol):
        hdrs = pack_headers(seconds, frames, ref_epoch,
                            np.full(nframes, ipol), station_id)
        out[:, ipol, :HEADER_BYTES] = hdrs
        out[:, ipol, HEADER_BYTES:] = samples[ipol].reshape(
            nframes, C.VDIF_DATA_BYTES)
    return out.reshape(-1)
