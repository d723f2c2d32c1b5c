"""Voltage-dump continuity check and ring-wrap repair.

The db_unwrap role (ref src/db_unwrap.c:15-118): a dump written from a
circular ring may start mid-stream, producing one frame-number
discontinuity per polarization where the ring wrapped.  find_discontinuity
locates it (vectorized over all headers at once); unwrap rotates the frame
sequence so time is monotonic.  More than one discontinuity per thread
means real corruption.

The port's own copy of the JAX package's
vlite_fast_tpu/analysis/unwrap.py, kept whole so that the port imports
nothing of that package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from vlite_fast_tpu_torch import constants as C
from vlite_fast_tpu_torch.utils import vdif


@dataclass
class ContinuityReport:
    nframes: int
    discontinuities: Tuple[int, int]   # per thread id
    wrap_frame: int                    # frame index of first break, -1 none

    @property
    def clean(self) -> bool:
        return self.wrap_frame < 0

    @property
    def corrupted(self) -> bool:
        return max(self.discontinuities) > 1


def find_discontinuity(raw: np.ndarray,
                       frames_per_sec: int = C.FRAMES_PER_SEC
                       ) -> ContinuityReport:
    """Scan frame numbers per thread for skips (vectorized equivalent of
    the db_unwrap read loop, ref db_unwrap.c:42-77)."""
    nframes = raw.size // C.VDIF_FRAME_BYTES
    frames = raw[:nframes * C.VDIF_FRAME_BYTES].reshape(
        nframes, C.VDIF_FRAME_BYTES)
    f = vdif.parse_headers(frames[:, :C.VDIF_HEADER_BYTES])
    ndisc = [0, 0]
    wrap = -1
    for thread in (0, 1):
        mask = (f["thread_id"] != 0) == bool(thread)
        nums = f["frame"][mask].astype(np.int64)
        idx = np.nonzero(mask)[0]
        if nums.size < 2:
            continue
        diff = np.diff(nums)
        # contiguous: +1 or the per-second rollover -(frames_per_sec-1)
        bad = (diff != 1) & (diff != -(frames_per_sec - 1))
        ndisc[thread] = int(bad.sum())
        if bad.any():
            first = int(idx[1:][bad][0])
            wrap = first if wrap < 0 else min(wrap, first)
    return ContinuityReport(nframes=nframes,
                            discontinuities=(ndisc[0], ndisc[1]),
                            wrap_frame=wrap)


def unwrap(raw: np.ndarray,
           report: Optional[ContinuityReport] = None) -> np.ndarray:
    """Rotate the frame stream so it starts at the wrap point
    (ref db_unwrap.c:92-114: copy [disc:] then [:disc])."""
    report = report or find_discontinuity(raw)
    if report.corrupted:
        raise ValueError("more than one discontinuity per thread; "
                         "file is likely corrupted")
    if report.clean:
        return raw
    cut = report.wrap_frame * C.VDIF_FRAME_BYTES
    n = report.nframes * C.VDIF_FRAME_BYTES
    return np.concatenate([raw[cut:n], raw[:cut]])


def join_dumps(paths, out_path: str,
               frames_per_sec: int = C.FRAMES_PER_SEC) -> ContinuityReport:
    """Concatenate per-event dump files into one continuous stream in time
    order (the scripts/join_dumps.py role): sort segments by first-frame
    time, append, and report the continuity of the result."""
    segs = []
    for p in paths:
        raw = np.fromfile(p, dtype=np.uint8)
        f = vdif.parse_headers(raw[:C.VDIF_HEADER_BYTES])
        key = (int(f["ref_epoch"][0]), int(f["seconds"][0]),
               int(f["frame"][0]))
        segs.append((key, raw))
    segs.sort(key=lambda kr: kr[0])
    joined = np.concatenate([r for _, r in segs])
    joined.tofile(out_path)
    return find_discontinuity(joined, frames_per_sec=frames_per_sec)


def unwrap_file(path: str, out_path: Optional[str] = None) -> ContinuityReport:
    """File-level CLI behavior: writes <path>.uw when a wrap is found."""
    raw = np.fromfile(path, dtype=np.uint8)
    report = find_discontinuity(raw)
    if not report.clean:
        fixed = unwrap(raw, report)
        fixed.tofile(out_path or path + ".uw")
    return report
