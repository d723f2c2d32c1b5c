"""Multi-file, multi-antenna voltage-dump datasets.

The researcher-facing file layer of the reference: BasebandFragment /
BasebandFragments / Baseband with aligned overlap iterators
(ref analysis/baseband.py:119-480) and the newer DataSet / load_dataset
loader (ref analysis/beamforming.py:146-242).  A real trigger produces one
`.vdif` file per antenna per dump window (runtime/dumper.py naming
`<ts>_eaXX_<epoch>.vdif`, matching the reference dumper's
/mnt/ssd/dumps convention, ref src/dumper.c:326-376), with RAGGED start
times and possible multi-file splits per antenna; this module loads,
contiguity-checks, gap-fills, time-aligns and block-iterates them.

Alignment is INTEGER sample arithmetic anchored on the VDIF epoch
(`seconds * rate + frame * payload`), exactly like the reference's frame
arithmetic (ref analysis/baseband.py:656-722, writer.c:310-342): float
unix seconds cannot address individual samples at 128 Msps (double
resolution at 1e9 s is ~2.4e-7 s = 30 samples).

The port's own copy of the JAX package's
vlite_fast_tpu/analysis/dataset.py, kept whole so that the port imports
nothing of that package.
"""

from __future__ import annotations

import glob
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from vlite_fast_tpu_torch import constants as C
from vlite_fast_tpu_torch.analysis import unwrap as unwrap_mod
from vlite_fast_tpu_torch.analysis.baseband import VoltageDump
from vlite_fast_tpu_torch.utils import vdif


@dataclass
class BasebandFragment:
    """One dump file: header metadata up front, samples loaded on demand
    (ref analysis/baseband.py:119-238 BasebandFragment)."""

    path: str
    station_id: int
    ref_epoch: int
    start_sample: int            # absolute per-pol sample index since the
                                 # VDIF ref epoch (integer — exact)
    nsamp: int                   # per-pol samples in the file
    sample_rate: int = C.VLITE_RATE
    _samples: Optional[np.ndarray] = field(default=None, repr=False)

    @classmethod
    def from_file(cls, path: str,
                  sample_rate: int = C.VLITE_RATE) -> "BasebandFragment":
        """Metadata from ALL frame headers, not frame 0: a dump that
        starts mid-ring (frames rotated) or lost frames would otherwise
        claim the wrong start and the wrong span."""
        nbytes = os.path.getsize(path)
        nframes = nbytes // C.VDIF_FRAME_BYTES
        raw = np.memmap(path, dtype=np.uint8,
                        shape=(nframes, C.VDIF_FRAME_BYTES))
        hdr = vdif.VDIFHeader.parse(raw[0, :C.VDIF_HEADER_BYTES].tobytes())
        fields = vdif.parse_headers(
            np.ascontiguousarray(raw[:, :C.VDIF_HEADER_BYTES]))
        fps = sample_rate // C.VDIF_DATA_BYTES
        slot = (fields["seconds"].astype(np.int64) * fps
                + fields["frame"].astype(np.int64))
        start = int(slot.min()) * C.VDIF_DATA_BYTES
        nsamp = (int(slot.max()) + 1) * C.VDIF_DATA_BYTES - start
        return cls(path=path, station_id=hdr.station_id,
                   ref_epoch=hdr.ref_epoch, start_sample=start,
                   nsamp=nsamp, sample_rate=sample_rate)

    @property
    def end_sample(self) -> int:
        return self.start_sample + self.nsamp

    @property
    def start_time(self) -> float:
        """Float unix seconds (display/metadata only — alignment uses
        integer samples)."""
        return float(vdif._epoch_unix(self.ref_epoch)) \
            + self.start_sample / self.sample_rate

    def load(self) -> np.ndarray:
        """(npol, nsamp) uint8 (cached).  Frames are placed by their
        header positions (gap-filled with zeros, wrap/reorder tolerant)
        so the integer-sample alignment the dataset layer guarantees
        holds even for imperfect dumps."""
        if self._samples is None:
            raw = np.fromfile(self.path, dtype=np.uint8)
            self._samples, start = vdif.frames_to_streams_placed(
                raw, self.sample_rate)
            assert start == self.start_sample
        return self._samples

    def continuity(self) -> unwrap_mod.ContinuityReport:
        """Frame-continuity check (the db_unwrap validation role,
        ref src/db_unwrap.c:42-86)."""
        raw = np.fromfile(self.path, dtype=np.uint8)
        return unwrap_mod.find_discontinuity(
            raw, frames_per_sec=self.sample_rate // C.VDIF_DATA_BYTES)


class BasebandFragments:
    """All fragments of ONE antenna, time-ordered, read as one stream
    with zero-filled inter-fragment gaps
    (ref analysis/baseband.py:239-358 BasebandFragments)."""

    def __init__(self, fragments: Sequence[BasebandFragment]):
        if not fragments:
            raise ValueError("no fragments")
        self.fragments = sorted(fragments, key=lambda f: f.start_sample)
        sids = {f.station_id for f in self.fragments}
        if len(sids) != 1:
            raise ValueError(f"mixed stations in one fragment set: {sids}")
        epochs = {f.ref_epoch for f in self.fragments}
        if len(epochs) != 1:
            raise ValueError(f"mixed VDIF ref epochs: {epochs}")
        self.station_id = self.fragments[0].station_id
        self.ref_epoch = self.fragments[0].ref_epoch
        self.sample_rate = self.fragments[0].sample_rate

    @property
    def start_sample(self) -> int:
        return self.fragments[0].start_sample

    @property
    def end_sample(self) -> int:
        return max(f.end_sample for f in self.fragments)

    def gap_samples(self) -> List[int]:
        """Missing samples between consecutive fragments (0 = contiguous)."""
        return [max(0, b.start_sample - a.end_sample)
                for a, b in zip(self.fragments, self.fragments[1:])]

    def read(self, s0: int, s1: int) -> np.ndarray:
        """(npol, s1-s0) uint8 covering absolute samples [s0, s1); regions
        no fragment covers stay zero (the capture gap-fill convention)."""
        n = s1 - s0
        out = np.zeros((2, n), np.uint8)
        for f in self.fragments:
            lo = max(s0, f.start_sample)
            hi = min(s1, f.end_sample)
            if hi <= lo:
                continue
            src0 = lo - f.start_sample
            dst0 = lo - s0
            out[:, dst0:dst0 + hi - lo] = f.load()[:, src0:src0 + hi - lo]
        return out


class DumpDataset:
    """All antennas' dumps of one trigger event, with aligned access
    (ref analysis/beamforming.py:146-242 DataSet/load_dataset +
    baseband.py:359-480 Baseband iterators)."""

    def __init__(self, per_station: Dict[int, BasebandFragments]):
        if not per_station:
            raise ValueError("empty dataset")
        self.per_station = dict(sorted(per_station.items()))
        rates = {f.sample_rate for f in self.per_station.values()}
        if len(rates) != 1:
            raise ValueError(f"mixed sample rates: {rates}")
        self.sample_rate = rates.pop()

    @classmethod
    def load(cls, paths_or_dir, sample_rate: int = C.VLITE_RATE
             ) -> "DumpDataset":
        """Load from a directory, a glob, or an explicit path list;
        fragments are grouped by the station id in their VDIF headers
        (filenames are advisory only)."""
        if isinstance(paths_or_dir, (str, os.PathLike)):
            p = str(paths_or_dir)
            if os.path.isdir(p):
                paths = sorted(glob.glob(os.path.join(p, "*.vdif")))
            else:
                paths = sorted(glob.glob(p))
        else:
            paths = list(paths_or_dir)
        if not paths:
            raise FileNotFoundError(f"no dump files in {paths_or_dir!r}")
        groups: Dict[int, List[BasebandFragment]] = {}
        for path in paths:
            frag = BasebandFragment.from_file(path, sample_rate)
            sid = frag.station_id
            if sid == 0:
                # stations that never set the header field: fall back to
                # the dumper's filename convention _eaXX_
                m = re.search(r"_ea(\d+)_", os.path.basename(path))
                if m:
                    sid = int(m.group(1))
            groups.setdefault(sid, []).append(frag)
        return cls({sid: BasebandFragments(frags)
                    for sid, frags in groups.items()})

    @property
    def station_ids(self) -> List[int]:
        return list(self.per_station.keys())

    def common_window(self) -> tuple:
        """Absolute sample range [s0, s1) every antenna covers."""
        s0 = max(f.start_sample for f in self.per_station.values())
        s1 = min(f.end_sample for f in self.per_station.values())
        if s1 <= s0:
            raise ValueError("dumps do not overlap in time")
        return s0, s1

    def aligned(self, s0: Optional[int] = None,
                s1: Optional[int] = None) -> List[VoltageDump]:
        """Every antenna's samples on one common sample window (the
        re_order_baseband role over ragged multi-file dumps,
        ref analysis/baseband.py:656-722)."""
        c0, c1 = self.common_window()
        s0 = c0 if s0 is None else max(s0, c0)
        s1 = c1 if s1 is None else min(s1, c1)
        out = []
        for sid, frags in self.per_station.items():
            t0 = float(vdif._epoch_unix(frags.ref_epoch)) \
                + s0 / self.sample_rate
            out.append(VoltageDump(samples=frags.read(s0, s1),
                                   start_time=t0, station_id=sid,
                                   sample_rate=self.sample_rate))
        return out

    def blocks(self, block_samps: int, overlap: int = 0
               ) -> Iterator[List[VoltageDump]]:
        """Aligned overlapping block iterator across all antennas (the
        FFTIterator / overlap-iterator role, ref analysis/baseband.py:
        400-480, beamforming.py:243-330): yields lists of per-antenna
        VoltageDumps, each block advancing by block_samps - overlap."""
        s0, s1 = self.common_window()
        step = block_samps - overlap
        if step <= 0:
            raise ValueError("overlap must be smaller than block")
        pos = s0
        while pos + block_samps <= s1:
            yield self.aligned(pos, pos + block_samps)
            pos += step


def load_dataset(paths_or_dir, sample_rate: int = C.VLITE_RATE
                 ) -> DumpDataset:
    """Convenience loader (ref analysis/beamforming.py:162 load_dataset)."""
    return DumpDataset.load(paths_or_dir, sample_rate)
