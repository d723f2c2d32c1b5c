"""sigproc filterbank (.fil) reading/writing.

Replaces the reference's send_string/send_int/send_double header writers
(src/util.c:51-89) and the header assembly in write_sigproc_header
(src/process_baseband.cu:226-270), plus a reader for tests/offline analysis.

The port's own copy of the JAX package's vlite_fast_tpu/utils/sigproc.py, kept
whole so that the port imports nothing of that package.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import BinaryIO

import numpy as np

_STR_KEYS = {"source_name", "rawdatafile"}
_INT_KEYS = {"telescope_id", "machine_id", "data_type", "barycentric",
             "pulsarcentric", "nbits", "nsamples", "nchans", "nifs", "nbeams",
             "ibeam"}
_DBL_KEYS = {"az_start", "za_start", "src_raj", "src_dej", "tstart", "tsamp",
             "fch1", "foff", "refdm", "period"}


def _send_string(s: str, fp: BinaryIO):
    b = s.encode()
    fp.write(struct.pack("<i", len(b)))
    fp.write(b)


def _send_int(name: str, v: int, fp: BinaryIO):
    _send_string(name, fp)
    fp.write(struct.pack("<i", int(v)))


def _send_double(name: str, v: float, fp: BinaryIO):
    _send_string(name, fp)
    fp.write(struct.pack("<d", float(v)))


def radians_to_sigproc(angle_rad: float, is_ra: bool) -> float:
    """VLA radians -> sigproc ddmmss.s / hhmmss.s packed float
    (ref src/process_baseband.cu:245-259)."""
    if is_ra:
        hh = (180.0 / np.pi) * (24.0 / 360.0) * angle_rad
    else:
        hh = (180.0 / np.pi) * abs(angle_rad)
    mm = (hh - int(hh)) * 60
    ss = (mm - int(mm)) * 60
    val = int(hh) * 1e4 + int(mm) * 1e2 + ss
    if not is_ra and angle_rad < 0:
        val = -val
    return val


@dataclass
class FilterbankHeader:
    source_name: str = "synthetic"
    telescope_id: int = 0
    machine_id: int = 0
    data_type: int = 1
    barycentric: int = 0
    src_raj: float = 0.0
    src_dej: float = 0.0
    fch1: float = 361.941  # MHz, first (highest) channel
    foff: float = -64.0 / 6251
    nchans: int = 4096
    nbits: int = 2
    tstart: float = 55000.0  # MJD
    tsamp: float = 781.25e-6
    nifs: int = 1
    extra: dict = field(default_factory=dict)

    def write(self, fp: BinaryIO):
        """Field order matches write_sigproc_header
        (ref src/process_baseband.cu:226-268)."""
        _send_string("HEADER_START", fp)
        _send_string("source_name", fp)
        _send_string(self.source_name, fp)
        _send_int("barycentric", self.barycentric, fp)
        _send_int("telescope_id", self.telescope_id, fp)
        _send_double("src_raj", self.src_raj, fp)
        _send_double("src_dej", self.src_dej, fp)
        _send_int("data_type", self.data_type, fp)
        _send_double("fch1", self.fch1, fp)
        _send_double("foff", self.foff, fp)
        _send_int("nchans", self.nchans, fp)
        _send_int("nbits", self.nbits, fp)
        _send_double("tstart", self.tstart, fp)
        _send_double("tsamp", self.tsamp, fp)
        _send_int("nifs", self.nifs, fp)
        _send_string("HEADER_END", fp)


def read_header(fp: BinaryIO) -> FilterbankHeader:
    def read_string() -> str:
        (n,) = struct.unpack("<i", fp.read(4))
        if n < 0 or n > 128:
            raise ValueError(f"bad sigproc string length {n}")
        return fp.read(n).decode()

    if read_string() != "HEADER_START":
        raise ValueError("not a sigproc file")
    hdr = FilterbankHeader()
    while True:
        key = read_string()
        if key == "HEADER_END":
            break
        if key in _STR_KEYS:
            val = read_string()
        elif key in _INT_KEYS:
            (val,) = struct.unpack("<i", fp.read(4))
        elif key in _DBL_KEYS:
            (val,) = struct.unpack("<d", fp.read(8))
        else:
            raise ValueError(f"unknown sigproc key {key!r}")
        if hasattr(hdr, key):
            setattr(hdr, key, val)
        else:
            hdr.extra[key] = val
    return hdr


class FilterbankWriter:
    """Streaming .fil writer: header once, then packed sample blocks."""

    def __init__(self, path: str, header: FilterbankHeader):
        self.header = header
        self.fp = open(path, "wb")
        header.write(self.fp)

    def write_block(self, packed: np.ndarray):
        """packed: uint8 array of already-quantized/packed samples,
        time-major (t, chan-packed-bytes)."""
        self.fp.write(np.ascontiguousarray(packed, dtype=np.uint8).tobytes())

    def close(self):
        self.fp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_filterbank(path: str) -> tuple:
    """Read a .fil file -> (header, data[time, chan] float32).

    Unpacks 2/4/8-bit samples; bit order matches the quantizer packing
    (LSB-first within bytes, ref src/pb_kernels.cu:633-707)."""
    with open(path, "rb") as fp:
        hdr = read_header(fp)
        raw = np.frombuffer(fp.read(), dtype=np.uint8)
    nb = hdr.nbits
    if nb == 8:
        data = raw.astype(np.float32)
    elif nb == 4:
        data = np.empty(raw.size * 2, dtype=np.float32)
        data[0::2] = raw & 0xF
        data[1::2] = raw >> 4
    elif nb == 2:
        data = np.empty(raw.size * 4, dtype=np.float32)
        for j in range(4):
            data[j::4] = (raw >> (2 * j)) & 0x3
    else:
        raise ValueError(f"unsupported nbits {nb}")
    nchan = hdr.nchans * hdr.nifs
    ntime = data.size // nchan
    return hdr, data[:ntime * nchan].reshape(ntime, nchan)
