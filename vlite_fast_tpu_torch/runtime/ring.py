"""Python bindings for the shared-memory baseband ring (csrc/ringbuffer.cpp).

The port's copy of vlite_fast_tpu/runtime/ring.py over its own copy of
the C++ ring (the rb_* functions; the capture library beside them in the
JAX package's csrc is not part of the port).  The ring is the host-side
data plane between the seconds fed to a StationPipeline and the voltage
dumper: one slot holds one second of baseband.  _build.py compiles the
library with g++ on first use; ctypes, no pybind11.  The segment layout
is the JAX package's, so either package's RingBuffer can attach to a
ring the other created.

A ring this module creates is pre-faulted: every slot's pages are
touched once, through this process's mapping, before the ring is
returned.  A slot written for the first time otherwise pays for its
pages inside the write: on an H100's host 0.6 s for a second of
production baseband (256 MB), where a write into pages touched so takes
35-48 ms.
"""

from __future__ import annotations

import ctypes
import os
import threading
import weakref
from typing import Optional, Tuple

import numpy as np

from vlite_fast_tpu_torch import _build

_lib = None


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load("ringbuffer")
    lib.rb_create.restype = ctypes.c_void_p
    lib.rb_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                              ctypes.c_uint64]
    lib.rb_attach.restype = ctypes.c_void_p
    lib.rb_attach.argtypes = [ctypes.c_char_p]
    lib.rb_close.restype = None
    lib.rb_close.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for name in ("rb_bufsz", "rb_nbufs", "rb_nfull", "rb_dropped"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_uint64
        fn.argtypes = [ctypes.c_void_p]
    for name in ("rb_write", "rb_write_overwrite"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_uint64, ctypes.c_double, ctypes.c_uint64]
    lib.rb_read.restype = ctypes.c_int64
    lib.rb_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_uint64,
                            ctypes.POINTER(ctypes.c_double),
                            ctypes.POINTER(ctypes.c_uint64)]
    lib.rb_peek_seq.restype = ctypes.c_int64
    lib.rb_peek_seq.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                ctypes.c_void_p, ctypes.c_uint64,
                                ctypes.POINTER(ctypes.c_double)]
    lib.rb_resident.restype = None
    lib.rb_resident.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_uint64),
                                ctypes.POINTER(ctypes.c_uint64)]
    lib.rb_slot_timestamp.restype = ctypes.c_double
    lib.rb_slot_timestamp.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.rb_set_obs_header.restype = None
    lib.rb_set_obs_header.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rb_get_obs_header.restype = ctypes.c_uint64
    lib.rb_get_obs_header.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_uint64]
    _lib = lib
    return lib


class _Ring(ctypes.Structure):
    """The head of csrc/ringbuffer.cpp's Ring, the handle rb_create and
    rb_attach return."""

    _fields_ = [("hdr", ctypes.c_void_p), ("meta", ctypes.c_void_p),
                ("data", ctypes.c_void_p), ("map_len", ctypes.c_size_t)]


class _SlotMeta(ctypes.Structure):
    """csrc/ringbuffer.cpp's SlotMeta."""

    _fields_ = [("nbytes", ctypes.c_uint64), ("seq", ctypes.c_uint64),
                ("timestamp", ctypes.c_double), ("flags", ctypes.c_uint64)]


# the threads that pre-fault a ring, each over its share of the slots
PREFAULT_THREADS = 8


# slot flag bits
FLAG_OBS_START = 1
FLAG_OBS_END = 2


def _release(lib, handle, unlink: int) -> None:
    lib.rb_close(handle, unlink)


class RingBuffer:
    """One named shm ring.  Slot-oriented: one slot = one second of
    baseband.  A ring this object created is unlinked when it is closed
    (unless close is told unlink=False), or when the object is collected
    without being closed."""

    def __init__(self, name: str, bufsz: int = 0, nbufs: int = 0,
                 create: bool = False):
        self._lib = get_lib()
        self.name = name
        if create:
            self._h = self._lib.rb_create(name.encode(), bufsz, nbufs)
        else:
            self._h = self._lib.rb_attach(name.encode())
        if not self._h:
            raise OSError(f"cannot {'create' if create else 'attach'} ring "
                          f"{name}")
        self._owner = create
        self._finalizer = weakref.finalize(self, _release, self._lib,
                                           self._h, int(create))
        if create:
            self._prefault()

    def _prefault(self) -> None:
        """Zero every slot's bytes (a new segment's are zero already), on
        up to PREFAULT_THREADS threads: the pages are the ring's from
        here on, so that no write pays for its slot's first touch."""
        data = _Ring.from_address(self._h).data
        n = self.bufsz * self.nbufs
        if not n:
            return
        nthr = max(1, min(PREFAULT_THREADS, os.cpu_count() or 1,
                          n >> 26))       # a thread per 64 MiB at least
        chunk = -(-n // nthr)
        threads = [threading.Thread(
            target=ctypes.memset,
            args=(data + lo, 0, min(chunk, n - lo)))
            for lo in range(0, n, chunk)]
        for t in threads:
            t.start()
        try:
            for t in threads:
                t.join()
        finally:
            # an exception in a join (a signal's handler raising) still
            # waits for every thread: the ring's release unmaps the pages
            # they write
            for t in threads:
                t.join()

    # --- geometry ---------------------------------------------------------
    @property
    def bufsz(self) -> int:
        return self._lib.rb_bufsz(self._h)

    @property
    def nbufs(self) -> int:
        return self._lib.rb_nbufs(self._h)

    @property
    def nfull(self) -> int:
        return self._lib.rb_nfull(self._h)

    @property
    def dropped(self) -> int:
        return self._lib.rb_dropped(self._h)

    # --- writer -----------------------------------------------------------
    def write(self, data: np.ndarray, timestamp: float = 0.0,
              flags: int = 0, overwrite: bool = False) -> int:
        """Copy one slot in.  Returns the slot's seq; -1 if the ring was
        full and overwrite=False.  overwrite=True gives rolling-history
        semantics (the voltage-dump buffer: the newest second replaces
        the oldest)."""
        buf = np.ascontiguousarray(data).view(np.uint8)
        fn = (self._lib.rb_write_overwrite if overwrite
              else self._lib.rb_write)
        return fn(self._h, buf.ctypes.data_as(ctypes.c_void_p), buf.nbytes,
                  float(timestamp), flags)

    # --- reader -----------------------------------------------------------
    def read(self) -> Optional[Tuple[np.ndarray, float, int]]:
        """Consume the next slot -> (data, timestamp, flags) or None."""
        out = np.empty(self.bufsz, dtype=np.uint8)
        ts = ctypes.c_double()
        fl = ctypes.c_uint64()
        n = self._lib.rb_read(self._h, out.ctypes.data_as(ctypes.c_void_p),
                              out.nbytes, ctypes.byref(ts), ctypes.byref(fl))
        if n < 0:
            return None
        return out[:n], ts.value, fl.value

    # --- viewer (dumper semantics) ---------------------------------------
    def resident(self) -> Tuple[int, int]:
        lo = ctypes.c_uint64()
        hi = ctypes.c_uint64()
        self._lib.rb_resident(self._h, ctypes.byref(lo), ctypes.byref(hi))
        return lo.value, hi.value

    def peek(self, seq: int) -> Optional[Tuple[np.ndarray, float]]:
        out = np.empty(self.bufsz, dtype=np.uint8)
        ts = ctypes.c_double()
        n = self._lib.rb_peek_seq(self._h, seq,
                                  out.ctypes.data_as(ctypes.c_void_p),
                                  out.nbytes, ctypes.byref(ts))
        if n < 0:
            return None
        return out[:n], ts.value

    def slot_view(self, seq: int) -> Optional[Tuple[np.ndarray, float]]:
        """Slot `seq`'s bytes in place, a read-only view into the segment
        (no copy), and its timestamp; None when the ring no longer holds
        it.  The view stays the slot's only while no write reaches the
        slot, and the ring's mapping only until close: a caller reads it
        where no writer runs meanwhile."""
        r = _Ring.from_address(self._h)
        idx = seq % self.nbufs
        meta = _SlotMeta.from_address(r.meta + idx * ctypes.sizeof(_SlotMeta))
        lo, hi = self.resident()
        if not lo <= seq < hi or meta.seq != seq:
            return None
        buf = (ctypes.c_uint8 * meta.nbytes).from_address(
            r.data + idx * self.bufsz)
        view = np.frombuffer(buf, np.uint8)
        view.flags.writeable = False
        return view, meta.timestamp

    def slot_timestamp(self, seq: int) -> float:
        return self._lib.rb_slot_timestamp(self._h, seq)

    # --- observation header ----------------------------------------------
    def set_obs_header(self, header: str) -> None:
        self._lib.rb_set_obs_header(self._h, header.encode())

    def get_obs_header(self) -> Tuple[str, int]:
        buf = ctypes.create_string_buffer(4096)
        seq = self._lib.rb_get_obs_header(self._h, buf, 4096)
        return buf.value.decode(), seq

    def close(self, unlink: Optional[bool] = None) -> None:
        """Unmap the ring; unlink its segment if `unlink`, or by default
        if this object created it (unlink=False leaves a created ring for
        others to attach, as `cli scrub-ring` does)."""
        if self._h:
            self._finalizer.detach()
            if unlink is None:
                unlink = self._owner
            self._lib.rb_close(self._h, int(unlink))
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
