"""The port's baseband ring (runtime/ring.py over its copy of the C++ ring,
built by _build.py with g++) and its triggered dumper, against the JAX
package's, on the CPU; a created ring is pre-faulted.

The ring cases of tests/test_runtime.py run on the port's ring; a ring
created by one package is read by the other's RingBuffer (the segment
layout is shared); the dumper writes the same seconds, bytes and file
names as the JAX package's over the same slots.  The port's rings take
names of their own, so no test here opens a name a JAX test may hold.
"""

import gc
import os

import numpy as np
import pytest

from vlite_fast_tpu.runtime.dumper import TriggeredDumper as JDumper
from vlite_fast_tpu.runtime.ring import RingBuffer as JRing
from vlite_fast_tpu.runtime.trigger import Trigger as JTrigger
from vlite_fast_tpu_torch import _build
from vlite_fast_tpu_torch.runtime import ring as tring
from vlite_fast_tpu_torch.runtime.dumper import TriggeredDumper
from vlite_fast_tpu_torch.runtime.ring import FLAG_OBS_START, RingBuffer
from vlite_fast_tpu_torch.runtime.trigger import Trigger


def _name(what: str) -> str:
    return f"/vfast_torch_t_{what}_{os.getpid()}"


def _write_read(rb):
    data = np.arange(256, dtype=np.uint8)
    assert rb.write(data, 5.0, FLAG_OBS_START) == 0
    got, ts, fl = rb.read()
    np.testing.assert_array_equal(got, data)
    assert ts == 5.0 and fl == FLAG_OBS_START
    assert rb.read() is None


def _full_drops(rb):
    d = np.zeros(16, np.uint8)
    assert rb.write(d) >= 0
    assert rb.write(d) >= 0
    assert rb.write(d) == -1
    assert rb.dropped == 1


def _viewer_peek(rb):
    for i in range(6):
        rb.write(np.full(16, i, np.uint8), timestamp=100.0 + i,
                 overwrite=True)
    assert rb.resident() == (2, 6)
    assert rb.peek(1) is None            # overwritten
    data, ts = rb.peek(3)
    assert ts == 103.0 and data[0] == 3
    assert rb.slot_timestamp(5) == 105.0


def _obs_header(rb):
    rb.set_obs_header("NAME J0534+2200\nRA 1.459")
    hdr, seq = rb.get_obs_header()
    assert "J0534" in hdr and seq == 1


RING_CASES = {"write_read": (256, 4, _write_read),
              "full_drops": (16, 2, _full_drops),
              "viewer_peek": (16, 4, _viewer_peek),
              "obs_header": (16, 2, _obs_header)}


@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_ring_cases(case):
    bufsz, nbufs, body = RING_CASES[case]
    with RingBuffer(_name(case), bufsz=bufsz, nbufs=nbufs,
                    create=True) as rb:
        assert (rb.bufsz, rb.nbufs) == (bufsz, nbufs)
        body(rb)


def _fill(rb, n=6, base=1_700_000_000.0):
    for i in range(n):
        rb.write(np.full(rb.bufsz, 10 + i, np.uint8) ^ np.arange(
            rb.bufsz, dtype=np.uint8), timestamp=base + i,
            flags=FLAG_OBS_START if i == 0 else 0, overwrite=True)
    rb.set_obs_header("STATIONID 7\nNAME X\n")


@pytest.mark.parametrize("creator", ["port", "jax"])
def test_ring_read_by_the_other_package(creator):
    """A ring one package created, attached by the other's RingBuffer:
    the same geometry, resident slots, timestamps, bytes and header."""
    make, attach = (RingBuffer, JRing) if creator == "port" \
        else (JRing, RingBuffer)
    name = _name(f"x{creator}")
    owner = make(name, bufsz=64, nbufs=4, create=True)
    try:
        _fill(owner)
        other = attach(name)
        try:
            assert (other.bufsz, other.nbufs) == (64, 4)
            assert other.resident() == owner.resident() == (2, 6)
            for seq in range(2, 6):
                a, b = other.peek(seq), owner.peek(seq)
                np.testing.assert_array_equal(a[0], b[0])
                assert a[1] == b[1] == other.slot_timestamp(seq)
            assert other.peek(1) is None
            assert other.get_obs_header() == owner.get_obs_header()
        finally:
            other.close()
        assert os.path.exists(f"/dev/shm{name}")  # a viewer never unlinks
    finally:
        owner.close(unlink=True)
    assert not os.path.exists(f"/dev/shm{name}")


def test_ring_unlinked_when_collected():
    """A created ring that is never closed is unlinked once collected."""
    name = _name("gc")
    rb = RingBuffer(name, bufsz=16, nbufs=2, create=True)
    assert os.path.exists(f"/dev/shm{name}")
    del rb
    gc.collect()
    assert not os.path.exists(f"/dev/shm{name}")


def _resident_kib() -> int:
    """This process's resident memory (VmRSS, shared pages included),
    KiB."""
    with open("/proc/self/status") as fp:
        return next(int(ln.split()[1]) for ln in fp
                    if ln.startswith("VmRSS:"))


def test_created_ring_is_prefaulted():
    """A created ring's slots are resident in this process before its
    first write (their pages touched through its own mapping); a write
    and a peek then see the written bytes."""
    bufsz, nbufs = 1 << 22, 8
    before = _resident_kib()
    with RingBuffer(_name("prefault"), bufsz=bufsz, nbufs=nbufs,
                    create=True) as rb:
        assert _resident_kib() - before >= bufsz * nbufs // 1024
        assert rb.resident() == (0, 0)
        data = np.full(bufsz, 7, np.uint8)
        assert rb.write(data, 1.0) == 0
        got, ts = rb.peek(0)
        assert ts == 1.0 and np.array_equal(got, data)
    # its pages leave with it (the test's own arrays stay)
    assert _resident_kib() - before < bufsz * nbufs // 1024


def test_a_signal_during_the_prefault_leaves_no_ring():
    """A process whose SIGTERM handler exits while its ring is being
    pre-faulted exits with the handler's code, and its ring's segment is
    gone: the release waits for the pre-fault's threads before it unmaps
    the pages they write."""
    import signal
    import subprocess
    import sys
    import time
    name = _name("term")
    child = (
        "import signal, sys\n"
        "from vlite_fast_tpu_torch.runtime.ring import RingBuffer, get_lib\n"
        "get_lib()\n"
        "signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))\n"
        "print('creating', flush=True)\n"
        f"rb = RingBuffer({name!r}, bufsz=64 << 20, nbufs=8, create=True)\n"
        "import time; time.sleep(60)\n")
    p = subprocess.Popen([sys.executable, "-c", child],
                         stdout=subprocess.PIPE, text=True,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    try:
        assert p.stdout.readline().strip() == "creating"
        time.sleep(0.05)
        p.send_signal(signal.SIGTERM)
        assert p.wait(timeout=60) == 143
    finally:
        p.kill()
        p.stdout.close()
    assert not os.path.exists("/dev/shm" + name)


def test_slot_view_reads_a_slot_in_place():
    """slot_view gives a resident slot's bytes as a read-only view into
    the segment and its timestamp (a later write into the slot shows
    through it); None for a slot the ring no longer holds."""
    with RingBuffer(_name("view"), bufsz=64, nbufs=2, create=True) as rb:
        for k in range(3):
            rb.write(np.full(64, k, np.uint8), 10.0 + k, overwrite=True)
        assert rb.resident() == (1, 3)
        assert rb.slot_view(0) is None and rb.slot_view(3) is None
        view, ts = rb.slot_view(2)
        assert ts == 12.0 and not view.flags.writeable
        np.testing.assert_array_equal(view, np.full(64, 2, np.uint8))
        for k in (3, 4):        # seq 4 takes seq 2's slot
            rb.write(np.full(64, k, np.uint8), 10.0 + k, overwrite=True)
        assert view[0] == 4 and rb.slot_view(2) is None


def test_ring_library_built_by_gxx():
    """The ring's library is the port's own csrc/ringbuffer.cpp, built by
    g++ into the build directory under a hash of source and flags."""
    lib = tring.get_lib()
    path = _build.lib_path("ringbuffer")
    assert path.exists() and path.parent == _build.BUILD_DIR
    assert _build.sources("ringbuffer") == [_build.CSRC / "ringbuffer.cpp"]
    assert lib is _build.load("ringbuffer")
    assert "g++" in path.with_suffix(".log").read_text().split("\n")[0]


def test_dumper_window_dedup_and_bytes(tmp_path):
    """tests/test_runtime.py's dumper case on the port's ring, and the
    JAX package's dumper over a JAX ring of the same slots: the same
    seconds, sizes and file names, and byte-equal files holding the
    slots' bytes."""
    base = 1_700_000_000.0
    slots = [np.random.default_rng(i).integers(0, 256, 1024, np.uint8)
             for i in range(6)]
    trigs = [(base + 1.5, base + 3.2, 2.0), (base + 1.5, base + 3.2, 2.0),
             (base + 3.5, base + 4.2, 4.0)]
    recs = {}
    for pkg, ring_cls, dumper_cls, trig_cls in (
            ("port", RingBuffer, TriggeredDumper, Trigger),
            ("jax", JRing, JDumper, JTrigger)):
        with ring_cls(_name(f"dump{pkg}"), bufsz=1024, nbufs=8,
                      create=True) as rb:
            for i, s in enumerate(slots):
                rb.write(s, timestamp=base + i)
            d = dumper_cls(rb, str(tmp_path / pkg), station_id=3)
            recs[pkg] = [d.dump(trig_cls(t0=t0, t1=t1, sn=10, dm=80,
                                         width=0.01, peak_time=pk))
                         for t0, t1, pk in trigs]
    first, again, later = recs["port"]
    assert first.seconds == [int(base + 1), int(base + 2), int(base + 3)]
    assert first.nbytes == 3 * 1024 and "_ea03_" in first.path
    assert again is None                       # deduplicated
    assert later.seconds == [int(base + 4)]    # only the new second
    with open(first.path, "rb") as fp:
        assert fp.read() == b"".join(s.tobytes() for s in slots[1:4])
    for a, b in zip(recs["port"], recs["jax"]):
        assert (a is None) == (b is None)
        if a is None:
            continue
        assert (a.seconds, a.nbytes, a.t0, a.t1) == \
            (b.seconds, b.nbytes, b.t0, b.t1)
        assert os.path.basename(a.path) == os.path.basename(b.path)
        with open(a.path, "rb") as fa, open(b.path, "rb") as fb:
            assert fa.read() == fb.read()
