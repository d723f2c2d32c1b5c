"""The port's capture plane against the JAX package's, on the CPU:
utils/vdif framing byte for byte, the SecondAssembler's seconds and fault
counters on the writer's fault cases (gaps, the start rule, the
escalating abort, clock skew, reordering, duplicates), replay_file, and
the port's own csrc/netcap.cpp over loopback (udp_drain and udp_blast),
which must build: a helper that does not build raises.

Bar: byte-equal frames, headers and seconds; CaptureStats field for field
(the clock skew, read from the wall clock at different instants by the two
assemblers, within 1 s of each other).  Every socket binds port 0.
"""

import dataclasses
import socket
import time

import numpy as np
import pytest

from vlite_fast_tpu.runtime import capture as jcap
from vlite_fast_tpu.utils import vdif as jvdif
from vlite_fast_tpu_torch import _build
from vlite_fast_tpu_torch import constants as C
from vlite_fast_tpu_torch.runtime import capture as tcap
from vlite_fast_tpu_torch.utils import vdif as tvdif

RATE = 1_000_000          # 200 frames a second a pol
FB = C.VDIF_FRAME_BYTES


def _samples(nsec, rate=RATE, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 255, (2, nsec * rate), dtype=np.uint8)


def _stream(nsec=2, rate=RATE, start_second=100, seed=0):
    return tvdif.streams_to_frames(_samples(nsec, rate, seed), ref_epoch=10,
                                   start_second=start_second,
                                   sample_rate=rate)


@pytest.mark.parametrize("seed,rate,start,station,frame0", [
    (0, RATE, 100, 0, 0), (1, 50_000, 7, 3, 2), (2, 2 * RATE, 2 ** 29, 7, 0)])
def test_vdif_framing_byte_equal(seed, rate, start, station, frame0):
    samples = _samples(2, rate, seed)
    kw = dict(ref_epoch=40, start_second=start, start_frame=frame0,
              station_id=station, sample_rate=rate)
    got = tvdif.streams_to_frames(samples, **kw)
    want = jvdif.streams_to_frames(samples, **kw)
    assert got.tobytes() == want.tobytes()
    frames = got.reshape(-1, FB)
    tf = tvdif.parse_headers(frames[:, :C.VDIF_HEADER_BYTES])
    jf = jvdif.parse_headers(frames[:, :C.VDIF_HEADER_BYTES])
    assert sorted(tf) == sorted(jf)
    for k in jf:
        np.testing.assert_array_equal(tf[k], jf[k], err_msg=k)
    np.testing.assert_array_equal(tvdif.unix_times(tf), jvdif.unix_times(jf))
    np.testing.assert_array_equal(
        tvdif.frame_index(tf["seconds"], tf["frame"], tf["thread_id"]),
        jvdif.frame_index(jf["seconds"], jf["frame"], jf["thread_id"]))
    ts, to = tvdif.frames_to_streams(got)
    js, jo = jvdif.frames_to_streams(got)
    assert ts.tobytes() == js.tobytes()
    assert dataclasses.asdict(to) == dataclasses.asdict(jo)
    tp = tvdif.frames_to_streams_placed(got, rate)
    jp = jvdif.frames_to_streams_placed(got, rate)
    assert tp[0].tobytes() == jp[0].tobytes() and tp[1:] == jp[1:]
    # one header through the scalar wrapper, and its arithmetic
    h = dict(seconds=int(tf["seconds"][5]), frame=int(tf["frame"][5]),
             ref_epoch=40, thread_id=int(tf["thread_id"][5]),
             station_id=station)
    th, jh = tvdif.VDIFHeader(**h), jvdif.VDIFHeader(**h)
    assert th.pack() == jh.pack()
    assert dataclasses.asdict(tvdif.VDIFHeader.parse(jh.pack())) == \
        dataclasses.asdict(jvdif.VDIFHeader.parse(jh.pack()))
    assert th.unix_time == jh.unix_time
    assert dataclasses.asdict(tvdif.increment_header(th)) == \
        dataclasses.asdict(jvdif.increment_header(jh))
    assert tvdif.frame_difference(th, tvdif.increment_header(th)) == \
        jvdif.frame_difference(jh, jvdif.increment_header(jh))
    assert tvdif.default_ref_epoch(1.7e9) == jvdif.default_ref_epoch(1.7e9)


def _drop(stream, idx):
    frames = stream.reshape(-1, FB)
    keep = np.ones(len(frames), bool)
    keep[list(idx)] = False
    return frames[keep].reshape(-1)


def _swap(stream, pairs):
    frames = stream.reshape(-1, FB).copy()
    for a, b in pairs:
        frames[[a, b]] = frames[[b, a]]
    return frames.reshape(-1)


def _dup(stream, at, corrupt):
    """Frame `at` sent twice, the second copy corrupted when asked."""
    frames = stream.reshape(-1, FB)
    extra = frames[at].copy()
    if corrupt:
        extra[C.VDIF_HEADER_BYTES:] = 0
    return np.concatenate([frames[:at + 3], extra[None],
                           frames[at + 3:]]).reshape(-1)


# name -> (byte stream, assembler keyword arguments, stats overrides)
CASES = {
    "clean": lambda s: (s, {}, {}),
    "gap": lambda s: (_drop(s, [50, 51, 52]), {}, {}),
    "start_rule": lambda s: (s[FB:], {}, {}),
    "escalating_abort": lambda s: (_drop(s, range(10, 160)), {},
                                   dict(skip_abort=100)),
    "anomaly_warn": lambda s: (_drop(s, range(10, 1200, 2)), {},
                               dict(skip_warn=10)),
    "clock_skew": lambda s: (s, dict(wallclock_check=True), {}),
    "reordered": lambda s: (_swap(s, [(30, 31), (100, 103), (398, 401)]),
                            {}, {}),
    "duplicate": lambda s: (_dup(s, 40, corrupt=True), {}, {}),
    "rewind": lambda s: (np.concatenate([s, s[:20 * FB]]), {}, {}),
}


def _assemble(mod, case, chunk_frames):
    stream, kw, over = CASES[case](_stream(nsec=3))
    asm = mod.SecondAssembler(sample_rate=RATE, **kw)
    for k, v in over.items():
        setattr(asm.stats, k, v)
    done = []
    for off in range(0, stream.size, chunk_frames * FB):
        done += asm.feed_stream(stream[off:off + chunk_frames * FB])
    done += asm.flush()
    return done, asm


@pytest.mark.parametrize("chunk_frames", [64, 4096])
@pytest.mark.parametrize("case", sorted(CASES))
def test_assembler_matches_jax(case, chunk_frames):
    got, tasm = _assemble(tcap, case, chunk_frames)
    want, jasm = _assemble(jcap, case, chunk_frames)
    assert [s for s, _ in got] == [s for s, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a.tobytes() == b.tobytes()
    ts, js = dataclasses.asdict(tasm.stats), dataclasses.asdict(jasm.stats)
    assert abs(ts.pop("clock_skew_s") - js.pop("clock_skew_s")) < 1.0
    assert ts == js
    assert (tasm.stats.abort_reason() is None) == \
        (jasm.stats.abort_reason() is None)
    assert (tasm._started, tasm.ref_epoch) == (jasm._started, jasm.ref_epoch)
    if case == "clock_skew":
        assert "wall clock" in tasm.stats.abort_reason()
    if case == "escalating_abort":
        assert "skipped" in tasm.stats.abort_reason()
    if case == "start_rule":
        assert [s for s, _ in got] == [101, 102]


def test_assembler_scalar_feed_matches_jax():
    """The per-frame feed() path on frames 5, 7, 6 order (pol threads
    swapped) and a duplicate: the same seconds and counters."""
    rate = 50_000
    fps = rate // C.VDIF_DATA_BYTES
    order = [(0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (3, 0), (2, 1), (3, 1),
             (3, 1)]
    order += [(f, th) for f in range(4, fps) for th in (0, 1)]
    order += [(0, 0)]
    out = []
    for mod in (tcap, jcap):
        asm = mod.SecondAssembler(sample_rate=rate)
        done = []
        for k, (f, th) in enumerate(order):
            val = np.full(C.VDIF_DATA_BYTES, (10 * f + th + k) % 251, np.uint8)
            done += asm.feed(8 + (k == len(order) - 1), f, th, val)
        out.append((done, dataclasses.asdict(asm.stats)))
    (td, ts), (jd, js) = out
    assert ts == js and ts["anomalous"] == 1 and ts["skipped"] == 0
    assert [(s, b.tobytes()) for s, b in td] == \
        [(s, b.tobytes()) for s, b in jd]


def test_to_unix_matches_jax():
    for epoch, sec in ((0, 0), (10, 100), (40, 12345678), (51, 2 ** 29)):
        assert tcap.to_unix(sec, epoch) == jcap.to_unix(sec, epoch)


@pytest.mark.parametrize("chunk_frames", [37, 4096])
def test_replay_file_matches_jax(tmp_path, chunk_frames):
    stream = _drop(_stream(nsec=3, seed=4), [7, 300])
    path = tmp_path / "obs.vdif"
    stream.tofile(path)
    got = list(tcap.replay_file(str(path), chunk_frames=chunk_frames,
                                sample_rate=RATE))
    want = list(jcap.replay_file(str(path), chunk_frames=chunk_frames,
                                 sample_rate=RATE))
    assert len(got) == len(want) == 3
    for (ts, tb, te), (js, jb, je) in zip(got, want):
        assert (ts, te) == (js, je) and tb.tobytes() == jb.tobytes()


def test_netcap_is_the_ports_own_gxx_library():
    lib = tcap.netcap_lib()
    assert lib is tcap.netcap_lib()
    assert _build.sources("netcap") == [_build.CSRC / "netcap.cpp"]
    path = _build.lib_path("netcap")
    assert path.exists()
    assert "g++" in path.with_suffix(".log").read_text().split("\n")[0]
    for fn in ("udp_drain", "raw_drain", "udp_blast"):
        assert getattr(lib, fn).restype is not None


def test_netcap_build_failure_raises(monkeypatch):
    """No fallback to a recvfrom loop: a helper that does not build ends
    the capture before a socket is opened."""
    def broken(name):
        raise RuntimeError(f"g++ failed for {name}.cpp")
    monkeypatch.setattr(tcap, "_netcap", None)
    monkeypatch.setattr(tcap._build, "load", broken)
    with pytest.raises(RuntimeError, match="netcap"):
        tcap.UDPCapture(port=0, sample_rate=RATE)
    with pytest.raises(RuntimeError, match="netcap"):
        tcap.open_capture("udp:0", sample_rate=RATE)


def test_udp_drain_over_loopback():
    """recvmmsg through the port's helper: the frames land in order, a
    short datagram is counted anomalous, dropped frames count as skipped,
    and the assembled second equals the sent samples outside the gap."""
    samples = _samples(1, seed=5)
    stream = tvdif.streams_to_frames(samples, ref_epoch=10, start_second=100,
                                     sample_rate=RATE)
    frames = _drop(stream, [40, 41]).reshape(-1, FB)
    rx = tcap.UDPCapture(port=0, sample_rate=RATE, batch=512)
    port = rx.sock.getsockname()[1]
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    done = []
    try:
        for i in range(0, len(frames), 16):
            for f in frames[i:i + 16]:
                tx.sendto(f.tobytes(), ("127.0.0.1", port))
            if i == 0:
                tx.sendto(b"x" * 100, ("127.0.0.1", port))
            done += rx.poll(max_frames=512)
        deadline = time.time() + 5.0
        while rx.asm.stats.frames < len(frames) and time.time() < deadline:
            done += rx.poll(max_frames=512)
        done += [(tcap.to_unix(s, rx.asm.ref_epoch), b)
                 for s, b in rx.asm.flush()]
    finally:
        tx.close()
        rx.close()
    st = rx.asm.stats
    assert st.frames == len(frames) and st.skipped == 2
    assert st.anomalous == 1
    assert len(done) == 1 and done[0][0] == tcap.to_unix(100, 10)
    gap = np.zeros_like(samples, bool)
    gap[0, 20 * C.VDIF_DATA_BYTES:21 * C.VDIF_DATA_BYTES] = True
    gap[1, 20 * C.VDIF_DATA_BYTES:21 * C.VDIF_DATA_BYTES] = True
    assert np.all(done[0][1][gap] == 0)
    np.testing.assert_array_equal(done[0][1][~gap], samples[~gap])


def test_udp_blast_to_udp_drain():
    """The port's sendmmsg sender into its recvmmsg receiver: two whole
    seconds byte-equal, in bursts the receive buffer holds."""
    import ctypes
    samples = _samples(2, seed=6)
    stream = tvdif.streams_to_frames(samples, ref_epoch=10, start_second=50,
                                     sample_rate=RATE)
    frames = stream.reshape(-1, FB)
    lib = tcap.netcap_lib()
    rx = tcap.UDPCapture(port=0, sample_rate=RATE, batch=256)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    tx.connect(("127.0.0.1", rx.sock.getsockname()[1]))
    done, sent = [], 0
    try:
        while sent < len(frames):
            k = lib.udp_blast(tx.fileno(),
                              frames[sent:].ctypes.data_as(ctypes.c_void_p),
                              FB, min(16, len(frames) - sent))
            assert k > 0
            sent += k
            done += rx.poll(max_frames=256)
        deadline = time.time() + 5.0
        while rx.asm.stats.frames < len(frames) and time.time() < deadline:
            done += rx.poll(max_frames=256)
        done += [(tcap.to_unix(s, rx.asm.ref_epoch), b)
                 for s, b in rx.asm.flush()]
    finally:
        tx.close()
        rx.close()
    assert rx.asm.stats.frames == len(frames)
    assert rx.asm.stats.skipped == rx.asm.stats.anomalous == 0
    assert [s for s, _ in done] == [tcap.to_unix(50 + k, 10) for k in (0, 1)]
    for k, (_, buf) in enumerate(done):
        np.testing.assert_array_equal(buf, samples[:, k * RATE:(k + 1) * RATE])


def test_raw_capture_loopback():
    """AF_PACKET capture through the port's raw_drain (needs CAP_NET_RAW,
    as the JAX package's test does)."""
    sink = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sink.bind(("127.0.0.1", 0))
    port = sink.getsockname()[1]
    try:
        rx = tcap.RawCapture(iface="lo", port=port, sample_rate=RATE,
                             batch=512)
    except (PermissionError, OSError) as e:
        sink.close()
        pytest.skip(f"AF_PACKET unavailable: {e}")
    samples = _samples(2, seed=7)
    frames = tvdif.streams_to_frames(samples, ref_epoch=10, start_second=100,
                                     sample_rate=RATE).reshape(-1, FB)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    done = []
    try:
        for i in range(0, len(frames), 64):
            for f in frames[i:i + 64]:
                tx.sendto(f.tobytes(), ("127.0.0.1", port))
            if i == 0:
                tx.sendto(b"x" * 100, ("127.0.0.1", port))
            done += rx.poll(max_frames=512)
        deadline = time.time() + 3.0
        while rx.asm.stats.frames < len(frames) and time.time() < deadline:
            done += rx.poll(max_frames=512)
        done += [(tcap.to_unix(s, rx.asm.ref_epoch), b)
                 for s, b in rx.asm.flush()]
    finally:
        tx.close()
        rx.close()
        sink.close()
    assert rx.asm.stats.frames == len(frames)
    assert rx.asm.stats.anomalous == 1
    np.testing.assert_array_equal(done[0][1], samples[:, :RATE])


def test_open_capture_transport_switch():
    rx = tcap.open_capture("udp:0", sample_rate=RATE)
    assert isinstance(rx, tcap.UDPCapture) and rx.rcvbuf > 0
    rx.close()
    with pytest.raises(ValueError):
        tcap.open_capture("carrier-pigeon:1")
