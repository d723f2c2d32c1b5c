"""The port's station daemon against the JAX package's, on the CPU, at
tests/test_station_daemon.py's tiny geometry (1 MHz, 0.5 MHz of band):
a file: observation's shipped candidate batches, their UTC rebasing
across stations whose capture locked one second apart, the trigger
dumps, the deferred START after a STOP, QUIT leaving no ring, the
observation summary, and one live observation over loopback UDP.

Bar for candidates: tests/test_torch_pipeline.py's (those clear of the
threshold by 0.5 have equal DM index, peak index and width, S/N within
rtol 1e-3); batches keyed by the same UTC; dumps byte-equal to the
file's seconds.  Every socket binds port 0; the JAX package's daemons
use station ids no JAX test uses (its ring names are fixed).
"""

import glob
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from vlite_fast_tpu.config import PipelineConfig, SearchConfig
from vlite_fast_tpu.models import synthesis
from vlite_fast_tpu.runtime.capture import replay_file as jreplay
from vlite_fast_tpu.runtime.control import ObservationDocument as JDoc
from vlite_fast_tpu.runtime.station_main import StationDaemon as JDaemon
from vlite_fast_tpu_torch import config as tconfig
from vlite_fast_tpu_torch import constants as C
from vlite_fast_tpu_torch.runtime import capture as tcap
from vlite_fast_tpu_torch.runtime import control as tctl
from vlite_fast_tpu_torch.runtime import pipeline as tpipe
from vlite_fast_tpu_torch.runtime.station_main import StationDaemon as TDaemon
from vlite_fast_tpu_torch.runtime.trigger import Trigger, TriggerSender
from vlite_fast_tpu_torch.utils import spans
from vlite_fast_tpu_torch.utils import vdif as tvdif

torch.set_num_threads(1)
CFG = dict(freq_top_mhz=320.5, bandwidth_mhz=0.5)
SCFG = dict(dm_min=0.0, dm_max=600.0, ndm=60, gulp_samps=256,
            boxcar_max=16, zap_ranges=(), snr_thresh=6.0)


@pytest.fixture(scope="module")
def synth_vdif(tmp_path_factory):
    d = tmp_path_factory.mktemp("vdif")
    cfg = synthesis.SynthConfig(
        tobs=2.0, dm=300.0, pulse_period=0.05, skip_period=16, amp=0.4,
        seed=21, sample_rate=1_000_000, freq_bot_mhz=320.0,
        bandwidth_mhz=0.5, buflen=250_000)
    stream, _ = synthesis.generate_vdif(cfg, ref_epoch=40,
                                        start_second=1000, station_id=7)
    path = d / "obs.vdif"
    stream.tofile(path)
    return str(path)


class _FakeCandClient:
    def __init__(self):
        self.batches = []

    def send(self, utc, beam, cands):
        self.batches.append((utc, beam, list(cands)))


def _daemon(pkg, sid, out, gulp=256, **kw):
    kw = {"command_port": None, "coincidencer": None, "trigger_port": None,
          **kw}
    scfg = dict(SCFG, gulp_samps=gulp)
    if pkg == "jax":
        return JDaemon(sid, PipelineConfig.tiny(**CFG), SearchConfig(**scfg),
                       out, **kw)
    return TDaemon(sid, tconfig.PipelineConfig.tiny(**CFG),
                   tconfig.SearchConfig(**scfg), out, device="cpu", **kw)


def _secs(path):
    return [(s, b) for s, b, _ in jreplay(path, sample_rate=1_000_000)]


def _clear(batches):
    clear = SCFG["snr_thresh"] + 0.5
    return sorted((c.dmi, c.peak_idx, c.tfilt, c.snr)
                  for _, _, cs in batches for c in cs if c.snr > clear)


def _assert_same_candidates(got, want):
    assert [(u, b) for u, b, _ in got] == [(u, b) for u, b, _ in want]
    g, w = _clear(got), _clear(want)
    assert [c[:3] for c in g] == [c[:3] for c in w]
    np.testing.assert_allclose([c[3] for c in g], [c[3] for c in w],
                               rtol=1e-3)


@pytest.mark.parametrize("start_time", [0.0, "data"])
def test_shipped_candidates_match_jax(synth_vdif, tmp_path, start_time):
    """The batches each daemon ships per gulp, from an observation
    document without a usable epoch (the data's own start) and with the
    data's start: the same UTC key, beam and candidates.  The JAX
    daemon's station starts from the port's first bandpass
    (jax_seeded)."""
    from jax_seeded import seeded
    secs = _secs(synth_vdif)
    t0 = secs[0][0] if start_time == "data" else start_time
    out = {}
    for pkg, sid, doc in (("jax", 41, JDoc), ("torch", 41, tctl.ObservationDocument)):
        d = _daemon(pkg, sid, str(tmp_path / pkg))
        d.cands = fake = _FakeCandClient()
        try:
            with seeded():
                prod = d.run_observation(iter(secs), doc(
                    name="p", scan_no=2, start_time=t0))
        finally:
            d.shutdown()
        assert prod.seconds == 2 and len(fake.batches) >= 2
        out[pkg] = fake.batches
    assert _clear(out["jax"])
    _assert_same_candidates(out["torch"], out["jax"])
    assert {u for u, _, _ in out["torch"]} == {f"{secs[0][0]:.0f}"}


def test_candidate_utc_rebase_across_skewed_stations(synth_vdif, tmp_path):
    """Station 2's capture locks one second late: both packages key its
    batches by the observation's UTC and rebase its indices alike.  The
    JAX daemon's gulp search runs at each gulp's own length, as the
    port's (jax_true_length: the last gulp is short), and its station
    starts from the port's first bandpass (jax_seeded)."""
    from jax_seeded import seeded
    from jax_true_length import true_length
    secs = _secs(synth_vdif)
    out = {}
    for pkg, doc in (("jax", JDoc), ("torch", tctl.ObservationDocument)):
        for sid, ss in ((42, secs), (43, secs[1:])):
            d = _daemon(pkg, sid, str(tmp_path / f"{pkg}{sid}"), gulp=512)
            d.cands = fake = _FakeCandClient()
            try:
                with true_length(), seeded():
                    d.run_observation(iter(ss), doc(
                        name="p", scan_no=2, start_time=secs[0][0]))
            finally:
                d.shutdown()
            out[pkg, sid] = fake.batches
    for sid in (42, 43):
        assert out["jax", sid]
        _assert_same_candidates(out["torch", sid], out["jax", sid])
    utcs = {u for sid in (42, 43) for u, _, _ in out["torch", sid]}
    assert len(utcs) == 1
    late = max((c for _, _, cs in out["torch", 43] for c in cs),
               key=lambda c: c.snr)
    assert late.i0 >= round(1.0 / tconfig.PipelineConfig.tiny(**CFG).tsamp) \
        // 2


def _wait(pred, timeout=30.0):
    deadline = time.time() + timeout
    while not pred() and time.time() < deadline:
        time.sleep(0.05)
    return pred()


def test_trigger_dumps_byte_equal(synth_vdif, tmp_path):
    """A trigger over UDP to the port's daemon dumps the ring's seconds:
    byte-equal to the file's seconds and to the JAX daemon's dump of the
    same trigger."""
    secs = _secs(synth_vdif)
    trig = Trigger(t0=secs[0][0] + 0.5, t1=secs[1][0] + 0.2, sn=12.0,
                   dm=300.0, width=1e-3, peak_time=0.6, meta="test")
    d = _daemon("torch", 44, str(tmp_path / "torch"), trigger_port=0)
    j = _daemon("jax", 44, str(tmp_path / "jax"))
    try:
        for dm in (d, j):
            dm.run_observation(iter(secs), tctl.ObservationDocument(
                name="p", scan_no=2))
        tx = TriggerSender([("127.0.0.1",
                             d.trig_rx._sock.getsockname()[1])])
        tx.send(trig)
        tx.close()
        dump_dir = tmp_path / "torch" / "dumps"
        sec_bytes = 2 * 1_000_000
        assert _wait(lambda: any(os.path.getsize(p) == 2 * sec_bytes for p in
                                 glob.glob(str(dump_dir / "*.vdif"))))
        time.sleep(0.2)
        [path] = glob.glob(str(dump_dir / "*.vdif"))
        got = open(path, "rb").read()
        assert got == b"".join(b.tobytes() for _, b in secs)
        rec = j.dumper.dump(trig)
        assert rec is not None and open(rec.path, "rb").read() == got
        assert os.path.basename(rec.path) == os.path.basename(path)
    finally:
        d.shutdown()
        j.shutdown()


def test_deferred_start_after_stop_batch(synth_vdif, tmp_path):
    """A START deferred from a STOP's command batch runs its observation,
    which ends with the summary line's readings."""
    d = _daemon("torch", 45, str(tmp_path))
    d._pending_cmds = [(tctl.Command.START, tctl.ObservationDocument(
        name="scan2", scan_no=3, start_time=0.0))]
    try:
        d.serve(f"file:{synth_vdif}", poll_s=0.01, max_observations=1)
    finally:
        d.shutdown()
    assert glob.glob(str(tmp_path / "*.fil"))
    s = d.summary
    assert s["station"] == 45 and s["name"] == "scan2" and s["seconds"] == 2
    assert s["launches"] == {} and s["peak_device_gib"] is None
    assert s["wall_s"] > 0 and "capture" not in s
    assert set(s["host_ms_median"]) == set(s["host_ms_max"]) == \
        set(tpipe.HOST_PARTS)
    assert all(0 <= s["host_ms_median"][k] <= s["host_ms_max"][k]
               for k in tpipe.HOST_PARTS)
    assert s["candidates"] > 0 and s["fil"].endswith(".fil")
    g = s["gulp"]
    assert g["gulps"] >= 1 and g["cluster_rows_mean"] >= 0
    assert 0 < g["latency_ms_p50"] <= g["latency_ms_p95"]
    assert set(g["parts_ms_mean"]) == set(spans.GULP_PARTS)


def test_quit_leaves_no_ring(synth_vdif, tmp_path):
    """Over the command bus: START runs a file: observation, QUIT ends the
    daemon, and its shared-memory ring is gone."""
    bus = tctl.CommandBus(port=0)
    port = bus._server.getsockname()[1]
    d = _daemon("torch", 46, str(tmp_path), command_port=port)
    shm = "/dev/shm" + d.pipeline.ring.name
    assert os.path.exists(shm)
    th = threading.Thread(target=d.serve, args=(f"file:{synth_vdif}",),
                          kwargs=dict(poll_s=0.02), daemon=True)
    th.start()
    try:
        assert _wait(lambda: bus._clients, 10)
        bus.publish(tctl.Command.START, tctl.ObservationDocument(
            name="q", scan_no=2))
        assert _wait(lambda: d.summary is not None, 60)
        bus.publish(tctl.Command.QUIT)
        th.join(timeout=30)
        assert not th.is_alive()
    finally:
        bus.close()
        d.shutdown()
    assert d.summary["seconds"] == 2
    assert not os.path.exists(shm)


def _free_udp_port():
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("0.0.0.0", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _bound(port):
    """Whether some socket holds UDP `port` (the daemon's capture)."""
    want = f":{port:04X} "
    with open("/proc/net/udp") as fp:
        return any(line.split()[1].endswith(want[:-1])
                   for line in list(fp)[1:])


def test_live_udp_observation(tmp_path, monkeypatch):
    """A live udp: observation on loopback: FAKE_START, frames stamped with
    the wall clock's seconds and sent at their rate, FAKE_STOP once two
    seconds are in (the daemon reads commands between seconds).  It
    assembles whole seconds, reports the capture's counters in its
    summary and does not abort.  (The test turns the assembler's
    wall-clock check off: a loaded test machine may process a second
    late; the assembler's own test holds the check.)"""
    rate = 1_000_000
    fps = rate // C.VDIF_DATA_BYTES
    rng = np.random.default_rng(3)
    samples = np.clip(rng.standard_normal((2, 5 * rate)) / 0.05914 + 128.5,
                      0, 255).astype(np.uint8)
    bus = tctl.CommandBus(port=0)
    port = _free_udp_port()
    monkeypatch.setattr(tcap.SecondAssembler, "_check_wallclock",
                        lambda self, seconds: None)
    d = _daemon("torch", 47, str(tmp_path),
                command_port=bus._server.getsockname()[1])
    th = threading.Thread(target=d.serve, args=(f"udp:{port}",),
                          kwargs=dict(poll_s=0.02), daemon=True)
    th.start()
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def send(frames, t_first):
        for i in range(0, len(frames), 20):
            ahead = t_first + i / (2 * fps) - time.time()
            if ahead > 0:
                time.sleep(ahead)
            for f in frames[i:i + 20]:
                tx.sendto(f.tobytes(), ("127.0.0.1", port))
    try:
        assert _wait(lambda: bus._clients, 10)
        bus.publish(tctl.Command.FAKE_START, tctl.ObservationDocument(
            name="LIVE", scan_no=2))
        assert _wait(lambda: _bound(port), 30)
        now = time.time()
        epoch = tvdif.default_ref_epoch(now)
        first = int(now) + 1
        frames = tvdif.streams_to_frames(
            samples, epoch, first - int(tvdif._epoch_unix(epoch)),
            sample_rate=rate).reshape(-1, C.VDIF_FRAME_BYTES)
        sender = threading.Thread(target=send, args=(frames, first),
                                  daemon=True)
        sender.start()
        assert _wait(lambda: d._capture is not None
                     and d._capture.asm.stats.seconds >= 2, 30)
        bus.publish(tctl.Command.FAKE_STOP)
        assert _wait(lambda: d.summary is not None, 60)
        sender.join(timeout=30)
        bus.publish(tctl.Command.QUIT)
        th.join(timeout=30)
        assert not th.is_alive()
    finally:
        tx.close()
        bus.close()
        d.shutdown()
    s = d.summary
    cap = s["capture"]
    assert s["name"] == "LIVE" and cap["abort_reason"] is None
    assert cap["rcvbuf"] > 0
    assert s["seconds"] >= 2 and cap["seconds"] >= s["seconds"]
    assert cap["frames"] + cap["skipped"] >= 2 * fps * s["seconds"]


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_live_second_longer_than_100_polls(tmp_path, monkeypatch, pkg):
    """A second that takes more than 100 polls to assemble (as one of the
    reference rate does: 200 polls of 256 frames): the port's daemon
    counts only polls that heard nothing as silence and yields it; the
    JAX package's daemon counts every poll that completed no second and
    ends the observation first (a fault of the reference, fixed in the
    port)."""
    from vlite_fast_tpu.runtime import capture as jcap
    rate = 1_000_000
    mod = tcap if pkg == "torch" else jcap
    poll = mod.UDPCapture.poll
    monkeypatch.setattr(mod.UDPCapture, "poll",
                        lambda self, max_frames=2: poll(self, 2))
    if pkg == "torch":
        monkeypatch.setattr(tcap.SecondAssembler, "_check_wallclock",
                            lambda self, seconds: None)
    d = _daemon(pkg, 49, str(tmp_path))
    port = _free_udp_port()
    got = []
    th = threading.Thread(target=lambda: got.extend(
        d._live_seconds(f"udp:{port}")), daemon=True)
    th.start()
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        assert _wait(lambda: _bound(port), 10)
        now = time.time()
        epoch = tvdif.default_ref_epoch(now)
        samples = np.random.default_rng(8).integers(
            1, 255, (2, 3 * rate), dtype=np.uint8)
        frames = tvdif.streams_to_frames(
            samples, epoch, int(now) - int(tvdif._epoch_unix(epoch)),
            sample_rate=rate).reshape(-1, C.VDIF_FRAME_BYTES)
        for i in range(0, len(frames), 50):
            for f in frames[i:i + 50]:
                tx.sendto(f.tobytes(), ("127.0.0.1", port))
            time.sleep(0.005)
        if pkg == "torch":
            assert _wait(lambda: len(got) >= 2, 30)
            d._stop.set()
        th.join(timeout=60)
        assert not th.is_alive()
    finally:
        tx.close()
        d.shutdown()
    if pkg == "torch":
        assert [b.tobytes() for _, b in got[:2]] == \
            [samples[:, k * rate:(k + 1) * rate].tobytes() for k in (0, 1)]
    else:
        assert got == []


def test_daemon_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TDaemon(48, tconfig.PipelineConfig.tiny(), tconfig.SearchConfig.tiny(),
                str(tmp_path), command_port=None, coincidencer=None,
                trigger_port=None)
    from vlite_fast_tpu_torch.runtime import station_main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        station_main.main(["--station", "48", "--tiny", "--command-port",
                           "0", "--out-dir", str(tmp_path)])
