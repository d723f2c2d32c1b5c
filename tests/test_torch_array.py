"""The port's array path (StationPipeline's ring and block taps,
CoaddSearcher, ArrayPipeline) against the JAX package's, on the CPU.

The JAX side's gulp search runs at each gulp's own length, as the port's
does (tests/jax_true_length.py; the JAX package as shipped pads a
stream's last gulp, tests/test_torch_pipeline.py pins that departure),
and its stations start from the port's first bandpass
(tests/jax_seeded.py; the JAX package as shipped seeds it from the first
segment's tile).

- ArrayPipeline.run_streaming with two antennas on the verify recipe's
  synthesized DM-300 pulse, rings on: per-beam and coadd candidates
  equal under the clear-threshold rule of tests/test_torch_pipeline.py
  (S/N > snr_thresh + 0.5: equal DM index, peak index and width, S/N
  within rtol 1e-3), triggers equal in t0, t1 and DM, dump files
  byte-equal.
- tests/test_coadd_runtime.py's eight antennas at its own weak amplitude:
  coadd candidates equal under the same rule; no single beam reaches the
  trigger bar, and the coadd raises the trigger.
- CoaddSearcher.tap through a gap, an overlap, ragged blocks and a
  retired station: the float16 coadd stream bit-equal to the JAX
  package's.
- StationPipeline's block taps (equal offsets and bytes), its _kurto.npz
  (equal weights), its ring (the fed bytes, unlinked by close()).
The JAX side's stations take ids (61, 62, ...) that no JAX test uses, so
its rings never share a name with another test's.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from vlite_fast_tpu.config import (AntennaConfig, ArrayConfig,
                                   PipelineConfig, SearchConfig,
                                   TriggerConfig)
from vlite_fast_tpu.models import synthesis
from vlite_fast_tpu.runtime.control import ObservationDocument as JDoc
from vlite_fast_tpu.runtime.pipeline import ArrayPipeline as JArray
from vlite_fast_tpu.runtime.pipeline import CoaddSearcher as JCoadd
from vlite_fast_tpu.runtime.pipeline import StationPipeline as JPipe
from vlite_fast_tpu_torch import config as tconfig
from vlite_fast_tpu_torch.runtime.pipeline import COADD_BEAM
from vlite_fast_tpu_torch.runtime.pipeline import ArrayPipeline as TArray
from vlite_fast_tpu_torch.runtime.pipeline import CoaddSearcher as TCoadd
from vlite_fast_tpu_torch.runtime.pipeline import ObservationDocument as TDoc
from vlite_fast_tpu_torch.runtime.pipeline import StationPipeline as TPipe
from vlite_fast_tpu_torch.runtime.ring import FLAG_OBS_START

torch.set_num_threads(1)


def _t(cfg):
    """The port's config of the same class and fields as a JAX package
    one (an ArrayConfig's nested configs too)."""
    if isinstance(cfg, ArrayConfig):
        return tconfig.ArrayConfig(**{
            **dataclasses.asdict(cfg),
            "antennas": tuple(_t(a) for a in cfg.antennas),
            "pipeline": _t(cfg.pipeline), "search": _t(cfg.search),
            "trigger": _t(cfg.trigger)})
    return getattr(tconfig, type(cfg).__name__)(**dataclasses.asdict(cfg))


def _clear(cands, thresh):
    return sorted((c for c in cands if c.snr > thresh + 0.5),
                  key=lambda c: (c.peak_idx, c.dmi))


def _assert_same_candidates(got, want, thresh):
    ct, cj = _clear(got, thresh), _clear(want, thresh)
    assert cj
    assert [(c.dmi, c.peak_idx, c.tfilt) for c in ct] == \
        [(c.dmi, c.peak_idx, c.tfilt) for c in cj]
    np.testing.assert_allclose([c.snr for c in ct], [c.snr for c in cj],
                               rtol=1e-3)


def _run_both(tmp, acfg, method, seconds, **kw):
    """(JAX result, port result) of ArrayPipeline.<method> on the same
    seconds, each pipeline closed after its run.  The JAX package's gulp
    search runs at each gulp's own length (jax_true_length), as the
    port's does: the stations' and the coadd's last gulps are short, and
    the JAX package as shipped pads them.  Its stations start from the
    port's seed (jax_seeded)."""
    from jax_seeded import seeded
    from jax_true_length import true_length
    out = []
    for pkg, cls, doc in (("jax", JArray, JDoc), ("port", TArray, TDoc)):
        extra = {} if pkg == "jax" else {"device": "cpu"}
        ap = cls(acfg if pkg == "jax" else _t(acfg),
                 out_dir=str(tmp / pkg), **kw, **extra)
        try:
            od = doc(name="ARRAY", ra=1.0, dec=0.5, scan_no=2,
                     start_time=1.7e9)
            per_ant = {sid: list(secs) for sid, secs in seconds.items()}
            with true_length(), seeded():
                out.append(getattr(ap, method)(per_ant, od))
        finally:
            ap.close()
    return out


# --- two antennas, DM 300, rings on, streaming ------------------------------

DM = 300.0


@pytest.fixture(scope="module")
def streaming(tmp_path_factory):
    cfg = PipelineConfig.tiny(freq_top_mhz=320.5, bandwidth_mhz=0.5)
    scfg = SearchConfig(dm_min=0, dm_max=600, ndm=61, gulp_samps=512,
                        boxcar_max=16, zap_ranges=(), snr_thresh=6.0)
    acfg = ArrayConfig(antennas=(AntennaConfig(61, "ea61"),
                                 AntennaConfig(62, "ea62")),
                       pipeline=cfg, search=scfg,
                       trigger=TriggerConfig(min_dm=100.0))
    synth = synthesis.SynthConfig(
        tobs=2.0, dm=DM, pulse_period=0.05, skip_period=16, amp=0.4,
        seed=21, sample_rate=cfg.sample_rate, freq_bot_mhz=320.0,
        bandwidth_mhz=0.5, buflen=250_000)
    samples, _ = synthesis.generate_baseband(synth)
    secs = [(1.7e9 + k, samples[:, k * cfg.sample_rate:
                                (k + 1) * cfg.sample_rate])
            for k in range(2)]
    tmp = tmp_path_factory.mktemp("streaming")
    jr, tr = _run_both(tmp, acfg, "run_streaming", {61: secs, 62: secs})
    return scfg, jr, tr


def test_streaming_beam_candidates_match_jax(streaming):
    scfg, jr, tr = streaming
    assert set(tr["products"]) == set(jr["products"]) == {61, 62}
    for sid, prod in tr["products"].items():
        assert prod.seconds == 2 and prod.dropped == 0
        _assert_same_candidates(prod.candidates,
                                jr["products"][sid].candidates,
                                scfg.snr_thresh)
        best = max(prod.candidates, key=lambda c: c.snr)
        assert abs(best.dm - DM) < 25 and best.snr > 15
        assert os.path.getsize(prod.fil_path) == os.path.getsize(
            jr["products"][sid].fil_path)
    _assert_same_candidates(tr["coadd_candidates"], jr["coadd_candidates"],
                            scfg.snr_thresh)


def test_streaming_triggers_match_jax(streaming):
    _, jr, tr = streaming
    assert tr["triggers"]
    assert [(t.t0, t.t1, t.dm) for t in tr["triggers"]] == \
        [(t.t0, t.t1, t.dm) for t in jr["triggers"]]
    assert abs(tr["triggers"][0].dm - DM) < 75
    assert len(tr["trigger_seconds"]) == len(tr["triggers"])


def test_streaming_dumps_byte_equal(streaming):
    _, jr, tr = streaming
    assert len(tr["dumps"]) == len(jr["dumps"]) == 2   # one per beam
    for a, b in zip(tr["dumps"], jr["dumps"]):
        assert (a.seconds, a.nbytes) == (b.seconds, b.nbytes)
        assert os.path.basename(a.path) == os.path.basename(b.path)
        with open(a.path, "rb") as fa, open(b.path, "rb") as fb:
            assert fa.read() == fb.read()


# --- eight antennas, a pulse too weak for any one beam ----------------------

NANT = 8
AMP = 0.088     # tests/test_coadd_runtime.py's: per-antenna peak S/N ~3-5


@pytest.fixture(scope="module")
def weak(tmp_path_factory):
    acfg = ArrayConfig(
        antennas=tuple(AntennaConfig(station_id=61 + i, name=f"ea{61 + i}")
                       for i in range(NANT)),
        pipeline=PipelineConfig.tiny(freq_top_mhz=320.5, bandwidth_mhz=0.5),
        search=SearchConfig(dm_min=0.0, dm_max=600.0, ndm=61,
                            gulp_samps=512, boxcar_max=16, zap_ranges=(),
                            snr_thresh=6.0),
        trigger=TriggerConfig(snr_thresh=7.5, coadd_snr_thresh=7.5,
                              min_beams=2, min_dm=20.0))
    cfg = acfg.pipeline
    per_ant = {}
    for i, a in enumerate(acfg.antennas):
        synth = synthesis.SynthConfig(
            tobs=2.0, dm=DM, pulse_period=0.05, skip_period=16, amp=AMP,
            seed=100 + i, sample_rate=cfg.sample_rate, freq_bot_mhz=320.0,
            bandwidth_mhz=0.5, buflen=250_000)
        samples, _ = synthesis.generate_baseband(synth)
        per_ant[a.station_id] = [
            (1.6e9 + s, samples[:, s * cfg.sample_rate:
                                (s + 1) * cfg.sample_rate])
            for s in range(2)]
    tmp = tmp_path_factory.mktemp("weak")
    jr, tr = _run_both(tmp, acfg, "run_observation", per_ant,
                       keep_rings=False)
    return acfg, jr, tr


def test_weak_pulse_coadd_candidates_match_jax(weak):
    acfg, jr, tr = weak
    _assert_same_candidates(tr["coadd_candidates"], jr["coadd_candidates"],
                            acfg.search.snr_thresh)
    best = max(tr["coadd_candidates"], key=lambda c: c.snr)
    assert best.snr > 7.5 and abs(best.dm - DM) < 100.0


def test_weak_pulse_no_single_beam_trigger(weak):
    _, _, tr = weak
    for sid, prod in tr["products"].items():
        assert all(c.snr < 7.5 for c in prod.candidates), sid


def test_weak_pulse_coadd_raises_the_trigger(weak):
    _, jr, tr = weak
    assert tr["triggers"]
    assert all(f"beam{COADD_BEAM}" in t.meta for t in tr["triggers"])
    assert [(t.t0, t.t1, t.dm) for t in tr["triggers"]] == \
        [(t.t0, t.t1, t.dm) for t in jr["triggers"]]


# --- the coadd's lockstep ---------------------------------------------------

def test_coadd_tap_stream_bit_equal_to_jax():
    """The same taps into both packages' CoaddSearcher: in lockstep, a
    gap, a partial and a full re-delivery, ragged blocks, a retired
    station whose later blocks are dropped.  The float16 coadd stream
    (and what stays pending) is bit-equal."""
    cfg = PipelineConfig.tiny()
    scfg = SearchConfig.tiny(gulp_samps=1 << 20)        # never searches
    row = cfg.nchanout * cfg.nbit // 8
    rng = np.random.default_rng(5)
    blk = lambda n: rng.integers(0, 256, (n, row), dtype=np.uint8)
    taps = [(0, 0, blk(32)), (1, 0, blk(32)), (2, 0, blk(32)),
            (0, 32, blk(32)), (1, 64, blk(32)),     # station 1 skips 32
            (2, 32, blk(32)),
            (2, 48, blk(32)),                       # overlaps by 16
            (2, 0, blk(16)),                        # already consumed
            (0, 64, blk(24)), (1, 96, blk(40)),     # ragged
            (2, 80, blk(8)), (0, 88, blk(40))]
    stations = [0, 1, 2]
    searchers = (JCoadd(stations, cfg, scfg),
                 TCoadd(stations, _t(cfg), _t(scfg), device="cpu"))
    for cs in searchers:
        for k, (sid, off, b) in enumerate(taps):
            cs.tap(sid, off, b)
            if k == 9:
                cs.retire(1)
        cs.tap(1, 136, blk(8))          # retired: dropped
    j, t = searchers
    assert t._co.total == j._co.total > 0
    got = t._co.window(t._co.start, t._co.total).numpy()
    want = j._co.window(j._co.start, j._co.total)
    assert got.dtype == want.dtype == np.float16
    assert got.tobytes() == want.tobytes()
    assert t.station_ids == j.station_ids == [0, 2]
    assert t._next_offset == j._next_offset
    pending = lambda cs: {s: [TCoadd._blk_len(b) for b in v]
                          for s, v in cs._pending.items()}
    assert pending(t) == pending(j)


# --- one station: taps, kurtosis weights, the ring --------------------------

def _noise_seconds(cfg, n, seed=17):
    rng = np.random.default_rng(seed)
    return [np.clip(rng.standard_normal((cfg.npol_in, cfg.sample_rate))
                    / 0.05914 + 128.5, 0, 255).astype(np.uint8)
            for _ in range(n)]


def test_station_taps_kurto_and_ring(tmp_path):
    """Block taps get equal offsets and bytes (the 'scan' EMA's tiny
    chain, no injection: byte-exact between the packages), the
    _kurto.npz weights are equal; the port's ring holds each fed second
    (FLAG_OBS_START on the first, the observation header), drops
    nothing, and close() unlinks its segment.  The JAX station starts
    from the port's seed (jax_seeded)."""
    from jax_seeded import seeded
    cfg = PipelineConfig.tiny(nbit=2, ema_impl="scan")
    scfg = SearchConfig.tiny()
    secs = _noise_seconds(cfg, 4)
    got = {}
    for pkg in ("jax", "port"):
        taps = []
        if pkg == "jax":
            pipe = JPipe(61, cfg, scfg, out_dir=str(tmp_path / pkg),
                         keep_ring=False, write_kurto=True)
            doc = JDoc
        else:
            pipe = TPipe(61, _t(cfg), _t(scfg), out_dir=str(tmp_path / pkg),
                         write_kurto=True, device="cpu")
            doc = TDoc
        pipe.block_taps.append(
            lambda sid, off, b: taps.append((sid, off, b.copy())))
        with seeded():
            prod = pipe.run_observation(
                ((1.6e9 + s, b) for s, b in enumerate(secs)),
                doc(name="TAPS", start_time=1.6e9, scan_no=3))
        kurto = np.load(prod.fil_path.replace(".fil", "_kurto.npz"))
        got[pkg] = (taps, kurto["weights"], prod)
        if pkg == "port":
            ring = pipe.ring
            shm = f"/dev/shm{ring.name}"
            assert os.path.exists(shm)
            assert ring.resident() == (0, len(secs))
            for seq, buf in enumerate(secs):
                data, ts = ring.peek(seq)
                assert ts == 1.6e9 + seq
                np.testing.assert_array_equal(data, buf.reshape(-1))
            assert ring.read()[2] == FLAG_OBS_START
            hdr, _ = ring.get_obs_header()
            assert hdr == TDoc(name="TAPS", start_time=1.6e9,
                               scan_no=3).to_ascii_header(61)
            assert prod.dropped == 0
        pipe.close()
        if pkg == "port":
            assert not os.path.exists(shm)
    (tj, wj, _), (tt, wt, _) = got["jax"], got["port"]
    assert len(tt) == len(tj) == len(secs)
    assert [(s, o) for s, o, _ in tt] == [(s, o) for s, o, _ in tj]
    assert tt[1][1] == tt[0][2].shape[0] > 0
    for (_, _, a), (_, _, b) in zip(tt, tj):
        np.testing.assert_array_equal(a, b)
    assert wt.shape == wj.shape and np.array_equal(wt, wj)


def test_ring_pipeline_refuses_device_tensors(tmp_path):
    """With a ring, a second must be host bytes: a tensor on another
    device raises before anything is written."""
    cfg = tconfig.PipelineConfig.tiny()
    pipe = TPipe(61, cfg, tconfig.SearchConfig.tiny(),
                 out_dir=str(tmp_path), write_cands=False, device="cpu")
    try:
        pipe.begin_observation(TDoc(name="DEV", start_time=1.6e9))
        dev = torch.empty((cfg.npol_in, cfg.sample_rate), dtype=torch.uint8,
                          device="meta")
        with pytest.raises(ValueError, match="host bytes"):
            pipe.feed_second(1.6e9, dev)
        assert pipe.ring.resident() == (0, 0) and pipe._nsec == 0
        pipe.feed_second(1.6e9, torch.from_numpy(
            _noise_seconds(cfg, 1)[0]))          # a CPU tensor is host bytes
        assert pipe.ring.resident() == (0, 1)
    finally:
        pipe.close()
