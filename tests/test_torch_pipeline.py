"""The port's StationPipeline against the JAX package's, end to end on the
CPU: the same tiny seconds (an injected FRB armed at second 0, the
armed program then the injection-free twin) through both, live gulp
search, keep_ring=False.

The port seeds an observation's first bandpasses from the EMA's own
length of spectra (models/baseband_dsp.seed_bandpass), the JAX package
from each program's first tile: every comparison from a cold start runs
the JAX pipeline from the port's seed (tests/jax_seeded.py), and
test_cold_start_candidates_match_jax pins the departure.

Bar: the candidates clear of the threshold (S/N > snr_thresh + 0.5, so a
crossing that sits on the threshold in one package and just under it in
the other cannot decide the comparison) have equal DM index, peak index
and width, and S/N within rtol 1e-3 (the 2-bit filterbanks agree to
>= 0.9999 of levels, not bit for bit).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from vlite_fast_tpu.config import PipelineConfig, SearchConfig
from vlite_fast_tpu.runtime.control import ObservationDocument as JDoc
from vlite_fast_tpu.runtime.pipeline import StationPipeline as JPipe
from vlite_fast_tpu_torch import config as tconfig
from vlite_fast_tpu_torch.models import baseband_dsp as tdsp
from vlite_fast_tpu_torch.ops import megakernel as tmk
from vlite_fast_tpu_torch.runtime.pipeline import ArrayPipeline as TArray
from vlite_fast_tpu_torch.runtime.pipeline import CoaddSearcher as TCoadd
from vlite_fast_tpu_torch.runtime.pipeline import ObservationDocument as TDoc
from vlite_fast_tpu_torch.runtime.pipeline import StationPipeline as TPipe

torch.set_num_threads(1)


def _t(cfg):
    """The port's config of the same class and fields as a JAX package one."""
    return getattr(tconfig, type(cfg).__name__)(**dataclasses.asdict(cfg))


def _pipe(pipe_cls, cfg, scfg, **kw):
    """pipe_cls on the CPU from a JAX package config pair (the port's
    StationPipeline takes the port's configs and an explicit device)."""
    if pipe_cls is JPipe:
        return JPipe(1, cfg, scfg, **kw)
    return TPipe(1, _t(cfg), _t(scfg), device="cpu", **kw)


def _seconds(cfg, n):
    rng = np.random.default_rng(17)
    return [np.clip(rng.standard_normal((cfg.npol_in, cfg.sample_rate))
                    / 0.05914 + 128.5, 0, 255).astype(np.uint8)
            for _ in range(n)]


def _run(pipe_cls, doc, cfg, scfg, secs, out_dir, name, write_fil=False):
    """One observation of `secs` through pipe_cls; the JAX pipeline starts
    from the port's seed (jax_seeded)."""
    from jax_seeded import seeded
    pipe = _pipe(pipe_cls, cfg, scfg, out_dir=str(out_dir), keep_ring=False,
                 write_cands=False)
    with seeded():
        prod = pipe.run_observation(
            ((1.6e9 + s, buf) for s, buf in enumerate(secs)),
            doc(name=name, start_time=1.6e9), write_fil=write_fil)
    pipe.close()
    return prod


def test_pipeline_candidates_match_jax(tmp_path, monkeypatch):
    cfg = PipelineConfig.tiny(inject_frb=True, nbit=2, ema_impl="scan",
                              inject_dm=60.0, inject_amp=2.0,
                              inject_width_s=8e-3)
    scfg = SearchConfig.tiny()
    secs = _seconds(cfg, 5)
    twin_calls = []
    chain = tmk.chain_second_v2
    monkeypatch.setattr(tmk, "chain_second_v2",
                        lambda *a: twin_calls.append(1) or chain(*a))
    results = [_run(pipe_cls, doc, cfg, scfg, secs,
                    tmp_path / doc.__module__, "PARITY", write_fil=True)
               for pipe_cls, doc in ((JPipe, JDoc), (TPipe, TDoc))]
    prod_j, prod_t = results
    assert prod_t.seconds == prod_j.seconds == len(secs)
    window = tdsp.inject_window_seconds(_t(cfg))
    ntrack = sum(tdsp.second_injects(_t(cfg), s * cfg.seg_per_sec)
                 for s in range(len(secs)))
    assert 1 <= ntrack < window < len(secs)
    # host gating: every second the track does not reach, inside the JAX
    # pipeline's armed window or after it, went through the chain
    # kernel's entry point (its plain version here, on the CPU)
    assert len(twin_calls) == len(secs) - ntrack
    clear = scfg.snr_thresh + 0.5
    cj = sorted((c for c in prod_j.candidates if c.snr > clear),
                key=lambda c: (c.peak_idx, c.dmi))
    ct = sorted((c for c in prod_t.candidates if c.snr > clear),
                key=lambda c: (c.peak_idx, c.dmi))
    assert len(cj) >= 1
    assert [(c.dmi, c.peak_idx, c.tfilt) for c in ct] == \
        [(c.dmi, c.peak_idx, c.tfilt) for c in cj]
    np.testing.assert_allclose([c.snr for c in ct], [c.snr for c in cj],
                               rtol=1e-3)
    # the injected burst is the strongest candidate, near its DM
    best = max(prod_t.candidates, key=lambda c: c.snr)
    assert abs(best.dm - 60.0) < 10.0
    # both wrote the same-sized filterbank
    assert prod_t.fil_path and prod_j.fil_path
    assert os.path.getsize(prod_t.fil_path) == os.path.getsize(
        prod_j.fil_path)


@pytest.mark.parametrize("seg_per_sec", [10, 100])
def test_cold_start_candidates_match_jax(tmp_path, seg_per_sec):
    """5 s of pure noise from a cold bandpass, injection off.  The JAX
    pipeline as shipped seeds each zero bandpass entry from its first
    tile of ffts_per_seg spectra: with the tiny geometry's 200 it finds
    nothing in the first 0.1 s, with 20 (seg_per_sec 100) the start-up
    transient (ROADMAP Queue 3 #2).  The port seeds from the EMA's own
    length (seed_bandpass) and finds nothing there at either.  From the
    port's seed (jax_seeded) the JAX pipeline gives the port's
    candidates."""
    cfg = PipelineConfig.tiny(nbit=2, ema_impl="scan",
                              seg_per_sec=seg_per_sec)
    scfg = SearchConfig.tiny()
    secs = _seconds(cfg, 5)
    cold = JPipe(1, cfg, scfg, out_dir=str(tmp_path / "cold"),
                 keep_ring=False, write_cands=False)
    prod_cold = cold.run_observation(
        ((1.6e9 + s, buf) for s, buf in enumerate(secs)),
        JDoc(name="COLD", start_time=1.6e9), write_fil=False)
    cold.close()
    results = [_run(pipe_cls, doc, cfg, scfg, secs,
                    tmp_path / doc.__module__, "COLD")
               for pipe_cls, doc in ((JPipe, JDoc), (TPipe, TDoc))]
    clear = scfg.snr_thresh + 0.5
    cands = [sorted(((c.dmi, c.peak_idx, c.tfilt, c.snr)
                     for c in r.candidates if c.snr > clear))
             for r in results]
    assert [c[:3] for c in cands[1]] == [c[:3] for c in cands[0]]
    np.testing.assert_allclose([c[3] for c in cands[1]],
                               [c[3] for c in cands[0]], rtol=1e-3)
    early = lambda r: [c for c in r.candidates if c.peak_time < 0.1]
    assert bool(early(prod_cold)) == (seg_per_sec == 100), \
        prod_cold.candidates
    for r in results:
        assert not early(r), r.candidates


def test_flush_gulp_candidates_match_jax(tmp_path):
    """6 s of pure noise whose last gulp is short (600 rows of 2400 +
    453).  The JAX package pads it with the near-zero level and raises
    spurious candidates at its start (ROADMAP Queue 3 #3); the port
    searches its 600 rows and raises none there.  The gulps before it
    give both packages the same candidates."""
    cfg = PipelineConfig.tiny(nbit=2)
    scfg = SearchConfig.tiny(gulp_samps=2400)
    secs = _seconds(cfg, 6)
    results = [_run(pipe_cls, doc, cfg, scfg, secs,
                    tmp_path / doc.__module__, "FLUSH")
               for pipe_cls, doc in ((JPipe, JDoc), (TPipe, TDoc))]
    flush_start = scfg.gulp_samps
    key = lambda r: sorted((c.dmi, c.peak_idx, c.tfilt, c.i0, c.i1)
                           for c in r.candidates if c.snr > scfg.snr_thresh
                           + 0.5 and c.peak_idx < flush_start)
    assert key(results[1]) == key(results[0])
    assert any(c.i0 == flush_start and c.snr > 12.0
               for c in results[0].candidates)
    assert not [c for c in results[1].candidates
                if c.peak_idx >= flush_start and c.snr > scfg.snr_thresh]


def test_feed_seconds_one_entry_per_second_per_program(tmp_path):
    """feed_seconds holds one positive time per fed second, under the
    program that ran it (on a card they come from CUDA events, read once
    they have completed; end_observation reads the rest)."""
    cfg = tconfig.PipelineConfig.tiny(inject_frb=True, nbit=2)
    pipe = TPipe(1, cfg, tconfig.SearchConfig.tiny(), out_dir=str(tmp_path),
                 write_cands=False, device="cpu")
    secs = _seconds(cfg, 4)
    prod = pipe.run_observation(
        ((1.6e9 + s, buf) for s, buf in enumerate(secs)),
        TDoc(name="TIMES", start_time=1.6e9), write_fil=False)
    # the armed program ran on the seconds the track reaches alone
    track = [tdsp.second_injects(cfg, s * cfg.seg_per_sec) for s in range(4)]
    assert prod.seconds == 4 and 1 <= sum(track) < 4
    assert len(pipe.feed_seconds["armed"]) == sum(track)
    assert len(pipe.feed_seconds["twin"]) == 4 - sum(track)
    assert all(t > 0 for ts in pipe.feed_seconds.values() for t in ts)


def test_fil_rows_equal_the_programs_outputs(tmp_path):
    """write_fil=True (the default), rfi_mode 2: the drain writes each
    second's rows from the host copy started at its dispatch, so the
    .fil holds the excised stream's packed rows and _plain.fil the plain
    stream's, equal to those of process_second and the twin called
    directly on the same seconds with the same arm schedule, from the
    first second's seed_bandpass; every fed
    second has its span and its host time by part."""
    from vlite_fast_tpu_torch import constants as tC
    from vlite_fast_tpu_torch.runtime.pipeline import HOST_PARTS
    from vlite_fast_tpu_torch.utils import sigproc
    cfg = tconfig.PipelineConfig.tiny(inject_frb=True, nbit=2)
    assert cfg.rfi_mode == 2
    pipe = TPipe(1, cfg, tconfig.SearchConfig.tiny(), out_dir=str(tmp_path),
                 write_cands=False, device="cpu")
    secs = _seconds(cfg, 4)
    prod = pipe.run_observation(
        ((1.6e9 + s, buf) for s, buf in enumerate(secs)),
        TDoc(name="FIL", start_time=1.6e9))
    pipe.close()
    # the armed program ran on the seconds the track reaches alone
    track = [tdsp.second_injects(cfg, s * cfg.seg_per_sec) for s in range(4)]
    assert prod.seconds == 4 and 1 <= sum(track) < 4
    assert len(pipe.feed_seconds["armed"]) == sum(track)
    assert len(pipe.feed_seconds["twin"]) == 4 - sum(track)
    assert all(len(pipe.host_seconds[k]) == 4 for k in HOST_PARTS)
    st = tdsp.seed_bandpass(cfg, torch.from_numpy(secs[0]),
                            tdsp.init_state(cfg, "cpu"))
    kur, plain = [], []
    for s, buf in enumerate(secs):
        arm = s % tC.INJECT_PERIOD_S == 0
        _, prog, pcfg = tdsp.second_program(
            cfg, 0 if arm else st.segs_since_inject)
        out, st = prog(pcfg, torch.from_numpy(buf), st, arm)
        kur.append(out.packed_kur.numpy())
        plain.append(out.packed.numpy())
    for path, want in ((prod.fil_path, kur),
                       (prod.fil_path.replace(".fil", "_plain.fil"), plain)):
        with open(path, "rb") as fp:
            hdr = sigproc.read_header(fp)
            rows = fp.read()
        assert hdr.nchans == cfg.nchanout and hdr.nbits == 2
        assert rows == np.concatenate(want, axis=0).tobytes()


def test_entry_points_default_to_the_card(tmp_path):
    """Built without a device, the entry points ask for "cuda"; where
    there is no card they raise rather than fall back to the CPU."""
    from vlite_fast_tpu_torch import interop
    from vlite_fast_tpu_torch.models import search as tsearch
    from vlite_fast_tpu_torch.ops import dedisperse as tdd
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults run there")
    cfg, scfg = tconfig.PipelineConfig.tiny(), tconfig.SearchConfig.tiny()
    freqs = cfg.freqs_mhz()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TPipe(1, cfg, scfg, out_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TArray(tconfig.ArrayConfig.tiny(nant=2), out_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TCoadd([1, 2], cfg, scfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsearch.SinglePulseSearch(scfg, cfg.tsamp, freqs)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdsp.init_state(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdd.make_plan(tdd.dm_grid(0.0, 100.0, 8), freqs, cfg.tsamp, nsub=8,
                      nbatch=8)
    z = np.zeros((2, cfg.nchan), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.state_from_jax(z, z, 0, z, z)
    assert TPipe(1, cfg, scfg, out_dir=str(tmp_path),
                 device="cpu").device == torch.device("cpu")
    assert TArray(tconfig.ArrayConfig.tiny(nant=2), out_dir=str(tmp_path),
                  keep_rings=False, device="cpu").coadd.device == \
        torch.device("cpu")
