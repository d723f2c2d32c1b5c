"""The port's StationPipeline against the JAX package's, end to end on the
CPU: the same tiny seconds (an injected FRB armed at second 0, the
armed window then the injection-free twin) through both, live gulp
search, keep_ring=False.

Bar: the candidates clear of the threshold (S/N > snr_thresh + 0.5, so a
crossing that sits on the threshold in one package and just under it in
the other cannot decide the comparison) have equal DM index, peak index
and width, and S/N within rtol 1e-3 (the 2-bit filterbanks agree to
>= 0.9999 of levels, not bit for bit).
"""

import os

import numpy as np
import pytest
import torch

from vlite_fast_tpu.config import PipelineConfig, SearchConfig
from vlite_fast_tpu.runtime.control import ObservationDocument as JDoc
from vlite_fast_tpu.runtime.pipeline import StationPipeline as JPipe
from vlite_fast_tpu_torch.models import baseband_dsp as tdsp
from vlite_fast_tpu_torch.ops import megakernel as tmk
from vlite_fast_tpu_torch.runtime.pipeline import ObservationDocument as TDoc
from vlite_fast_tpu_torch.runtime.pipeline import StationPipeline as TPipe

torch.set_num_threads(1)


def _seconds(cfg, n):
    rng = np.random.default_rng(17)
    return [np.clip(rng.standard_normal((cfg.npol_in, cfg.sample_rate))
                    / 0.05914 + 128.5, 0, 255).astype(np.uint8)
            for _ in range(n)]


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
    results = []
    for pipe_cls, doc in ((JPipe, JDoc), (TPipe, TDoc)):
        pipe = pipe_cls(1, cfg, scfg, out_dir=str(tmp_path / doc.__module__),
                        keep_ring=False, write_cands=False)
        prod = pipe.run_observation(
            ((1.6e9 + s, buf) for s, buf in enumerate(secs)),
            doc(name="PARITY", start_time=1.6e9), write_fil=True)
        results.append(prod)
        if pipe_cls is JPipe:
            pipe.close()
    prod_j, prod_t = results
    assert prod_t.seconds == prod_j.seconds == len(secs)
    assert 1 < tdsp.inject_window_seconds(cfg) < len(secs)
    # host gating: every second after the armed window went through the
    # chain kernel's entry point (its plain version here, on the CPU)
    assert len(twin_calls) == len(secs) - tdsp.inject_window_seconds(cfg)
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
    """Both pipelines from a cold bandpass on 5 s of pure noise, injection
    off: the same candidates.  Each segment seeds the bandpass from its
    ffts_per_seg spectra; with the tiny geometry's 200 neither finds
    anything, with 20 (seg_per_sec 100) both find the same start-up
    transient in the first 0.1 s (the production geometry seeds from 32)."""
    cfg = PipelineConfig.tiny(nbit=2, ema_impl="scan",
                              seg_per_sec=seg_per_sec)
    scfg = SearchConfig.tiny()
    secs = _seconds(cfg, 5)
    results = []
    for pipe_cls, doc in ((JPipe, JDoc), (TPipe, TDoc)):
        pipe = pipe_cls(1, cfg, scfg, out_dir=str(tmp_path / doc.__module__),
                        keep_ring=False, write_cands=False)
        results.append(pipe.run_observation(
            ((1.6e9 + s, buf) for s, buf in enumerate(secs)),
            doc(name="COLD", start_time=1.6e9), write_fil=False))
        if pipe_cls is JPipe:
            pipe.close()
    clear = scfg.snr_thresh + 0.5
    cands = [sorted(((c.dmi, c.peak_idx, c.tfilt, c.snr)
                     for c in r.candidates if c.snr > clear))
             for r in results]
    assert [c[:3] for c in cands[1]] == [c[:3] for c in cands[0]]
    np.testing.assert_allclose([c[3] for c in cands[1]],
                               [c[3] for c in cands[0]], rtol=1e-3)
    for r in results:
        early = [c for c in r.candidates if c.peak_time < 0.1]
        assert bool(early) == (seg_per_sec == 100), r.candidates


def test_keep_ring_not_ported():
    with pytest.raises(NotImplementedError, match="ring"):
        TPipe(1, PipelineConfig.tiny(), SearchConfig.tiny(), keep_ring=True)
