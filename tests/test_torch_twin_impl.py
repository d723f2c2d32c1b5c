"""Which program serves the seconds outside the armed window: the port's
resolution of chain_impl / twin_chain_impl against the JAX package's, on
the CPU.

- twin_chain_impl='same' (and an explicit 'xla') gives every non-armed
  second process_second with injection off, the armed program, as the
  JAX package's 'same' does; never the v2 chain kernel.
- Every value resolves as JAX's resolve_twin_impl / megakernel_supported
  do, raising where JAX raises; only 'auto' reads "the TPU backend" as
  "any device" and takes the v2 kernel where it fits the geometry.
- The pipeline with twin_chain_impl='megakernel3' (the pallas relayout
  and chain_second) against the JAX pipeline with the same value, to the
  bar of tests/test_torch_pipeline.py.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from vlite_fast_tpu.config import PipelineConfig, SearchConfig
from vlite_fast_tpu.models import baseband_dsp as jdsp
from vlite_fast_tpu.runtime.control import ObservationDocument as JDoc
from vlite_fast_tpu.runtime.pipeline import StationPipeline as JPipe
from vlite_fast_tpu_torch.models import baseband_dsp as tdsp
from vlite_fast_tpu_torch.ops import megakernel as tmk
from vlite_fast_tpu_torch.runtime.pipeline import ObservationDocument as TDoc
from vlite_fast_tpu_torch.runtime.pipeline import StationPipeline as TPipe

torch.set_num_threads(1)

MK = ("megakernel", "megakernel2", "megakernel3", "megakernel3f",
      "megakernel4")


def _seconds(cfg, n):
    rng = np.random.default_rng(17)
    return [np.clip(rng.standard_normal((cfg.npol_in, cfg.sample_rate))
                    / 0.05914 + 128.5, 0, 255).astype(np.uint8)
            for _ in range(n)]


def _feed(pipe, secs, doc=TDoc):
    return pipe.run_observation(
        ((1.6e9 + s, buf) for s, buf in enumerate(secs)),
        doc(name="TWIN", start_time=1.6e9), write_fil=False)


@pytest.mark.parametrize("twin", ["same", "xla"])
def test_same_twin_runs_the_armed_program(tmp_path, monkeypatch, twin):
    """The fault of the parent: 'same' and 'xla' went to the v2 kernel."""
    cfg = PipelineConfig.tiny(nbit=2, inject_frb=True, twin_chain_impl=twin)
    secs = _seconds(cfg, 4)
    window = tdsp.inject_window_seconds(cfg)
    assert 1 <= window < len(secs)
    programs, v2 = [], []
    real, chain = tdsp.process_second, tmk.chain_second_v2
    monkeypatch.setattr(tdsp, "process_second",
                        lambda c, *a: programs.append(c.inject_frb)
                        or real(c, *a))
    monkeypatch.setattr(tmk, "chain_second_v2",
                        lambda *a: v2.append(1) or chain(*a))
    pipe = TPipe(1, cfg, SearchConfig.tiny(), out_dir=str(tmp_path),
                 write_cands=False)
    _feed(pipe, secs)
    assert programs == [True] * window + [False] * (len(secs) - window)
    assert v2 == []


def _jax_verdict(cfg):
    """The chain_impl the JAX pipeline runs outside the armed window, or
    'raise' where it raises (the armed program for a megakernel
    chain_impl; megakernel_supported at the first twin second)."""
    if cfg.inject_frb and cfg.chain_impl in MK:
        return "raise"
    impl = jdsp.resolve_twin_impl(cfg) if cfg.inject_frb else cfg.chain_impl
    if impl in MK and not jdsp.megakernel_supported(dataclasses.replace(
            cfg, inject_frb=False, chain_impl=impl)):
        return "raise"
    return impl


def _port_verdict(cfg):
    try:
        impl = tdsp.resolve_twin_impl(cfg)
    except ValueError:
        return "raise", None
    return impl, tdsp.twin_program(cfg)


def test_resolution_matches_jax_over_config_grid():
    grid = itertools.product(
        (False, True), (2, 8), (1, 2), (20, 50, 250),
        ("xla", "megakernel", "megakernel2", "megakernel4"),
        ("auto", "same", "xla") + MK)
    seen = set()
    for inject, nbit, npol_out, nkurto, chain_impl, twin in grid:
        cfg = PipelineConfig.tiny(inject_frb=inject, nbit=nbit,
                                  npol_out=npol_out, nkurto=nkurto,
                                  chain_impl=chain_impl,
                                  twin_chain_impl=twin)
        want = _jax_verdict(cfg)
        got, program = _port_verdict(cfg)
        seen.add((want, got))
        if twin == "auto" and want == "xla" and got == "megakernel2":
            # the port's reading of 'auto': the v2 kernel on any device
            assert tdsp.chain_kernel_takes(
                dataclasses.replace(cfg, inject_frb=False))
        else:
            assert got == want, (cfg, got, want)
        if got != "raise":
            assert program is (tdsp.twin_second if got in MK
                               else tdsp.process_second)
    # the grid reaches every outcome: each kernel program, the armed
    # program, the refusals and the 'auto' reading
    assert {g for _, g in seen} >= set(MK) | {"xla", "raise"}
    assert ("xla", "megakernel2") in seen


@pytest.mark.parametrize("cfg", [
    PipelineConfig.tiny(nbit=2, inject_frb=True, chain_impl="megakernel"),
    PipelineConfig.tiny(nbit=2, inject_frb=True, chain_impl="megakernel4",
                        twin_chain_impl="same"),
    PipelineConfig.tiny(nbit=8, inject_frb=True,
                        twin_chain_impl="megakernel3"),
    PipelineConfig.tiny(nbit=2, chain_impl="megakernel3", nkurto=20),
], ids=["megakernel-armed", "megakernel4-same", "8bit-megakernel3",
        "nkurto-megakernel3"])
def test_pipeline_refuses_at_construction(tmp_path, cfg):
    with pytest.raises(ValueError):
        TPipe(1, cfg, SearchConfig.tiny(), out_dir=str(tmp_path))


def test_pipeline_megakernel3_matches_jax(tmp_path, monkeypatch):
    """twin_chain_impl='megakernel3' in both packages: the clear
    candidates agree, and every twin second went through the port's
    chain_second entry point (its plain version on the CPU) in the
    'pallas' mode, never through chain_second_v2."""
    cfg = PipelineConfig.tiny(inject_frb=True, nbit=2, ema_impl="scan",
                              inject_dm=60.0, inject_amp=2.0,
                              inject_width_s=8e-3,
                              twin_chain_impl="megakernel3")
    scfg = SearchConfig.tiny()
    secs = _seconds(cfg, 5)
    modes, v2 = [], []
    chain, chain_v2 = tmk.chain_second, tmk.chain_second_v2
    monkeypatch.setattr(tmk, "chain_second",
                        lambda *a, **k: modes.append(k["pretranspose"])
                        or chain(*a, **k))
    monkeypatch.setattr(tmk, "chain_second_v2",
                        lambda *a: v2.append(1) or chain_v2(*a))
    results = []
    for pipe_cls, doc in ((JPipe, JDoc), (TPipe, TDoc)):
        pipe = pipe_cls(1, cfg, scfg, out_dir=str(tmp_path / doc.__module__),
                        keep_ring=False, write_cands=False)
        results.append(_feed(pipe, secs, doc))
        if pipe_cls is JPipe:
            pipe.close()
    prod_j, prod_t = results
    assert prod_t.seconds == prod_j.seconds == len(secs)
    window = tdsp.inject_window_seconds(cfg)
    assert modes == ["pallas"] * (len(secs) - window) and v2 == []
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
    best = max(prod_t.candidates, key=lambda c: c.snr)
    assert abs(best.dm - 60.0) < 10.0
