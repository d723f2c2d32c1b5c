"""The port's WOLA polyphase channelizer (channelizer='pfb') against the
JAX package's, on the CPU.

- ops/channelize: polyphase_channelize (with and without a carried tail)
  and pfb_weights against the JAX functions, to 1e-5 of the spectra's
  scale and 1e-5 relative.
- models/baseband_dsp: three consecutive seconds, so the carried
  voltages and block weights cross seconds as well as segments, through
  the port's armed program (process_second: the WOLA over the whole
  second) and its segment-by-segment oracle (process_second_plain)
  against the JAX sequential chain (ema_impl='scan'), at the chain bar:
  >= 0.9999 of 2-bit levels agree, weights within 1e-6 relative,
  dag_frac equal, bandpasses within 1e-4 relative, the carried tail and
  weight tail bit-equal.
- runtime/pipeline: a StationPipeline with channelizer='pfb' and an
  injected FRB gives the JAX pipeline's clear candidates, the JAX
  pipeline started from the port's first bandpass (tests/jax_seeded.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlite_fast_tpu.config import PipelineConfig, SearchConfig
from vlite_fast_tpu.models import baseband_dsp as jdsp
from vlite_fast_tpu.ops import channelize as jch
from vlite_fast_tpu.ops import quantize as jq
from vlite_fast_tpu.runtime.control import ObservationDocument as JDoc
from vlite_fast_tpu.runtime.pipeline import StationPipeline as JPipe
from vlite_fast_tpu_torch import config as tconfig
from vlite_fast_tpu_torch import interop
from vlite_fast_tpu_torch.models import baseband_dsp as tdsp
from vlite_fast_tpu_torch.ops import channelize as tch
from vlite_fast_tpu_torch.runtime.pipeline import ObservationDocument as TDoc
from vlite_fast_tpu_torch.runtime.pipeline import StationPipeline as TPipe

torch.set_num_threads(1)


def _t(cfg):
    """The port's config of the same class and fields as a JAX package one."""
    return getattr(tconfig, type(cfg).__name__)(**dataclasses.asdict(cfg))


def _noise(nsamp, seed, bursts=()):
    """Gaussian 8-bit voltages with sinusoidal bursts in pol 0 at the
    given sample offsets, so the kurtosis gates fire."""
    rng = np.random.default_rng(seed)
    raw = np.clip(rng.standard_normal((2, nsamp)) / 0.05914 + 128.5, 0,
                  255).astype(np.int16)
    t = np.arange(3000)
    for at in bursts:
        n = min(3000, nsamp - at)
        raw[0, at:at + n] += (60 * np.sin(0.3 * t[:n])).astype(np.int16)
    return np.clip(raw, 0, 255).astype(np.uint8)


def _levels(packed, nbit=2):
    return np.asarray(jq.unpack_bits(jnp.asarray(np.asarray(packed)),
                                     nbit)).astype(np.int16)


def _assert_levels(a, b):
    la, lb = _levels(a), _levels(b)
    assert la.shape == lb.shape
    assert (la == lb).mean() >= 0.9999, (la == lb).mean()
    assert np.abs(la - lb).max() <= 1


def _assert_rel(got, want, tol, floor=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    rel = np.abs(got - want) / np.maximum(np.abs(want), floor)
    assert rel.max() < tol, rel.max()


@pytest.mark.parametrize("method", ["fft", "matmul"])
@pytest.mark.parametrize("carried", [False, True])
def test_polyphase_channelize_matches_jax(method, carried):
    nfft, ntap = 500, 4
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40 * nfft)).astype(np.float32)
    tail = rng.standard_normal((2, (ntap - 1) * nfft)).astype(np.float32)
    if carried:
        got = tch.polyphase_channelize(torch.from_numpy(x), nfft, ntap,
                                       method=method,
                                       tail=torch.from_numpy(tail))
        want = jch.polyphase_channelize(
            jnp.asarray(np.concatenate([tail, x], axis=1)), nfft, ntap,
            method=method, precision="highest")
        assert got.shape == (2, 40, nfft // 2 + 1)
    else:
        got = tch.polyphase_channelize(torch.from_numpy(x), nfft, ntap,
                                       method=method)
        want = jch.polyphase_channelize(jnp.asarray(x), nfft, ntap,
                                        method=method, precision="highest")
        assert got.shape == (2, 40 - (ntap - 1), nfft // 2 + 1)
    want = np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * scale)


def test_pfb_window_and_weights_match_jax():
    nfft, ntap = 500, 4
    assert np.array_equal(tch._pfb_window(ntap, nfft),
                          jch._pfb_window(ntap, nfft))
    rng = np.random.default_rng(4)
    w_ext = rng.uniform(0, 1, (2, 200 + ntap - 1)).astype(np.float32)
    w_ext[:, 50:60] = 1.0
    got = tch.pfb_weights(torch.from_numpy(w_ext), ntap, nfft)
    want = np.asarray(jch.pfb_weights(jnp.asarray(w_ext), ntap, nfft))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_channelize_refuses_pfb():
    with pytest.raises(ValueError):
        tch.channelize(torch.zeros((1, 1000)), 500, method="pfb")


def _pfb_cfg(rfi_mode):
    return PipelineConfig.tiny(channelizer="pfb", rfi_mode=rfi_mode, nbit=2,
                               ema_impl="scan")


def test_init_state_carries_pfb_widths():
    cfg = _pfb_cfg(2)
    st_j = jdsp.init_state(cfg)
    st_t = tdsp.init_state(_t(cfg), "cpu")
    tl = (cfg.pfb_ntap - 1) * cfg.nfft
    assert tuple(st_t.tail.shape) == st_j.tail.shape == (2, 2, tl)
    assert tuple(st_t.wtail.shape) == st_j.wtail.shape == (2, 3)
    assert np.array_equal(st_t.wtail.numpy(), np.asarray(st_j.wtail))
    # a JAX pfb state crosses over with its real widths
    st_j2 = st_j._replace(tail=jnp.asarray(np.random.default_rng(0)
                                           .standard_normal((2, 2, tl)),
                                           jnp.float32))
    st_x = interop.state_from_jax(*(np.asarray(f) for f in st_j2),
                                  device="cpu")
    assert np.array_equal(st_x.tail.numpy(), np.asarray(st_j2.tail))
    back = interop.state_to_numpy(st_x)
    assert back["tail"].shape == (2, 2, tl) and back["wtail"].shape == (2, 3)


@pytest.mark.parametrize("program", ["process_second",
                                     "process_second_plain"])
@pytest.mark.parametrize("rfi_mode", [0, 1, 2])
def test_pfb_seconds_match_jax(rfi_mode, program):
    """Three seconds from a fresh state in both packages, each carrying
    its own state; bursts at a segment's last block and at the end of a
    second, so the carried block weights cross both boundaries."""
    cfg = _pfb_cfg(rfi_mode)
    seg = cfg.seg_samps
    secs = [_noise(cfg.sample_rate, 20 + i,
                   bursts=(seg - 2000, 4 * seg + 10_000,
                           cfg.sample_rate - 2500)) for i in range(3)]
    port = getattr(tdsp, program)
    st_j = jdsp.init_state(cfg)
    st_t = tdsp.init_state(_t(cfg), "cpu")
    for raw in secs:
        oj, st_j = jdsp.process_second(cfg, jnp.asarray(raw), st_j,
                                       jnp.asarray(False))
        ot, st_t = port(_t(cfg), torch.from_numpy(raw), st_t, False)
        for field in ("packed", "packed_kur"):
            _assert_levels(getattr(ot, field), getattr(oj, field))
        _assert_rel(ot.weights.numpy(), oj.weights, 1e-6)
        assert float(ot.dag_frac) == float(oj.dag_frac)
        if rfi_mode:
            assert float(ot.dag_frac) > 0          # the bursts were flagged
            assert ot.weights.min() < 1.0
        _assert_rel(st_t.bp, st_j.bp, 1e-4)
        _assert_rel(st_t.bp_kur, st_j.bp_kur, 1e-4)
        assert np.array_equal(st_t.tail.numpy(), np.asarray(st_j.tail))
        assert np.array_equal(st_t.wtail.numpy(), np.asarray(st_j.wtail))
        assert st_t.tail.abs().sum() > 0           # the carry is real
        assert tuple(ot.histo.shape) == (2, 0)


def test_pfb_second_differs_from_matmul():
    """The WOLA is not the plain channelizer under another name: the same
    second through channelizer 'matmul' gives other levels."""
    raw = torch.from_numpy(_noise(PipelineConfig.tiny().sample_rate, 5))
    outs = []
    for ch in ("pfb", "matmul"):
        cfg = _t(PipelineConfig.tiny(channelizer=ch, rfi_mode=0, nbit=2))
        out, _ = tdsp.process_second(cfg, raw, tdsp.init_state(cfg, "cpu"))
        outs.append(_levels(out.packed))
    assert (outs[0] != outs[1]).mean() > 0.1


def _seconds(cfg, n):
    rng = np.random.default_rng(17)
    return [np.clip(rng.standard_normal((cfg.npol_in, cfg.sample_rate))
                    / 0.05914 + 128.5, 0, 255).astype(np.uint8)
            for _ in range(n)]


def test_pipeline_pfb_recovers_the_jax_candidates(tmp_path):
    from jax_seeded import seeded
    cfg = PipelineConfig.tiny(channelizer="pfb", inject_frb=True, nbit=2,
                              ema_impl="scan", inject_dm=60.0,
                              inject_amp=2.0, inject_width_s=8e-3)
    scfg = SearchConfig.tiny()
    secs = _seconds(cfg, 5)
    results = []
    for pipe_cls, doc in ((JPipe, JDoc), (TPipe, TDoc)):
        kw = dict(out_dir=str(tmp_path / doc.__module__), keep_ring=False,
                  write_cands=False)
        if pipe_cls is JPipe:
            pipe = JPipe(1, cfg, scfg, **kw)
        else:
            pipe = TPipe(1, _t(cfg), _t(scfg), device="cpu", **kw)
            assert tdsp.second_program(pipe.cfg, -1)[1] is \
                tdsp.process_second
        with seeded():
            results.append(pipe.run_observation(
                ((1.6e9 + s, buf) for s, buf in enumerate(secs)),
                doc(name="PFB", start_time=1.6e9), write_fil=False))
        if pipe_cls is JPipe:
            pipe.close()
    prod_j, prod_t = results
    assert prod_t.seconds == prod_j.seconds == len(secs)
    clear = scfg.snr_thresh + 0.5
    key = lambda c: (c.peak_idx, c.dmi)
    cj = sorted((c for c in prod_j.candidates if c.snr > clear), key=key)
    ct = sorted((c for c in prod_t.candidates if c.snr > clear), key=key)
    assert len(cj) >= 1
    assert [(c.dmi, c.peak_idx, c.tfilt) for c in ct] == \
        [(c.dmi, c.peak_idx, c.tfilt) for c in cj]
    np.testing.assert_allclose([c.snr for c in ct], [c.snr for c in cj],
                               rtol=1e-3)
    best = max(prod_t.candidates, key=lambda c: c.snr)
    assert abs(best.dm - 60.0) < 10.0
