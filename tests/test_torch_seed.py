"""The port's cold bandpass seed (models/baseband_dsp.seed_bandpass), on the
CPU.

An observation's first bandpasses are seeded from the mean of its first
seed_spectra(cfg) spectra, the EMA's own length, where the JAX package
seeds each program's first tile of ffts_per_seg spectra (ROADMAP Queue 3
#2 and #5).  The seed has no JAX counterpart, so it is held to the numpy
mean of the JAX package's own stages on the same bytes: its convert, RFI
stage (rfi_impl='xla') and channelize + detect (with the WOLA's fresh
tail for channelizer='pfb', whose first pfb_ntap - 1 spectra are left
out), to 1e-5 relative.  From the seeded state the port's
process_second is the JAX package's at the chain bar: >= 0.9999 of 2-bit
levels agree, weights within 1e-6 relative, bandpasses within 1e-4.
At the pipeline: noise alone raises no candidate in the first 0.5 s of
an observation, and the FRB armed at second 0 of a pfb observation is
found.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlite_fast_tpu.config import PipelineConfig
from vlite_fast_tpu.models import baseband_dsp as jdsp
from vlite_fast_tpu.ops import channelize as jch
from vlite_fast_tpu.ops import normalize as jnorm
from vlite_fast_tpu.ops import quantize as jq
from vlite_fast_tpu.ops import unpack as junpack
from vlite_fast_tpu_torch import config as tconfig
from vlite_fast_tpu_torch.models import baseband_dsp as tdsp
from vlite_fast_tpu_torch.runtime.pipeline import ObservationDocument as TDoc
from vlite_fast_tpu_torch.runtime.pipeline import StationPipeline as TPipe

torch.set_num_threads(1)


def _t(cfg):
    """The port's config of the same class and fields as a JAX package one."""
    return getattr(tconfig, type(cfg).__name__)(**dataclasses.asdict(cfg))


def _noise(nsamp, seed, bursts=(), npol=2):
    """Gaussian 8-bit voltages with sinusoidal bursts in pol 0 at the
    given sample offsets, so the kurtosis gates fire."""
    rng = np.random.default_rng(seed)
    raw = np.clip(rng.standard_normal((npol, nsamp)) / 0.05914 + 128.5, 0,
                  255).astype(np.int16)
    t = np.arange(3000)
    for at in bursts:
        raw[0, at:at + 3000] += (60 * np.sin(0.3 * t)).astype(np.int16)
    return np.clip(raw, 0, 255).astype(np.uint8)


def _jax_seed(cfg, raw):
    """(bp, bp_kur) float64: the numpy mean of the JAX package's stages
    over the first seed_spectra spectra of `raw`, by the seed's rules;
    None for a stream the configuration does not run."""
    n = tdsp.seed_spectra(_t(cfg))
    u = jnp.asarray(raw[:, :n * cfg.nfft])
    x = junpack.convert_uint8(u)
    x_kur, w, _ = jdsp._rfi_stage(dataclasses.replace(cfg, rfi_impl="xla"),
                                  u, x)
    w = np.asarray(w, np.float64)
    skip = 0
    if cfg.channelizer == "pfb":
        skip = cfg.pfb_ntap - 1
        fresh = jdsp.init_state(cfg)
        spectra = lambda v, s: jch.polyphase_channelize(
            jnp.concatenate([fresh.tail[s], v], axis=1), cfg.nfft,
            cfg.pfb_ntap, method="matmul", precision="highest")
        w = np.asarray(jch.pfb_weights(
            jnp.concatenate([fresh.wtail, jnp.asarray(w, jnp.float32)],
                            axis=1), cfg.pfb_ntap, cfg.nfft), np.float64)
    else:
        spectra = lambda v, s: jch.channelize(v, cfg.nfft, method="matmul",
                                              precision="highest")
    power = lambda v, s: np.asarray(jnorm.detect(spectra(v, s)),
                                    np.float64)[:, skip:]
    bp = bp_kur = None
    if cfg.rfi_mode != 1:
        bp = power(x, 0).mean(axis=1)
        bp[bp == 0.0] = 1.0
    if cfg.rfi_mode != 0:
        p = power(x_kur, 1)
        good = w[:, skip:, None] > 0.0
        ngood = good.sum(axis=1)
        pw = np.where(good, p / np.where(good, w[:, skip:, None], 1.0), 0.0)
        bp_kur = np.where(ngood > 0, pw.sum(axis=1) / np.maximum(ngood, 1),
                          1.0)
    return bp, bp_kur


@pytest.mark.parametrize("channelizer", ["matmul", "pfb"])
@pytest.mark.parametrize("rfi_mode", [0, 1, 2])
def test_seed_matches_the_jax_stages_mean(rfi_mode, channelizer):
    cfg = PipelineConfig.tiny(rfi_mode=rfi_mode, channelizer=channelizer,
                              nbit=2)
    raw = _noise(cfg.sample_rate, 31, bursts=(20_000, 150_000, 310_000))
    st = tdsp.seed_bandpass(_t(cfg), torch.from_numpy(raw),
                            tdsp.init_state(_t(cfg), "cpu"))
    want_bp, want_kur = _jax_seed(cfg, raw)
    for got, want in ((st.bp, want_bp), (st.bp_kur, want_kur)):
        if want is None:                    # a stream the mode does not run
            assert not bool(got.any())
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    # the state's other fields pass through
    fresh = tdsp.init_state(_t(cfg), "cpu")
    assert st.segs_since_inject == fresh.segs_since_inject
    assert torch.equal(st.tail, fresh.tail)
    assert torch.equal(st.wtail, fresh.wtail)


def test_seed_skips_the_partial_pfb_spectra():
    """With channelizer='pfb' the fresh tail's first pfb_ntap - 1 spectra
    are partial: a mean that took them in reads low, the seed does not."""
    cfg = PipelineConfig.tiny(rfi_mode=0, channelizer="pfb", nbit=2)
    raw = _noise(cfg.sample_rate, 32)
    st = tdsp.seed_bandpass(_t(cfg), torch.from_numpy(raw),
                            tdsp.init_state(_t(cfg), "cpu"))
    n = tdsp.seed_spectra(_t(cfg))
    x = tdsp.unpack_ops.convert_uint8(torch.from_numpy(raw[:, :n * cfg.nfft]
                                                        .copy()))
    p = tdsp._power(_t(cfg), x, -1, tdsp.init_state(_t(cfg), "cpu").tail[0])
    assert p.shape[1] == n
    with_partial = p.mean(dim=1)
    assert float((with_partial / st.bp).mean()) < 0.999
    np.testing.assert_allclose(st.bp.numpy(),
                               p[:, cfg.pfb_ntap - 1:].mean(dim=1).numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("rfi_mode", [0, 1, 2])
def test_seed_runs_its_front_once_on_the_seed_spectra(rfi_mode):
    """The seed's RFI front is its `front` argument (rfi_front by default,
    the kernel on a card; rfi_front_plain gives the plain seed the card
    holds it against): called once, on the first seed_spectra(cfg)
    spectra's bytes, where the kurtosis stream runs, and never where it
    does not; through the plain front the seed is the default's."""
    from vlite_fast_tpu_torch.ops import rfi_pallas
    cfg = _t(PipelineConfig.tiny(rfi_mode=rfi_mode, nbit=2))
    raw = torch.from_numpy(_noise(cfg.sample_rate, 36, bursts=(20_000,)))
    calls = []

    def front(u, *args, **kw):
        calls.append(tuple(u.shape))
        return rfi_pallas.rfi_front_plain(u, *args, **kw)
    fresh = tdsp.init_state(cfg, "cpu")
    st = tdsp.seed_bandpass(cfg, raw, fresh, front=front)
    n = tdsp.seed_spectra(cfg)
    assert calls == ([(2, n * cfg.nfft)] if rfi_mode else [])
    want = tdsp.seed_bandpass(cfg, raw, fresh)
    assert torch.equal(st.bp, want.bp) and torch.equal(st.bp_kur, want.bp_kur)


def test_nonzero_entries_pass_through():
    cfg = _t(PipelineConfig.tiny(nbit=2))
    raw = torch.from_numpy(_noise(cfg.sample_rate, 33))
    fresh = tdsp.init_state(cfg, "cpu")
    full = tdsp.seed_bandpass(cfg, raw, fresh)
    rng = np.random.default_rng(5)
    warm = torch.from_numpy(rng.uniform(0.5, 2.0, (2, 2, cfg.nchan))
                            .astype(np.float32))
    keep = torch.from_numpy(rng.uniform(size=(2, 2, cfg.nchan)) < 0.5)
    warm = torch.where(keep, warm, torch.zeros_like(warm))
    st = tdsp.seed_bandpass(cfg, raw, fresh._replace(bp=warm[0],
                                                     bp_kur=warm[1]))
    for i, (got, seeded) in enumerate(((st.bp, full.bp),
                                       (st.bp_kur, full.bp_kur))):
        assert torch.equal(got[keep[i]], warm[i][keep[i]])
        assert torch.equal(got[~keep[i]], seeded[~keep[i]])
    # a warm state passes through whole
    warm_all = fresh._replace(bp=full.bp + 1.0, bp_kur=full.bp_kur + 1.0)
    st = tdsp.seed_bandpass(cfg, raw, warm_all)
    assert torch.equal(st.bp, warm_all.bp)
    assert torch.equal(st.bp_kur, warm_all.bp_kur)


def test_zero_power_and_no_good_spectrum_seed_one():
    """A pol of zero voltages (level 128) has zero power in every channel:
    the plain stream seeds 1 there.  A loud tone over the seed's spectra
    flags every window: the kurtosis stream has no good spectrum and
    seeds 1 everywhere."""
    cfg = _t(PipelineConfig.tiny(rfi_mode=2, nbit=2))
    raw = _noise(cfg.sample_rate, 34)
    raw[1] = 128
    st = tdsp.seed_bandpass(cfg, torch.from_numpy(raw),
                            tdsp.init_state(cfg, "cpu"))
    assert bool((st.bp[1] == 1.0).all())
    assert bool((st.bp[0] != 1.0).all()) and bool((st.bp[0] > 0).all())
    raw = _noise(cfg.sample_rate, 35)
    tone = 100 * np.sin(0.3 * np.arange(cfg.sample_rate))
    raw = np.clip(raw + tone.astype(np.int16), 0, 255).astype(np.uint8)
    st = tdsp.seed_bandpass(cfg, torch.from_numpy(raw),
                            tdsp.init_state(cfg, "cpu"))
    assert bool((st.bp_kur == 1.0).all())
    assert bool((st.bp > 0).all())


@pytest.mark.parametrize("kw,want", [
    ({}, 1000),                        # s 0.002: N 999 -> 5 x 200
    ({"seg_per_sec": 100}, 1000),      # N 999 -> 50 x 20
    ({"seg_per_sec": 50}, 1000),       # N 999 -> 25 x 40
    ({"bp_tsmooth": 0.25}, 400),       # s 0.008: N 249 -> 2 x 200
    ({"bp_tsmooth": 10.0}, 2000),      # N 9999: capped at one second
])
def test_seed_spectra_follow_bp_scale(kw, want):
    cfg = tconfig.PipelineConfig.tiny(**kw)
    n = tdsp.seed_spectra(cfg)
    s = cfg.bp_scale
    assert n == want
    assert n % cfg.ffts_per_seg == 0
    assert n == min(cfg.seg_per_sec * cfg.ffts_per_seg,
                    cfg.ffts_per_seg * -(-round((2 - s) / s)
                                         // cfg.ffts_per_seg))
    assert n * cfg.nfft % cfg.nkurto == 0 and n * cfg.nfft <= cfg.sample_rate


def test_seed_spectra_at_production():
    """s = tsamp / 1 s = 7.8125e-4: N = 2559 -> 80 segments of 32 = 2560
    spectra, 0.25 s: 32,000,000 samples a pol, whole FFT blocks and
    kurtosis windows."""
    cfg = tconfig.PipelineConfig()
    assert cfg.bp_scale == 7.8125e-4 and cfg.ffts_per_seg == 32
    n = tdsp.seed_spectra(cfg)
    assert n == 2560
    assert n * cfg.nfft == 32_000_000 == cfg.sample_rate // 4
    assert 32_000_000 % cfg.nfft == 0 and 32_000_000 % cfg.nkurto == 0


def _levels(packed, nbit=2):
    return np.asarray(jq.unpack_bits(jnp.asarray(np.asarray(packed)),
                                     nbit)).astype(np.int16)


def _assert_rel(got, want, tol, floor=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    rel = np.abs(got - want) / np.maximum(np.abs(want), floor)
    assert rel.max() < tol, rel.max()


@pytest.mark.parametrize("channelizer", ["matmul", "pfb"])
def test_process_second_from_the_seed_matches_jax(channelizer):
    """Two seconds from the port's seeded state in both packages (the JAX
    state takes the port's bandpasses as numpy): the chain bar."""
    cfg = PipelineConfig.tiny(rfi_mode=2, channelizer=channelizer, nbit=2,
                              ema_impl="scan")
    secs = [_noise(cfg.sample_rate, 40 + i,
                   bursts=(cfg.seg_samps - 2000, 300_000)) for i in range(2)]
    st_t = tdsp.seed_bandpass(_t(cfg), torch.from_numpy(secs[0]),
                              tdsp.init_state(_t(cfg), "cpu"))
    st_j = jdsp.init_state(cfg)._replace(bp=jnp.asarray(st_t.bp.numpy()),
                                         bp_kur=jnp.asarray(
                                             st_t.bp_kur.numpy()))
    for raw in secs:
        oj, st_j = jdsp.process_second(cfg, jnp.asarray(raw), st_j,
                                       jnp.asarray(False))
        ot, st_t = tdsp.process_second(_t(cfg), torch.from_numpy(raw), st_t,
                                       False)
        for field in ("packed", "packed_kur"):
            la, lb = _levels(getattr(ot, field)), _levels(getattr(oj, field))
            assert la.shape == lb.shape
            assert (la == lb).mean() >= 0.9999, (la == lb).mean()
        _assert_rel(ot.weights.numpy(), oj.weights, 1e-6)
        assert ot.weights.min() < 1.0               # the bursts were flagged
        _assert_rel(st_t.bp, st_j.bp, 1e-4)
        _assert_rel(st_t.bp_kur, st_j.bp_kur, 1e-4)


def _pipe_run(cfg, scfg, secs, tmp_path, name):
    pipe = TPipe(1, cfg, scfg, out_dir=str(tmp_path), keep_ring=False,
                 write_cands=False, device="cpu")
    return pipe.run_observation(
        ((1.6e9 + s, buf) for s, buf in enumerate(secs)),
        TDoc(name=name, start_time=1.6e9), write_fil=False)


# 984 searched channels, a tile of 20 spectra (seg_per_sec 100): enough
# channels for the tile seed's ~5% bias to rise above threshold
WIDE = dict(nbit=2, sample_rate=4_000_000, nfft=2000, seg_per_sec=100,
            chanmax=999)


def _noise_seconds(cfg, seed, n=2):
    rng = np.random.default_rng(seed)
    return [np.clip(rng.standard_normal((cfg.npol_in, cfg.sample_rate))
                    / 0.05914 + 128.5, 0, 255).astype(np.uint8)
            for _ in range(n)]


def _early(seed, tmp_path, **kw):
    """The candidates above threshold in the first 0.5 s of 2 s of noise
    from a cold state, at WIDE."""
    cfg = tconfig.PipelineConfig.tiny(**WIDE, **kw)
    scfg = tconfig.SearchConfig.tiny()
    assert cfg.ffts_per_seg == 20 and cfg.nchanout == 984
    prod = _pipe_run(cfg, scfg, _noise_seconds(cfg, 100 + seed), tmp_path,
                     "NOISE")
    return [c for c in prod.candidates
            if c.peak_time < 0.5 and c.snr > scfg.snr_thresh]


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_noise_raises_nothing_at_the_start(tmp_path, seed):
    """Noise alone: the port raises no candidate above threshold in the
    first 0.5 s of an observation."""
    early = _early(seed, tmp_path)
    assert not early, early


@pytest.mark.parametrize("channelizer", ["matmul", "pfb"])
def test_the_tile_seed_alone_raises_the_start_up_transient(
        tmp_path, monkeypatch, channelizer):
    """The same noise with seed_bandpass taken out: the programs seed
    each zero entry from their first tile of 20 spectra, as the JAX
    package's do (with 'pfb' 3 of them partial), and a candidate rises
    clear of the threshold (6) in the first 0.1 s."""
    monkeypatch.setattr(tdsp, "seed_bandpass", lambda cfg, raw, st: st)
    early = _early(1, tmp_path, channelizer=channelizer)
    assert any(c.peak_time < 0.1 and c.snr > 6.5 for c in early), early


def test_pfb_finds_the_frb_armed_at_second_0(tmp_path):
    """channelizer='pfb', an FRB (DM 60, amplitude 1.035) armed at the
    top of second 0: the port's only candidate above threshold in the
    first 0.5 s is the FRB.  With the tile seed (the test above) the
    start-up transient rises there, about as strong as this FRB."""
    cfg = tconfig.PipelineConfig.tiny(
        **WIDE, channelizer="pfb", inject_frb=True, inject_dm=60.0,
        inject_amp=1.035, inject_width_s=8e-3)
    scfg = tconfig.SearchConfig.tiny()
    early = [c for c in _pipe_run(cfg, scfg, _noise_seconds(cfg, 17),
                                  tmp_path, "PFB0").candidates
             if c.peak_time < 0.5 and c.snr > scfg.snr_thresh]
    assert len(early) == 1, early
    assert abs(early[0].dm - 60.0) < 5.0 and early[0].snr > 7.0, early
