"""The port's chain primitives against the JAX package's, on the CPU.

Same inputs (seeded numpy) through vlite_fast_tpu.ops.* and
vlite_fast_tpu_torch.ops.*.  Bars: quantize/pack/unpack/sel_and_dig
byte-exact, and so is genbase's digitizer; kurtosis flags and weights
equal; the sequential EMA within
rtol 1e-5 (same recurrence, f32 summation order of the seed mean may
differ); channelize within 1e-4 of the peak (f32 DFTs with different
summation orders); injection exact.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vlite_fast_tpu.config import PipelineConfig
from vlite_fast_tpu.ops import channelize as jch
from vlite_fast_tpu.ops import injection as jinj
from vlite_fast_tpu.ops import kurtosis as jkur
from vlite_fast_tpu.ops import normalize as jnorm
from vlite_fast_tpu.ops import quantize as jq
from vlite_fast_tpu.ops import unpack as junpack
from vlite_fast_tpu_torch.ops import channelize as tch
from vlite_fast_tpu_torch.ops import injection as tinj
from vlite_fast_tpu_torch.ops import kurtosis as tkur
from vlite_fast_tpu_torch.ops import normalize as tnorm
from vlite_fast_tpu_torch.ops import quantize as tq
from vlite_fast_tpu_torch.ops import unpack as tunpack

torch.set_num_threads(1)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_convert_uint8_exact():
    u = np.arange(256, dtype=np.uint8)[None].repeat(2, 0)
    assert np.array_equal(_np(tunpack.convert_uint8(torch.from_numpy(u))),
                          _np(junpack.convert_uint8(jnp.asarray(u))))


@pytest.mark.parametrize("scale,offset", [(0.02957 * 2, 128.5),
                                          (0.05, 100.0)])
def test_digitize_uint8_byte_exact(scale, offset):
    """genbase's digitizer, across and beyond the 8-bit range."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 50_000)) * 3).astype(np.float32)
    x[0, :4] = (-1e3, 1e3, 0.0, -0.0)
    got = tunpack.digitize_uint8(torch.from_numpy(x), scale, offset)
    assert got.dtype == torch.uint8
    assert np.array_equal(_np(got), _np(junpack.digitize_uint8(
        jnp.asarray(x), scale, offset)))


@pytest.mark.parametrize("nbit", [2, 4, 8])
def test_quantize_pack_sel_and_dig_byte_exact(nbit):
    rng = np.random.default_rng(nbit)
    x = (rng.standard_normal((2, 12, 64)) * 1.5).astype(np.float32)
    qt = {2: tq.quantize_2bit, 4: tq.quantize_4bit, 8: tq.quantize_8bit}
    qj = {2: jq.quantize_2bit, 4: jq.quantize_4bit, 8: jq.quantize_8bit}
    lev_t = qt[nbit](torch.from_numpy(x))
    lev_j = qj[nbit](jnp.asarray(x))
    assert np.array_equal(_np(lev_t), _np(lev_j))
    packed_t = tq.pack_bits(lev_t, nbit)
    packed_j = jq.pack_bits(lev_j, nbit)
    assert np.array_equal(_np(packed_t), _np(packed_j))
    assert np.array_equal(_np(tq.unpack_bits(packed_t, nbit)),
                          _np(jq.unpack_bits(packed_j, nbit)))
    assert np.array_equal(_np(tq.dequantize(packed_t, nbit)),
                          _np(jq.dequantize(packed_j, nbit)))
    # chanmin not a multiple of 4: packing starts at chanmin
    got = tq.sel_and_dig(torch.from_numpy(x), 3, 50, nbit)
    want = jq.sel_and_dig(jnp.asarray(x), 3, 50, nbit)
    assert np.array_equal(_np(got), _np(want))
    assert tq.NEAR_ZERO_FILL == jq.NEAR_ZERO_FILL


@pytest.mark.parametrize("dag_fb_thresh", [0.0, 5.0])
def test_kurtosis_flags_and_weights_equal(dag_fb_thresh):
    cfg = PipelineConfig.tiny()
    rng = np.random.default_rng(5)
    raw = np.clip(rng.standard_normal((2, 20 * cfg.nfft)) / 0.05914
                  + 128.5, 0, 255).astype(np.uint8)
    raw[0, 3000:3400:7] = 250              # impulsive RFI -> flags
    raw[1, 7000:7100] = 0                  # a gap -> kur 0 windows
    x = junpack.convert_uint8(jnp.asarray(raw))
    rj = jkur.rfi_excise(x, cfg.nkurto, cfg.nfft,
                         dag_fb_thresh=dag_fb_thresh)
    rt = tkur.rfi_excise(torch.from_numpy(np.array(x)), cfg.nkurto,
                         cfg.nfft, dag_fb_thresh=dag_fb_thresh)
    assert np.array_equal(_np(rt.dag) >= cfg.dag_thresh,
                          _np(rj.dag) >= cfg.dag_thresh)
    assert (_np(rt.dag) >= cfg.dag_thresh).any()
    assert np.array_equal(_np(rt.weights), _np(rj.weights))
    assert np.array_equal(_np(rt.masked), _np(rj.masked))
    np.testing.assert_allclose(_np(rt.dag), _np(rj.dag), rtol=1e-4)


def _powers(seed, shape=(2, 32, 40)):
    rng = np.random.default_rng(seed)
    return (rng.chisquare(2, size=shape) * 3.0).astype(np.float32)


def test_ema_plain_matches_scan():
    p = _powers(1)
    bp = np.zeros((2, 40), np.float32)
    bp[:, ::3] = 2.5                          # some carried, some seeded
    scale = PipelineConfig().bp_scale
    ot, bt = tnorm.normalize_ema(torch.from_numpy(p), torch.from_numpy(bp),
                                 scale)
    oj, bj = jnorm.normalize_ema(jnp.asarray(p), jnp.asarray(bp), scale)
    np.testing.assert_allclose(_np(ot), _np(oj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(bt), _np(bj), rtol=1e-5)


def test_ema_weighted_matches_scan():
    p = _powers(2)
    p[0, 5, :7] *= 40.0                       # clipped spectra
    w = np.ones((2, 32), np.float32)
    w[:, 10:14] = 0.0                         # excised spectra
    w[1, 20] = 0.4
    bp = np.zeros((2, 40), np.float32)
    bp[:, :10] = 30.0                         # stale carry -> re-seed
    bp[:, 10:20] = 6.0
    scale = PipelineConfig().bp_scale
    ot, bt = tnorm.normalize_ema_weighted(
        torch.from_numpy(p), torch.from_numpy(w), torch.from_numpy(bp),
        scale)
    oj, bj = jnorm.normalize_ema_weighted(jnp.asarray(p), jnp.asarray(w),
                                          jnp.asarray(bp), scale)
    np.testing.assert_allclose(_np(ot), _np(oj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(bt), _np(bj), rtol=1e-5)


def test_scrunches_match():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 24)).astype(np.float32)
    w = rng.uniform(0, 1, (2, 16)).astype(np.float32)
    w[:, :3] = 0.0
    np.testing.assert_allclose(_np(tnorm.pscrunch(torch.from_numpy(x))),
                               _np(jnorm.pscrunch(jnp.asarray(x))),
                               rtol=1e-6)
    np.testing.assert_allclose(
        _np(tnorm.tscrunch(torch.from_numpy(x), 8)),
        _np(jnorm.tscrunch(jnp.asarray(x), 8)), rtol=1e-5, atol=1e-6)
    ot, wt = tnorm.pscrunch_weights(torch.from_numpy(x), torch.from_numpy(w))
    oj, wj = jnorm.pscrunch_weights(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(_np(ot), _np(oj), rtol=1e-6)
    assert np.array_equal(_np(wt), _np(wj))
    np.testing.assert_allclose(
        _np(tnorm.tscrunch_weights(ot, wt, 4)),
        _np(jnorm.tscrunch_weights(oj, wj, 4)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("method", ["fft", "matmul"])
@pytest.mark.parametrize("nfft", [500, 2048])
def test_channelize_matches(method, nfft):
    rng = np.random.default_rng(nfft)
    raw = rng.integers(0, 256, size=(2, 6 * nfft), dtype=np.uint8)
    x = np.array(junpack.convert_uint8(jnp.asarray(raw)))
    st = _np(tch.channelize(torch.from_numpy(x), nfft, method=method))
    sj = _np(jch.channelize(jnp.asarray(x), nfft, method=method,
                            precision="highest"))
    assert st.shape == sj.shape
    peak = np.abs(sj).max()
    assert np.abs(st - sj).max() <= 1e-4 * peak


def test_injection_exact():
    cfg = PipelineConfig.tiny(inject_dm=40.0)
    nspec = cfg.ffts_per_seg
    d = jinj.frb_delays(cfg.nchan, 40.0, cfg.seg_per_sec * nspec,
                        0.3205, 0.0005)
    assert np.array_equal(d, tinj.frb_delays(cfg.nchan, 40.0,
                                             cfg.seg_per_sec * nspec,
                                             0.3205, 0.0005))
    rng = np.random.default_rng(4)
    spec = (rng.standard_normal((2, nspec, cfg.nchan))
            + 1j * rng.standard_normal((2, nspec, cfg.nchan))
            ).astype(np.complex64)
    for since in (0, 3, 40):
        st = tinj.inject_frb(torch.from_numpy(spec), torch.from_numpy(d),
                             since, 20.48, 1.05)
        sj = jinj.inject_frb(jnp.asarray(spec), jnp.asarray(d), since,
                             20.48, 1.05)
        assert np.array_equal(_np(st), _np(sj))
