"""The port's search stage against the JAX package's, on the CPU.

Bars: plan tables equal; dedispersion allclose(rtol=1e-5, atol=1e-4)
against both JAX engines (the gather engine and the Pallas kernel in
interpret mode; the sums of the same f32 terms are taken in different
orders); boxcar S/N rtol 1e-5 (atol 1e-5 for S/N near zero, where the
cumulative sums' rounding is absolute); top-k crossings identical.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vlite_fast_tpu.config import SearchConfig
from vlite_fast_tpu.models import search as jsearch
from vlite_fast_tpu.ops import dedisperse as jdd
from vlite_fast_tpu.ops import dedisperse_pallas as jddp
from vlite_fast_tpu_torch import interop
from vlite_fast_tpu_torch.models import search as tsearch
from vlite_fast_tpu_torch.ops import dedisperse as tdd
from vlite_fast_tpu_torch.ops import dedisperse_pallas as tddp

torch.set_num_threads(1)

NCHAN = 256
TSAMP = 2e-3
FREQS = np.linspace(400.0, 350.0, NCHAN)


def _grid(mode):
    scfg = SearchConfig(dm_min=0.0, dm_max=100.0, ndm=64,
                        dm_grid_mode=mode)
    dms = tsearch.make_dm_grid(scfg, TSAMP, FREQS)
    assert np.array_equal(dms, jsearch.make_dm_grid(scfg, TSAMP, FREQS))
    return dms


def _plans(mode, nsub, nbatch=16):
    dms = _grid(mode)
    kw = dict(nsub=nsub, nbatch=nbatch, zap_ranges=((0, 10), (200, 210)))
    return (tdd.make_plan(dms, FREQS, TSAMP, **kw),
            jdd.make_plan(dms, FREQS, TSAMP, **kw))


@pytest.mark.parametrize("mode", ["linear", "tol"])
def test_plan_from_jax_equal(mode):
    pt, pj = _plans(mode, 64)
    pi = interop.plan_from_jax(pj)
    for name in ("rel_delays", "sub_delays", "batch_of_dm", "chan_weights"):
        a, b = getattr(pt, name).numpy(), getattr(pi, name).numpy()
        assert np.array_equal(a, np.asarray(getattr(pj, name))), name
        assert np.array_equal(b, a) and b.dtype == a.dtype, name
    for name in ("dms", "max_delay", "max_sub_delay", "nsub", "nchan_eff",
                 "rel_delays_max"):
        assert getattr(pt, name) == getattr(pj, name) == getattr(pi, name)


@pytest.mark.parametrize("nsub", [64, 128])
@pytest.mark.parametrize("mode", ["linear", "tol"])
def test_dedisperse_matches_jax_engines(mode, nsub):
    pt, pj = _plans(mode, nsub)
    rng = np.random.default_rng(nsub)
    ntime_out = 300
    fb = rng.standard_normal((ntime_out + pt.max_delay, NCHAN)).astype(
        np.float32)
    got = tddp.dedisperse_pallas(torch.from_numpy(fb), pt, ntime_out)
    assert tddp.LAUNCHES == 0                 # CPU: the plain version
    got = got.numpy()
    want_gather = np.asarray(jdd.dedisperse(jnp.asarray(fb), pj, ntime_out))
    want_pallas = np.asarray(jddp.dedisperse_pallas(jnp.asarray(fb), pj,
                                                    ntime_out))
    assert got.shape == (len(pt.dms), ntime_out)
    np.testing.assert_allclose(got, want_gather, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, want_pallas, rtol=1e-5, atol=1e-4)


def test_boxcar_snr_even_ntime():
    rng = np.random.default_rng(3)
    dmt = (rng.standard_normal((24, 1000)) * 8.0).astype(np.float32)
    dmt[5, 400:404] += 60.0
    widths = (1, 2, 4, 8, 16)
    got = tdd.boxcar_snr(torch.from_numpy(dmt), 200.0, widths).numpy()
    want = np.asarray(jdd.boxcar_snr(jnp.asarray(dmt), 200.0, widths))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_topk_banded_decode_identical_hits():
    rng = np.random.default_rng(9)
    snr = rng.standard_normal((4, 32, 200)).astype(np.float32) * 2.0
    snr[1, 3:6, 50:54] += 9.0
    snr[3, 28, 120] = 15.0
    shape = snr.shape
    pt = tsearch.pack_topk_banded(torch.from_numpy(snr), 256, 8, 6.0)
    pj = jsearch.pack_topk_banded(jnp.asarray(snr), 256, 8, 6.0)
    vt, ht, nt, st = tsearch.decode_crossings(pt.numpy(), *shape, 8, 6.0)
    vj, hj, nj, sj = jsearch.decode_crossings(np.asarray(pj), *shape, 8,
                                              6.0)
    assert (nt, st) == (nj, sj) and nt > 0
    key = lambda h, v: sorted(zip(map(tuple, h.tolist()), v.tolist()))
    assert key(ht, vt) == key(hj, vj)
    ct = tdd.cluster_hits(ht, vt, np.arange(32.0), TSAMP,
                          widths=(1, 2, 4, 8))
    cj = jdd.cluster_hits(hj, vj, np.arange(32.0), TSAMP,
                          widths=(1, 2, 4, 8))
    assert [tuple(c) for c in ct] == [tuple(c) for c in cj]


@pytest.mark.parametrize("nbit", [2, 4, 8])
def test_filterbank_from_packed_matches(nbit):
    rng = np.random.default_rng(nbit)
    packed = rng.integers(0, 256, size=(20, 48), dtype=np.uint8)
    nchanout = 48 * 8 // nbit - 4
    assert np.array_equal(
        tsearch.filterbank_from_packed(packed, nbit, nchanout),
        jsearch.filterbank_from_packed(packed, nbit, nchanout))
