"""The port's search stage against the JAX package's, on the CPU.

Bars: plan tables equal; dedispersion allclose(rtol=1e-5, atol=1e-4)
against both JAX engines (the gather engine and the Pallas kernel in
interpret mode; the sums of the same f32 terms are taken in different
orders); boxcar S/N rtol 1e-5 (atol 1e-5 for S/N near zero, where the
cumulative sums' rounding is absolute); top-k crossings identical;
find_candidates' candidates equal, field for field, on the same S/N cube.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vlite_fast_tpu.config import SearchConfig
from vlite_fast_tpu.models import search as jsearch
from vlite_fast_tpu.ops import dedisperse as jdd
from vlite_fast_tpu.ops import dedisperse_pallas as jddp
from vlite_fast_tpu.ops import quantize as jq
from vlite_fast_tpu_torch import config as tconfig
from vlite_fast_tpu_torch import interop
from vlite_fast_tpu_torch.models import search as tsearch
from vlite_fast_tpu_torch.ops import dedisperse as tdd
from vlite_fast_tpu_torch.ops import dedisperse_pallas as tddp
from vlite_fast_tpu_torch.ops import quantize as tq

torch.set_num_threads(1)

NCHAN = 256
TSAMP = 2e-3
FREQS = np.linspace(400.0, 350.0, NCHAN)


def _grid(mode):
    scfg = SearchConfig(dm_min=0.0, dm_max=100.0, ndm=64,
                        dm_grid_mode=mode)
    dms = tsearch.make_dm_grid(
        tconfig.SearchConfig(**dataclasses.asdict(scfg)), TSAMP, FREQS)
    assert np.array_equal(dms, jsearch.make_dm_grid(scfg, TSAMP, FREQS))
    return dms


def _plans(mode, nsub, nbatch=16):
    dms = _grid(mode)
    kw = dict(nsub=nsub, nbatch=nbatch, zap_ranges=((0, 10), (200, 210)))
    return (tdd.make_plan(dms, FREQS, TSAMP, device="cpu", **kw),
            jdd.make_plan(dms, FREQS, TSAMP, **kw))


@pytest.mark.parametrize("mode", ["linear", "tol"])
def test_plan_from_jax_equal(mode):
    pt, pj = _plans(mode, 64)
    pi = interop.plan_from_jax(pj, device="cpu")
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


def test_plan_batch_spread_and_min():
    """sub_spread (the stage-2 kernel's staged span) and rel_delays_min
    from the tables, equal through plan_from_jax."""
    pt, pj = _plans("tol", 64)
    pi = interop.plan_from_jax(pj, device="cpu")
    nbatch = pt.rel_delays.shape[0]
    sd = pt.sub_delays.numpy().reshape(nbatch, -1, pt.nsub)
    assert pt.sub_spread == int((sd.max(1) - sd.min(1)).max()) > 0
    assert pt.rel_delays_min == int(pt.rel_delays.min()) >= 0
    assert (pi.sub_spread, pi.rel_delays_min) == (pt.sub_spread,
                                                  pt.rel_delays_min)
    odd = tdd.batch_sub_spread(pt.sub_delays.numpy(),
                               pt.batch_of_dm.numpy()[::-1], nbatch)
    assert odd == -1                        # batches not d // per_batch


@pytest.mark.parametrize("nbit", [2, 4])
def test_packed_dedisperse_matches_jax_gulp_path(nbit):
    """The packed entry's plain route (dequantize, first nchan channels,
    the gather engine) against the JAX _device_gulp's dequantize and
    dd.dedisperse, on seeded rows holding more channels than nchan."""
    pt, pj = _plans("tol", 64)
    rng = np.random.default_rng(20 + nbit)
    ntime_out = 300
    packed = rng.integers(0, 256, (ntime_out + pt.max_delay,
                                   NCHAN * nbit // 8 + 2), dtype=np.uint8)
    got = tddp.dedisperse_pallas_packed(torch.from_numpy(packed), nbit,
                                        NCHAN, pt, ntime_out)
    assert tddp.PACKED_LAUNCHES == tddp.LAUNCHES == 0   # CPU: plain
    fb = jq.dequantize(jnp.asarray(packed), nbit)
    fb = fb.reshape(fb.shape[0], -1)[:, :NCHAN].astype(jnp.float32)
    want = np.asarray(jdd.dedisperse(fb, pj, ntime_out))
    assert got.shape == (len(pt.dms), ntime_out)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_packed_entry_plain_route_equals_f32_route():
    pt, _ = _plans("linear", 128)
    rng = np.random.default_rng(31)
    ntime_out = 200
    packed = torch.from_numpy(rng.integers(
        0, 256, (ntime_out + pt.max_delay, NCHAN // 4), dtype=np.uint8))
    fb = tq.dequantize(packed, 2).reshape(packed.shape[0], -1)
    got = tddp.dedisperse_pallas_packed(packed, 2, NCHAN, pt, ntime_out)
    assert torch.equal(got, tddp.dedisperse_pallas(fb, pt, ntime_out))


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


@pytest.mark.parametrize("case", range(6))
def test_cluster_hits_as_the_jax_loop(case):
    """The port's friends-of-friends on whole arrays gives the JAX
    package's sweep-line loop's candidates, field for field and in order:
    sparse and dense hits, S/N ties, DM links 0-5, time gaps 0-3, a cap
    on the candidates, a time offset below and above zero."""
    rng = np.random.default_rng(100 + case)
    dms = np.linspace(2.0, 1000.0, 256)
    for trial in range(60):
        n = int(rng.integers(1, 600))
        ndm, nt = int(rng.integers(1, 48)), int(rng.integers(4, 400))
        hits = np.stack([rng.integers(0, 5, n), rng.integers(0, ndm, n),
                         rng.integers(0, nt, n)], axis=1)
        vals = (rng.choice([6.5, 7.0, 9.5], n) if trial % 2
                else rng.uniform(6.0, 30.0, n)).astype(np.float32)
        kw = dict(widths=(1, 2, 4, 8, 16), t_offset=int(rng.integers(-99,
                                                                    999)),
                  max_cands=int(rng.integers(1, 40)) if trial % 3 == 0
                  else 4096, dm_link=int(rng.integers(0, 6)),
                  time_gap=int(rng.integers(0, 4)))
        got = tdd.cluster_hits(hits, vals, dms, TSAMP, **kw)
        want = jdd.cluster_hits(hits, vals, dms, TSAMP, **kw)
        assert [tuple(c) for c in got] == [tuple(c) for c in want]
        assert [tuple(map(type, c)) for c in got] == \
            [tuple(map(type, c)) for c in want]
    assert tdd.cluster_hits(np.zeros((0, 3), np.int64),
                            np.zeros(0, np.float32), dms, TSAMP) == []


@pytest.mark.parametrize("nbit", [2, 4, 8])
def test_filterbank_from_packed_matches(nbit):
    rng = np.random.default_rng(nbit)
    packed = rng.integers(0, 256, size=(20, 48), dtype=np.uint8)
    nchanout = 48 * 8 // nbit - 4
    assert np.array_equal(
        tsearch.filterbank_from_packed(packed, nbit, nchanout),
        jsearch.filterbank_from_packed(packed, nbit, nchanout))


def _engines(**kw):
    """The same SearchConfig's engine in each package (the port's on the
    CPU), at the tests' small geometry."""
    scfg = SearchConfig(dm_min=0.0, dm_max=100.0, ndm=64, gulp_samps=256,
                        boxcar_max=16, zap_ranges=((0, 10),),
                        snr_thresh=6.0, **kw)
    tcfg = tconfig.SearchConfig(**dataclasses.asdict(scfg))
    return (tsearch.SinglePulseSearch(tcfg, TSAMP, FREQS, nsub=64,
                                      nbatch=16, device="cpu"),
            jsearch.SinglePulseSearch(scfg, TSAMP, FREQS, nsub=64,
                                      nbatch=16))


def _pulsed(eng, ntime, seed, at=(120, 700), dm_index=40):
    """Seeded noise with dispersed pulses at the plan's delays of one
    trial, so that candidates clear the threshold."""
    rng = np.random.default_rng(seed)
    fb = rng.standard_normal((ntime, NCHAN)).astype(np.float32)
    delays = tdd.delay_table(eng.dms[dm_index:dm_index + 1], FREQS,
                             TSAMP)[0]
    for t0 in at:
        rows = t0 + np.asarray(delays, dtype=np.int64)
        keep = rows < ntime
        fb[rows[keep], np.arange(NCHAN)[keep]] += 3.0
    return fb


def _same(got, want):
    key = lambda cs: sorted((c.dmi, c.peak_idx, c.tfilt, c.i0, c.i1)
                            for c in cs)
    assert want and key(got) == key(want)
    np.testing.assert_allclose(sorted(c.snr for c in got),
                               sorted(c.snr for c in want), rtol=1e-4)


@pytest.mark.parametrize("dtype", [np.float16, np.float32])
def test_search_gulp_matches_jax(dtype):
    """search_gulp on a float gulp (the coadd stream's float16, or f32),
    40 rows short of a full gulp: the port searches it at its own length,
    with the same candidates as the JAX engine's search of those rows
    (jax_true_length); the JAX engine as shipped pads the gulp with
    zeros and reads each S/N against a lower noise."""
    from jax_true_length import true_length
    te, je = _engines()
    fb = _pulsed(te, te.scfg.gulp_samps + te.overlap - 40, 41).astype(dtype)
    got = te.search_gulp(fb, t_offset=100)
    assert tddp.LAUNCHES == 0                 # CPU: the plain version
    padded = je.search_gulp(fb, t_offset=100)
    with true_length():
        _same(got, je.search_gulp(fb, t_offset=100))
    assert te.last_gulp_stats == je.last_gulp_stats
    # the departure: the same clusters, each read hotter in the padded gulp
    snr = lambda cs: np.array([c.snr for c in sorted(
        cs, key=lambda c: (c.dmi, c.peak_idx, c.tfilt))])
    assert len(padded) == len(got)
    assert (snr(padded) > snr(got) * 1.001).all()


def test_host_seconds_sum_every_gulps_parts():
    """host_seconds holds GULP_HOST_PARTS, each summed over the gulps
    searched: it grows with each gulp, whatever its entry, and searching
    changes none of the candidates."""
    te, _ = _engines()
    assert tuple(te.host_seconds) == tsearch.GULP_HOST_PARTS
    assert not any(te.host_seconds.values())
    fb = _pulsed(te, te.scfg.gulp_samps + te.overlap, 43)
    first = te.search_gulp(fb)
    once = dict(te.host_seconds)
    assert once["dispatch"] > 0 and once["decode"] > 0
    assert once["cluster"] > 0 and once["fetch"] >= 0
    packed = tq.sel_and_dig(torch.from_numpy(fb)[None], 0, NCHAN - 1,
                            2).numpy()
    te.search_gulp_packed(packed, 2)
    assert all(te.host_seconds[k] > once[k] for k in ("dispatch", "decode",
                                                      "cluster"))
    _same(te.search_gulp(fb), first)


def test_snr_cube_matches_jax():
    te, je = _engines()
    fb = _pulsed(te, te.scfg.gulp_samps + te.overlap, 42)
    got = te.snr_cube(fb)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    want = np.asarray(je.snr_cube(fb))
    assert got.shape == want.shape == (len(te.widths), len(te.dms),
                                       te.scfg.gulp_samps)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_search_stream_matches_jax():
    """A filterbank of several gulps and a ragged tail, the tail searched
    at its own length in both (jax_true_length)."""
    from jax_true_length import true_length
    te, je = _engines()
    fb = _pulsed(te, 3 * te.scfg.gulp_samps + 150, 43,
                 at=(100, 400, 650, 900))
    with true_length():
        _same(te.search_stream(fb), je.search_stream(fb))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("nant", [2, 3, 8])
def test_coadd_matches_jax(nant, weighted):
    from vlite_fast_tpu.models import coadd as jcoadd
    from vlite_fast_tpu_torch.models import coadd as tcoadd
    rng = np.random.default_rng(nant)
    fbs = rng.standard_normal((nant, 64, 48)).astype(np.float32)
    w = rng.uniform(0.2, 2.0, nant).astype(np.float32) if weighted else None
    got = tcoadd.coadd(torch.from_numpy(fbs),
                       None if w is None else torch.from_numpy(w))
    want = np.asarray(jcoadd.coadd(jnp.asarray(fbs),
                                   None if w is None else jnp.asarray(w)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def _cube_one_pulse():
    rng = np.random.default_rng(2)
    dmt = rng.standard_normal((16, 512)).astype(np.float32) * 8.0
    dmt[5, 200:204] += 10.0 * 8.0
    return dmt, 64.0, (1, 2, 4, 8), jdd.dm_grid(0, 150, 16), 6.0


def _cube_dispersed_blob():
    """tests/test_dedisperse.py's make_fb(amp=6.0), a pulse at DM 150 on
    a 4 MHz band, dedispersed by the gather engine: one blob of crossings
    over DM, width and time."""
    rng = np.random.default_rng(0)
    ntime, nchan = 800, 64
    fb = rng.standard_normal((ntime, nchan)).astype(np.float32)
    freqs = 384.0 - np.arange(nchan) * (4.0 / nchan)
    delays = tdd.delay_table(np.array([150.0]), freqs, TSAMP)[0]
    for ch in range(nchan):
        if 100 + delays[ch] < ntime:
            fb[100 + delays[ch], ch] += 6.0
    dms = jdd.dm_grid(0, 300, 61)
    plan = jdd.make_plan(dms, freqs, TSAMP, nsub=16, nbatch=61)
    dmt = np.asarray(jdd.dedisperse(jnp.asarray(fb), plan,
                                    ntime - plan.max_delay))
    return dmt, plan.nchan_eff, (1, 2, 4, 8), dms, 6.5


def _cube_nearby_pulses():
    rng = np.random.default_rng(5)
    dmt = rng.standard_normal((32, 800)).astype(np.float32) * 4.0
    for t0 in (300, 360):
        dmt[10:13, t0:t0 + 4] += 12.0 * 4.0
    return dmt, 16.0, (1, 2, 4, 8), jdd.dm_grid(0, 150, 32), 7.0


def _cube_distant_dms():
    rng = np.random.default_rng(6)
    dmt = rng.standard_normal((64, 400)).astype(np.float32) * 4.0
    dmt[5:8, 200:204] += 12.0 * 4.0
    dmt[50:53, 200:204] += 12.0 * 4.0
    return dmt, 16.0, (1, 2, 4), jdd.dm_grid(0, 300, 64), 7.0


@pytest.mark.parametrize("cube", [_cube_one_pulse, _cube_dispersed_blob,
                                  _cube_nearby_pulses, _cube_distant_dms])
def test_find_candidates_equal_jax(cube):
    """The cubes of tests/test_dedisperse.py's find_candidates and
    friends-of-friends tests, their S/N by the JAX boxcar."""
    dmt, nchan_eff, widths, dms, thresh = cube()
    snr = np.asarray(jdd.boxcar_snr(jnp.asarray(dmt), nchan_eff,
                                    widths=widths))
    got = tdd.find_candidates(snr, dms, TSAMP, thresh=thresh, widths=widths,
                              t_offset=7)
    want = jdd.find_candidates(snr, dms, TSAMP, thresh=thresh, widths=widths,
                               t_offset=7)
    assert len(want) >= 1
    assert [c.to_line() for c in got] == [c.to_line() for c in want]


def test_find_candidates_nothing_above_threshold():
    snr = np.zeros((2, 4, 32), np.float32)
    assert tdd.find_candidates(snr, np.arange(4.0), TSAMP) == \
        jdd.find_candidates(snr, np.arange(4.0), TSAMP) == []


@pytest.mark.parametrize("engine", ["auto", "pallas", "subband", "fourier"])
def test_resolve_engine_on_the_cpu(engine):
    assert tsearch.resolve_engine(engine, "cpu") == \
        jsearch.resolve_engine(engine)
    want = "pallas" if engine == "auto" else engine
    assert tsearch.resolve_engine(engine, torch.device("cuda", 0)) == want
    eng = tsearch.SinglePulseSearch(
        tconfig.SearchConfig.tiny(engine=engine), TSAMP, FREQS,
        device="cpu")
    assert eng.engine == tsearch.resolve_engine(engine, "cpu")
