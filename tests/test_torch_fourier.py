"""The port's Fourier dedispersion (ops/dedisperse.dedisperse_fourier) and
the search's 'fourier' engine against the JAX package's, on the CPU.

Bar: the JAX package's own for its Fourier engine,
allclose(rtol=2e-3, atol=2e-2) against the direct shift-and-sum oracle
and against the subband engine (tests/test_dedisperse.py); the gulp
search gives the JAX engine's candidates (the same trial, sample and
width; S/N within 1e-3 relative, the two FFT libraries round
differently).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlite_fast_tpu.config import SearchConfig
from vlite_fast_tpu.models import search as jsearch
from vlite_fast_tpu.ops import dedisperse as jdd
from vlite_fast_tpu_torch import config as tconfig
from vlite_fast_tpu_torch import interop
from vlite_fast_tpu_torch.models import search as tsearch
from vlite_fast_tpu_torch.ops import dedisperse as tdd
from vlite_fast_tpu_torch.ops import dedisperse_pallas as tddp
from vlite_fast_tpu_torch.ops import quantize as tq

torch.set_num_threads(1)

TOL = dict(rtol=2e-3, atol=2e-2)


def _fb(ntime=800, nchan=64, dm=150.0, t0=100, amp=5.0, seed=0,
        tsamp=2e-3):
    """Unit-variance noise and a dispersed pulse of per-channel amp
    (tests/test_dedisperse.py's make_fb)."""
    rng = np.random.default_rng(seed)
    fb = rng.standard_normal((ntime, nchan)).astype(np.float32)
    freqs = 384.0 - np.arange(nchan) * (4.0 / nchan)
    delays = jdd.delay_table(np.array([dm]), freqs, tsamp)[0]
    for ch in range(nchan):
        if t0 + delays[ch] < ntime:
            fb[t0 + delays[ch], ch] += amp
    return fb, freqs


def _plans(dms, freqs, **kw):
    pj = jdd.make_plan(dms, freqs, 2e-3, **kw)
    return interop.plan_from_jax(pj, device="cpu"), pj


@pytest.mark.parametrize("phase_table", [False, True])
def test_fourier_matches_oracle(phase_table):
    fb, freqs = _fb()
    dms = jdd.dm_grid(0, 300, 32)
    pt, _ = _plans(dms, freqs, nsub=16, nbatch=32)
    ntime_out = fb.shape[0] - pt.max_delay
    got = tdd.dedisperse_fourier(torch.from_numpy(fb), pt, ntime_out,
                                 batch_chunk=8, phase_table=phase_table)
    ref = jdd.dedisperse_reference(fb, jdd.delay_table(dms, freqs, 2e-3),
                                   ntime_out)
    assert got.shape == (32, ntime_out) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("batch_chunk", [8, 5, 64])
def test_fourier_matches_jax(batch_chunk):
    """Against the JAX function on the same plan, chunks that do and do
    not divide the 16 batches; and against the port's subband engine."""
    fb, freqs = _fb(ntime=600, nchan=32, seed=1)
    dms = jdd.dm_grid(0, 300, 64)
    pt, pj = _plans(dms, freqs, nsub=8, nbatch=16)
    ntime_out = fb.shape[0] - pt.max_delay
    got = tdd.dedisperse_fourier(torch.from_numpy(fb), pt, ntime_out,
                                 batch_chunk=batch_chunk).numpy()
    want = np.asarray(jdd.dedisperse_fourier(jnp.asarray(fb), pj, ntime_out,
                                             batch_chunk=8))
    np.testing.assert_allclose(got, want, **TOL)
    sub = tdd.dedisperse(torch.from_numpy(fb), pt, ntime_out).numpy()
    np.testing.assert_allclose(got, sub, **TOL)


NCHAN = 256
TSAMP = 2e-3
FREQS = np.linspace(400.0, 350.0, NCHAN)


def _engines(engine="fourier"):
    scfg = SearchConfig(dm_min=0.0, dm_max=100.0, ndm=64, gulp_samps=256,
                        boxcar_max=16, zap_ranges=((0, 10),),
                        snr_thresh=6.0, engine=engine)
    tcfg = tconfig.SearchConfig(**dataclasses.asdict(scfg))
    return (tsearch.SinglePulseSearch(tcfg, TSAMP, FREQS, nsub=64,
                                      nbatch=16, device="cpu"),
            jsearch.SinglePulseSearch(scfg, TSAMP, FREQS, nsub=64,
                                      nbatch=16))


def _pulsed(eng, ntime, seed, at=(120, 700), dm_index=40):
    rng = np.random.default_rng(seed)
    fb = rng.standard_normal((ntime, NCHAN)).astype(np.float32)
    delays = tdd.delay_table(eng.dms[dm_index:dm_index + 1], FREQS,
                             TSAMP)[0]
    for t0 in at:
        rows = t0 + np.asarray(delays, dtype=np.int64)
        keep = rows < ntime
        fb[rows[keep], np.arange(NCHAN)[keep]] += 3.0
    return fb


def _same(got, want, dm_index=40):
    key = lambda cs: sorted((c.dmi, c.peak_idx, c.tfilt) for c in cs)
    assert want and key(got) == key(want)
    np.testing.assert_allclose(sorted(c.snr for c in got),
                               sorted(c.snr for c in want), rtol=1e-3)
    best = max(got, key=lambda c: c.snr)
    assert abs(best.dmi - dm_index) <= 1


def test_fourier_gulp_float_matches_jax():
    """A gulp 40 rows short, searched at its own length in both
    (jax_true_length: the JAX engine as shipped pads it)."""
    from jax_true_length import true_length
    te, je = _engines()
    fb = _pulsed(te, te.scfg.gulp_samps + te.overlap - 40, 41)
    with true_length():
        _same(te.search_gulp(fb, t_offset=100),
              je.search_gulp(fb, t_offset=100))
    assert te.last_gulp_stats == je.last_gulp_stats


@pytest.mark.parametrize("nbit", [2, 8])
def test_fourier_gulp_packed_matches_jax(nbit):
    te, je = _engines()
    fb = _pulsed(te, te.scfg.gulp_samps + te.overlap, 44)
    packed = tq.sel_and_dig(torch.from_numpy(fb)[None], 0, NCHAN - 1,
                            nbit).numpy()
    _same(te.search_gulp_packed(packed, nbit, t_offset=0),
          je.search_gulp_packed(packed, nbit, t_offset=0))


def test_fourier_snr_cube_and_stream_match_jax():
    from jax_true_length import true_length
    te, je = _engines()
    fb = _pulsed(te, te.scfg.gulp_samps + te.overlap, 42)
    got, want = te.snr_cube(fb).numpy(), np.asarray(je.snr_cube(fb))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    fb = _pulsed(te, 3 * te.scfg.gulp_samps + 150, 43,
                 at=(100, 400, 650, 900))
    with true_length():           # the ragged tail at its own length
        _same(te.search_stream(fb), je.search_stream(fb))


@pytest.mark.parametrize("engine", ["auto", "pallas", "subband", "fourier"])
def test_engine_routing(monkeypatch, engine):
    """'fourier' goes through dedisperse_fourier; every other engine
    through the fold kernel's entries (their plain versions here)."""
    calls = []
    real_f, real_p = tdd.dedisperse_fourier, tddp.dedisperse_pallas_packed
    monkeypatch.setattr(tdd, "dedisperse_fourier",
                        lambda *a, **k: calls.append("fourier")
                        or real_f(*a, **k))
    monkeypatch.setattr(tddp, "dedisperse_pallas_packed",
                        lambda *a, **k: calls.append("fold")
                        or real_p(*a, **k))
    te, _ = _engines(engine)
    fb = _pulsed(te, te.scfg.gulp_samps + te.overlap, 45)
    packed = tq.sel_and_dig(torch.from_numpy(fb)[None], 0, NCHAN - 1,
                            2).numpy()
    assert te.search_gulp_packed(packed, 2)
    assert calls == ["fourier" if engine == "fourier" else "fold"]
