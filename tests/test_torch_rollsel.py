"""The port's roll+select dedispersion against the JAX package's, on the CPU.

The JAX engine (dedisperse_pallas_rollsel) runs in interpret mode, as
tests/test_dedisperse.py runs the Pallas engines, at that file's
geometries: exact mode (nbatch == ndm), approximate mode (nbatch < ndm),
zapped channels, and sub_chunk 3 at nsub 8 (stage 2's subbands split
into chunks).  Bar: allclose(rtol=1e-5, atol=1e-4), the same f32 terms
summed in the same order on both sides up to XLA's own fusion.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vlite_fast_tpu.ops import dedisperse as jdd
from vlite_fast_tpu.ops import dedisperse_pallas as jddp
from vlite_fast_tpu_torch.ops import dedisperse as tdd
from vlite_fast_tpu_torch.ops import dedisperse_pallas as tddp

torch.set_num_threads(1)

TSAMP = 2e-3


def _fb(ntime, nchan, dm=150.0, t0=100, amp=5.0, seed=0):
    """Unit-variance noise and a dispersed pulse (tests/test_dedisperse.py's
    make_fb)."""
    rng = np.random.default_rng(seed)
    fb = rng.standard_normal((ntime, nchan)).astype(np.float32)
    freqs = 384.0 - np.arange(nchan) * (4.0 / nchan)
    delays = jdd.delay_table(np.array([dm]), freqs, TSAMP)[0]
    for ch in range(nchan):
        if t0 + delays[ch] < ntime:
            fb[t0 + delays[ch], ch] += amp
    return fb, freqs


# (ntime, nchan, ndm, nsub, nbatch, zap_ranges, sub_chunk)
CASES = {
    "exact": (800, 64, 32, 16, 32, (), 16),
    "approximate": (600, 32, 64, 8, 16, (), 16),
    "zapped": (800, 64, 16, 16, 16, ((0, 8),), 16),
    "sub_chunk3": (600, 32, 64, 8, 16, (), 3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rollsel_matches_jax(case):
    ntime, nchan, ndm, nsub, nbatch, zap, sc = CASES[case]
    fb, freqs = _fb(ntime, nchan)
    if zap:
        fb[:, 3] += 100.0                       # a hot channel, zapped
    dms = jdd.dm_grid(0, 300, ndm)
    kw = dict(nsub=nsub, nbatch=nbatch, zap_ranges=zap)
    pj = jdd.make_plan(dms, freqs, TSAMP, **kw)
    pt = tdd.make_plan(dms, freqs, TSAMP, device="cpu", **kw)
    ntime_out = ntime - pj.max_delay
    want = np.asarray(jddp.dedisperse_pallas_rollsel(
        jnp.asarray(fb), pj, ntime_out, sub_chunk=sc))
    before = tddp.ROLLSEL_LAUNCHES
    got = tddp.dedisperse_pallas_rollsel(torch.from_numpy(fb), pt, ntime_out,
                                         sub_chunk=sc)
    assert tddp.ROLLSEL_LAUNCHES == before        # CPU: the plain version
    assert got.shape == want.shape == (ndm, ntime_out)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    # the same function as the fold engine
    fold = tdd.dedisperse(torch.from_numpy(fb), pt, ntime_out)
    np.testing.assert_allclose(got.numpy(), fold.numpy(), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("nsub,sub_chunk,want", [
    (8, 16, 8), (8, 3, 2), (128, 16, 16), (12, 5, 4), (7, 3, 1)])
def test_sub_chunk_is_the_largest_divisor(nsub, sub_chunk, want):
    assert tddp._sub_chunk(nsub, sub_chunk) == want


def test_rollsel_refuses_other_devices():
    fb, freqs = _fb(600, 32)
    plan = tdd.make_plan(jdd.dm_grid(0, 300, 16), freqs, TSAMP, nsub=8,
                         nbatch=16, device="cpu")
    with pytest.raises(ValueError, match="device"):
        tddp.dedisperse_pallas_rollsel(
            torch.empty(fb.shape, device="meta"), plan, 100)
