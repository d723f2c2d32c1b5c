"""The plain versions of the port's armed-program kernels against the JAX
package's Pallas kernels, run in interpret mode on the CPU (as
tests/test_ops.py runs them).

Bars:
- the EMAs: allclose(rtol=2e-6, atol=2e-6), the JAX package's own bar
  for its Pallas EMAs against the sequential scan (tests/test_ops.py);
  the tile means are summed in another order than XLA's;
- rfi_front: masked voltages and weights equal, the flags equal, and the
  TS within 1e-5 absolute.  The TPU kernel takes the cube root as
  exp(log(t)/3), the port as cbrt, and the TS is |Z21 (Z22 - cbrt t)|,
  a cancellation: the JAX package's own two fronts differ by ~1.4e-6
  there.  The gates sit at 3 and 5.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vlite_fast_tpu.config import PipelineConfig
from vlite_fast_tpu.ops import normalize as jnorm
from vlite_fast_tpu.ops import pallas_kernels as jpk
from vlite_fast_tpu.ops import rfi_pallas as jrfi
from vlite_fast_tpu_torch.ops import pallas_kernels as tpk
from vlite_fast_tpu_torch.ops import rfi_pallas as trfi

torch.set_num_threads(1)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                               atol=2e-6)


def _power(seed, npol=2, ntime=96, nchan=40):
    """Chi-square power with a dead spectrum (all zero) and, in the last
    third, a 10x step so the weighted EMA's stale check fires."""
    rng = np.random.default_rng(seed)
    p = rng.chisquare(2, (npol, ntime, nchan)).astype(np.float32)
    p[:, 17] = 0.0
    p[:, 2 * ntime // 3:] *= 10.0
    return p


def _bp(nchan=40):
    """A carried bandpass with cold (zero) channels to seed."""
    bp = np.full((2, nchan), 1.5, np.float32)
    bp[:, ::3] = 0.0
    return bp


@pytest.mark.parametrize("time_tile", [0, 16])
def test_ema_plain_matches_jax_pallas(time_tile):
    p, bp = _power(4), _bp()
    want_o, want_b = jpk.normalize_ema_pallas(
        jnp.asarray(p), jnp.asarray(bp), 0.02, chan_tile=16,
        time_tile=time_tile)
    got_o, got_b = tpk.normalize_ema_pallas(
        torch.from_numpy(p), torch.from_numpy(bp), 0.02, time_tile=time_tile)
    assert tpk.LAUNCHES["normalize_ema_pallas"] == 0    # CPU: plain version
    _close(got_o, want_o)
    _close(got_b, want_b)


@pytest.mark.parametrize("time_tile", [0, 16])
def test_ema_weighted_plain_matches_jax_pallas(time_tile):
    p, bp = _power(5), _bp()
    p[0, 40] *= 400.0                    # clipped spectrum
    w = np.ones((2, p.shape[1]), np.float32)
    w[:, 10] = 0.0                       # zero-weight row
    w[1, 30:35] = 0.5
    want_o, want_b = jpk.normalize_ema_weighted_pallas(
        jnp.asarray(p), jnp.asarray(w), jnp.asarray(bp), 0.05,
        chan_tile=20, time_tile=time_tile)
    got_o, got_b = tpk.normalize_ema_weighted_pallas(
        torch.from_numpy(p), torch.from_numpy(w), torch.from_numpy(bp),
        0.05, time_tile=time_tile)
    assert tpk.LAUNCHES["normalize_ema_weighted_pallas"] == 0
    _close(got_o, want_o)
    _close(got_b, want_b)
    assert (got_o.numpy()[0, 40] == 10.0).any()     # clipped to clip_value
    assert (got_o.numpy()[:, 10] == 0.0).all()      # zero weight gives 0


def test_ema_tiles_equal_per_segment_calls():
    """One call with time_tile = T/3 equals three calls carrying bp."""
    p, bp = torch.from_numpy(_power(6)), torch.from_numpy(_bp())
    w = torch.ones((2, 96))
    w[0, 50] = 0.0
    whole = tpk.normalize_ema_weighted_pallas(p, w, bp, 0.05, time_tile=32)
    b, outs = bp, []
    for t0 in (0, 32, 64):
        o, b = tpk.normalize_ema_weighted_pallas(
            p[:, t0:t0 + 32].contiguous(), w[:, t0:t0 + 32].contiguous(), b,
            0.05)
        outs.append(o)
    assert torch.equal(whole[0], torch.cat(outs, dim=1))
    assert torch.equal(whole[1], b)


def test_ema_zero_tile_seeds_one_as_scan():
    """A tile of zero power with a cold bandpass: the port follows the
    JAX 'scan' EMA (seed 1, out -1); the JAX Pallas kernel gives 0/0."""
    p = np.zeros((1, 8, 4), np.float32)
    bp = np.zeros((1, 4), np.float32)
    got_o, got_b = tpk.normalize_ema_pallas(torch.from_numpy(p),
                                            torch.from_numpy(bp), 0.02)
    want_o, want_b = jnorm.normalize_ema(jnp.asarray(p), jnp.asarray(bp),
                                         0.02)
    _close(got_o, want_o)
    _close(got_b, want_b)
    pallas_o, _ = jpk.normalize_ema_pallas(jnp.asarray(p), jnp.asarray(bp),
                                           0.02, chan_tile=4)
    assert np.isnan(np.asarray(pallas_o)).all()


def _burst_raw(nsamp, seed):
    """Gaussian 8-bit voltages with a sinusoidal burst in pol 0."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, nsamp)).astype(np.float32)
    raw = np.clip(x / 0.02957 / 2 + 128.5, 0, 255).astype(np.int16)
    t = np.arange(3000)
    raw[0, 40000:43000] += (60 * np.sin(0.3 * t)).astype(np.int16)
    return np.clip(raw, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("dag_fb_thresh", [0.0, 5.0])
def test_rfi_front_plain_matches_jax_pallas(dag_fb_thresh):
    cfg = PipelineConfig.tiny()
    raw = _burst_raw(200_000, seed=4)
    want = jrfi.rfi_front(jnp.asarray(raw), cfg.nkurto, cfg.nfft,
                          dag_thresh=cfg.dag_thresh,
                          dag_fb_thresh=dag_fb_thresh)
    got = trfi.rfi_front(torch.from_numpy(raw), cfg.nkurto, cfg.nfft,
                         dag_thresh=cfg.dag_thresh,
                         dag_fb_thresh=dag_fb_thresh)
    assert trfi.LAUNCHES == 0
    masked, weights, dag = (g.numpy() for g in got)
    assert np.array_equal(masked, np.asarray(want[0]))
    assert np.array_equal(weights, np.asarray(want[1]))
    want_dag = np.asarray(want[2])
    assert np.array_equal(dag >= cfg.dag_thresh, want_dag >= cfg.dag_thresh)
    np.testing.assert_allclose(dag, want_dag, rtol=0, atol=1e-5)
    assert (dag >= cfg.dag_thresh).any()             # windows flagged
    assert weights.min() < 1.0
