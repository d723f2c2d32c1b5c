"""models/search.boxcar_topk: the gulp's boxcar S/N and banded top-k.

On the CPU it is pack_topk_banded(boxcar_snr(...)) itself (byte-equal),
and its decoded crossings are the JAX package's.  On the card it is the
two launches of csrc/boxcar_topk.cu, held to the torch passes on the
same DM-time plane.  Bar: the same crossing count but for S/N within
1e-5 relative of the threshold; the same saturated bands; the same
decoded hits but for those within 1e-5 relative of the threshold or of
their band's kb-th value, at S/N within rtol 1e-5 (the boxes are summed
in another order than torch.cumsum's); each band's slots descending.

The JAX package is imported inside the CPU tests only, so that the card
runs this file without it:

    python -m pytest --noconftest -m cuda tests/test_torch_boxcar_topk.py
"""

import numpy as np
import pytest
import torch

from vlite_fast_tpu_torch import launches
from vlite_fast_tpu_torch.models import search as tsearch
from vlite_fast_tpu_torch.ops import boxcar_topk as tbt
from vlite_fast_tpu_torch.ops import dedisperse as tdd

WIDTHS = (1, 2, 4, 8, 16, 32, 64)
RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no interpret mode)")
    return torch.device("cuda")


def _plane(ndm, nt, seed, scale=1.0, pulses=12):
    """Gaussian noise with bright boxes at seeded (dm, t, width)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((ndm, nt)).astype(np.float32) * np.float32(scale)
    for _ in range(pulses):
        d, t = int(rng.integers(0, ndm)), int(rng.integers(0, nt))
        w = int(rng.choice([1, 3, 8, 30]))
        x[d, t:t + w] += np.float32(scale * rng.uniform(3.0, 12.0))
    return x


def _composition(dmt, nchan_eff, widths, k, nbands, thresh, noise, skip):
    """The torch passes: the whole cube (zeros before `skip`), then
    pack_topk_banded; and the cube."""
    ndm, nt = dmt.shape
    snr = torch.zeros((len(widths), ndm, skip + nt), device=dmt.device)
    snr[:, :, skip:] = tdd.boxcar_snr(dmt, nchan_eff, widths, noise=noise)
    return tsearch.pack_topk_banded(snr, k, nbands, thresh), snr


def assert_same_crossings(got, want, shape, nbands, thresh, snr=None):
    """The bar of the module docstring; snr, the torch cube (for the
    count's values near the threshold), where there is one."""
    nw, ndm, ntime = shape
    got, want = np.asarray(got), np.asarray(want)
    vg, hg, ng, sg = tsearch.decode_crossings(got, nw, ndm, ntime, nbands,
                                              thresh)
    vw, hw, nw_, sw = tsearch.decode_crossings(want, nw, ndm, ntime,
                                               nbands, thresh)
    near = 0
    if snr is not None:
        near = int(((snr - thresh).abs() <= RTOL * thresh).sum())
    assert abs(ng - nw_) <= near, (ng, nw_, near)
    assert sg == sw, (sg, sw)
    nb = tsearch.effective_nbands(ndm, nbands)
    kb = (got.shape[1] - 1) // nb
    dmb = ndm // nb
    slots = got[0, :-1].view(np.float32).reshape(nb, kb)
    assert np.all(slots[:, :-1] >= slots[:, 1:]), "slots not descending"
    cut = np.asarray(want[0, :-1]).view(np.float32).reshape(nb, kb) \
        .min(axis=1)
    a = {tuple(h): v for h, v in zip(hg.tolist(), vg.tolist())}
    b = {tuple(h): v for h, v in zip(hw.tolist(), vw.tolist())}
    for h in a.keys() & b.keys():
        assert abs(a[h] - b[h]) <= RTOL * abs(b[h]), (h, a[h], b[h])
    for h in a.keys() ^ b.keys():
        v = a.get(h, b.get(h))
        edge = min(abs(v - thresh) / thresh,
                   abs(v - cut[h[1] // dmb]) / abs(cut[h[1] // dmb]))
        assert edge <= RTOL, (h, v, thresh, cut[h[1] // dmb],
                              h in a, h in b)
    return ng, sg, len(a)


# ---------------------------------------------------------------- CPU
CASES = {
    "measured": dict(noise="measured", nbands=8, skip=0, nt=600),
    "expected": dict(noise="expected", nbands=8, skip=0, nt=600),
    "one_band": dict(noise="measured", nbands=1, skip=0, nt=600),
    "short_row": dict(noise="measured", nbands=8, skip=0, nt=63),
    "skip": dict(noise="measured", nbands=8, skip=150, nt=450),
}


def _cpu_case(name):
    c = CASES[name]
    nchan_eff = 200.0
    scale = np.sqrt(np.float32(nchan_eff)) if c["noise"] == "expected" \
        else 1.0
    dmt = torch.from_numpy(_plane(64, c["nt"], seed=len(name), scale=scale,
                                  pulses=30))
    return dmt, nchan_eff, c


@pytest.mark.parametrize("name", sorted(CASES))
def test_cpu_is_the_torch_composition(name):
    dmt, nchan_eff, c = _cpu_case(name)
    before = launches.counts()
    got = tsearch.boxcar_topk(dmt, nchan_eff, WIDTHS, 256, c["nbands"], 6.0,
                              noise=c["noise"], skip=c["skip"])
    want, _ = _composition(dmt, nchan_eff, WIDTHS, 256, c["nbands"], 6.0,
                           c["noise"], c["skip"])
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert not any(launches.since(before).values())


@pytest.mark.parametrize("name", sorted(CASES))
def test_cpu_hits_are_the_jax_packages(name):
    import jax.numpy as jnp

    from vlite_fast_tpu.models import search as jsearch
    from vlite_fast_tpu.ops import dedisperse as jdd
    dmt, nchan_eff, c = _cpu_case(name)
    got = tsearch.boxcar_topk(dmt, nchan_eff, WIDTHS, 256, c["nbands"], 6.0,
                              noise=c["noise"], skip=c["skip"])
    snr = jdd.boxcar_snr(jnp.asarray(dmt.numpy()), nchan_eff, WIDTHS,
                         noise=c["noise"])
    snr = jnp.concatenate([jnp.zeros((len(WIDTHS), 64, c["skip"]),
                                     jnp.float32), snr], axis=2)
    want = jsearch.pack_topk_banded(snr, 256, c["nbands"], 6.0)
    shape = (len(WIDTHS), 64, c["skip"] + c["nt"])
    n, _, hits = assert_same_crossings(
        got.numpy(), np.asarray(want), shape, c["nbands"], 6.0,
        torch.from_numpy(np.array(snr)))
    assert n > 0 and hits > 0


def test_cpu_row_shorter_than_every_box_but_one():
    """Rows of 20 outputs: widths 32 and 64 have no output."""
    dmt = torch.from_numpy(_plane(16, 20, seed=3, pulses=4))
    got = tsearch.boxcar_topk(dmt, 64.0, WIDTHS, 64, 8, 2.0)
    want, _ = _composition(dmt, 64.0, WIDTHS, 64, 8, 2.0, "measured", 0)
    assert torch.equal(got, want)


def test_launch_counts_are_listed():
    assert set(tbt.LAUNCHES) <= set(launches.counts())
    launches.zero()
    assert not any(launches.counts()[k] for k in tbt.LAUNCHES)


def test_widths_the_kernels_take():
    """The launches take widths 1, 2, 4, ... (boxcar_widths'); their
    scales are boxcar_snr's f32 1/sqrt(w)."""
    assert tsearch.boxcar_widths(64) == WIDTHS
    s = tbt.width_scales(WIDTHS)
    assert s[0] == 1.0 and s[2] == 0.5 and s[6] == 0.125
    assert s[1] == float(torch.rsqrt(torch.tensor(2.0)))


# ---------------------------------------------------------------- card
def _card(dmt, nchan_eff, k, nbands, thresh, noise="measured", skip=0):
    """The launches and the torch passes on the same plane on the card."""
    before = launches.counts()
    got = tsearch.boxcar_topk(dmt, nchan_eff, WIDTHS, k, nbands, thresh,
                              noise=noise, skip=skip)
    n = launches.since(before)
    assert n["boxcar_snr_stats"] == 1 and n["topk_banded_select"] == 1, n
    want, snr = _composition(dmt, nchan_eff, WIDTHS, k, nbands, thresh,
                             noise, skip)
    torch.cuda.synchronize()
    shape = (len(WIDTHS), dmt.shape[0], skip + dmt.shape[1])
    res = assert_same_crossings(got.cpu(), want.cpu(), shape, nbands,
                                thresh, snr)
    del snr
    return res


@pytest.mark.cuda
@pytest.mark.parametrize("thresh,k", [(6.0, 20000), (4.0, 8000)])
def test_station_shape(cuda, thresh, k):
    """4864 trials x 15,360 outputs (step 1), 8 bands: sparse pulses at
    6, and at 4 every band past its quota."""
    dmt = torch.from_numpy(_plane(4864, 15360, seed=5, pulses=200)).to(cuda)
    n, sat, hits = _card(dmt, 3700.0, k, 8, thresh)
    assert n > 0 and hits > 0
    if thresh == 4.0:
        assert sat == 8


@pytest.mark.cuda
def test_array_shape_with_skip(cuda):
    """25,600 outputs a window, the first 1,000 before the stream (S/N
    0): 24,600 searched at step 3."""
    dmt = torch.from_numpy(_plane(4864, 24600, seed=6, pulses=200)).to(cuda)
    n, _, hits = _card(dmt, 3700.0, 65536, 8, 6.0, skip=1000)
    assert n > 0 and hits > 0


@pytest.mark.cuda
def test_expected_noise_one_band(cuda):
    dmt = torch.from_numpy(_plane(512, 4000, seed=7, scale=np.sqrt(900.0),
                                  pulses=40)).to(cuda)
    n, _, hits = _card(dmt, 900.0, 20000, 1, 6.0, noise="expected")
    assert n > 0 and hits > 0


@pytest.mark.cuda
def test_crowded_band_with_ties_at_its_cutoff(cuda):
    """Band 0: 608 copies of a pulse train (a spike every 16 samples),
    1.17 M crossings of two S/N values, so its 2500 slots are cut inside
    583,680 bit-equal values; a few rows carry brighter spikes that must
    all come home.  The other bands: noise and pulses."""
    ndm, nt = 4864, 15360
    x = _plane(ndm, nt, seed=8, pulses=100)
    train = np.zeros(nt, np.float32)
    train[::16] = 10.0
    x[:608] = train
    for d in (3, 300, 607):
        x[d, 5001] += 40.0
    dmt = torch.from_numpy(x).to(cuda)
    n, sat, hits = _card(dmt, 3700.0, 20000, 8, 6.0)
    assert n >= 10 ** 6 and sat >= 1
    got = tsearch.boxcar_topk(dmt, 3700.0, WIDTHS, 20000, 8, 6.0).cpu()
    v, h, _, _ = tsearch.decode_crossings(got.numpy(), 7, ndm, nt, 8, 6.0)
    spikes = {(0, d, 5001) for d in (3, 300, 607)}
    assert spikes <= set(map(tuple, h.tolist()))
    # band 0's slots: the spikes' boxes, then the train's width-1 value
    band0 = v[h[:, 1] < 608]
    assert len(band0) == 2500 and (band0 == band0.min()).sum() >= 2000


@pytest.mark.cuda
def test_no_crossing(cuda):
    dmt = torch.from_numpy(_plane(256, 8192, seed=9, pulses=0)).to(cuda)
    got = tsearch.boxcar_topk(dmt, 64.0, WIDTHS, 2048, 8, 50.0).cpu()
    assert int(got[0, -1]) == 0 and int(got[1, -1]) == 0
    assert torch.all(got[0, :-1] == torch.tensor(
        -np.inf, dtype=torch.float32).view(torch.int32).item())
    assert torch.all(got[1, :-1] == 0)


@pytest.mark.cuda
def test_float16_rows_through_the_search(cuda):
    """A float16 filterbank (the coadd's stream) through _device_gulp:
    the launches against the torch passes on the same dedispersed
    plane."""
    from vlite_fast_tpu_torch.config import SearchConfig
    scfg = SearchConfig(dm_min=0.0, dm_max=100.0, ndm=64, gulp_samps=4096,
                        boxcar_max=64, zap_ranges=(), snr_thresh=5.0)
    freqs = np.linspace(400.0, 350.0, 256)
    eng = tsearch.SinglePulseSearch(scfg, 1e-3, freqs, device=cuda)
    rng = np.random.default_rng(10)
    fb = rng.standard_normal((4096 + eng.overlap, 256)).astype(np.float16)
    fb[2000:2004] += np.float16(1.5)
    fb_dev = torch.from_numpy(fb).to(cuda)
    got = tsearch._device_gulp(fb_dev, eng.plan, widths=eng.widths, k=2048,
                               nbit=0, nchan=256, nbands=eng.nbands,
                               thresh=5.0)
    dmt = tsearch.dedisperse(fb_dev, eng.plan, 4096)
    want, snr = _composition(dmt, eng.plan.nchan_eff, eng.widths, 2048,
                             eng.nbands, 5.0, "measured", 0)
    n, _, hits = assert_same_crossings(got.cpu(), want.cpu(),
                                       tuple(snr.shape), eng.nbands, 5.0,
                                       snr)
    assert n > 0 and hits > 0


@pytest.mark.cuda
def test_chunked_row(cuda):
    """Rows of 60,000 outputs do not fit a block's shared memory: they
    go in chunks behind a 63-sample halo, the median from a staged
    subsample (step 7)."""
    dmt = torch.from_numpy(_plane(64, 60000, seed=11, pulses=60)).to(cuda)
    n, _, hits = _card(dmt, 3700.0, 4096, 8, 4.5)
    assert n > 0 and hits > 0
