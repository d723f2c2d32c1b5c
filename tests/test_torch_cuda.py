"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked `cuda` and skips without an NVIDIA GPU (a CUDA
kernel has no interpret mode).  This file imports no jax, so it runs on
a machine without it; tests/conftest.py imports jax, so run it there as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Bars: the chain kernels (chain_second_v2, chain_second in its three
pretranspose modes, chain_second_v4) and the armed program to the chain
bar of
tests/test_torch_chain.py (>= 0.9999 of 2-bit levels, none off by more
than one, weights equal, dag_frac within 1e-6, bandpass within 1e-4
relative); the dedispersion kernel allclose(rtol=1e-5, atol=1e-4) (the
same f32 terms summed in another order); the EMA kernels bit-equal to
their plain versions (the same arithmetic in the same order;
test_ema_weighted_kernel_matches_plain keeps the JAX package's bar for
its Pallas EMAs, allclose(rtol=2e-6, atol=2e-6)); the RFI front kernel
equal masked voltages, weights and flags, TS within 1e-5 absolute (cbrtf
against a float64 cube root, then the cancellation Z22 - cbrt t) and
bit-equal to the kernel's first design (stored digests); the
pretranspose kernel byte-equal (u8) and value-equal (bf16) to its plain
version; chain_second's three modes and chain_second_v4 on u8 and bf16
tiles bit-identical to chain_second_v2 (one tensor-core DFT on the same
bf16 frames, whatever the loader); chain_second_v2, dft_detect_power and
chain_second_plain equal to stored sha-256 digests of their outputs
before the CT-major layouts moved onto their DFT; the EMA
launch of chain_second_v2 alone bit-equal to a torch version of its
sequential arithmetic; the tensor-core DFT (dft_detect_power) within 2e-3
relative (floor 1e-3) of dft_detect_oracle, the JAX package's bar for
its stage A, and
stage B (chain_second_plain) to the 2-bit bar and a bandpass within 1e-4
relative; the roll+select dedispersion bit-equal to its plain version
(the same adds in the same order) and allclose(rtol=1e-5, atol=1e-4) to
the fold kernel.
"""

import ctypes
import dataclasses
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vlite_fast_tpu_torch import _build, ema_probe
from vlite_fast_tpu_torch import constants as C
from vlite_fast_tpu_torch.benchmarks import transpose_prims as ttp
from vlite_fast_tpu_torch.config import PipelineConfig, SearchConfig
from vlite_fast_tpu_torch.models import baseband_dsp as tdsp
from vlite_fast_tpu_torch.models import search as tsearch
from vlite_fast_tpu_torch.ops import dedisperse as tdd
from vlite_fast_tpu_torch.ops import dedisperse_pallas as tddp
from vlite_fast_tpu_torch.ops import megakernel as tmk
from vlite_fast_tpu_torch.ops import normalize as tnorm
from vlite_fast_tpu_torch.ops import pallas_kernels as tpk
from vlite_fast_tpu_torch.ops import quantize as tq
from vlite_fast_tpu_torch.ops import rfi_pallas as trfi
from vlite_fast_tpu_torch.runtime.pipeline import (ObservationDocument,
                                                   StationPipeline)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no interpret mode)")
    return torch.device("cuda")


def _noise(nsamp, seed, burst_at=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, nsamp)).astype(np.float32)
    raw = np.clip(x / 0.02957 / 2 + 128.5, 0, 255).astype(np.uint8)
    if burst_at is not None:
        t = np.arange(3000)
        raw = raw.astype(np.int16)
        raw[0, burst_at:burst_at + 3000] += (60 * np.sin(0.3 * t)).astype(
            np.int16)
        raw = np.clip(raw, 0, 255).astype(np.uint8)
    return raw


def _assert_levels(a, b):
    la = tq.unpack_bits(a.cpu(), 2).numpy().astype(np.int16)
    lb = tq.unpack_bits(b.cpu(), 2).numpy().astype(np.int16)
    assert la.shape == lb.shape
    assert (la == lb).mean() >= 0.9999, (la == lb).mean()
    assert np.abs(la - lb).max() <= 1


def _assert_bp(got, want):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-6)
    assert rel.max() < 1e-4, rel.max()


@pytest.mark.parametrize("npol", [1, 2])
@pytest.mark.parametrize("rfi_mode", [0, 1, 2])
def test_chain_kernel_matches_plain(cuda, rfi_mode, npol):
    # tests/test_megakernel.py geometry: nfft 2048 (CT 32x64), 3 segments
    # of 16 FFTs, nkurto 256, chanmin % 4 != 0
    cfg = PipelineConfig(sample_rate=2048 * 16 * 3, seg_per_sec=3,
                         nfft=2048, nkurto=256, chanmin=101, chanmax=612,
                         nscrunch=8, rfi_mode=rfi_mode, npol_in=npol)
    raw = torch.from_numpy(np.ascontiguousarray(
        _noise(cfg.sample_rate, seed=7, burst_at=40000)[:npol])).to(cuda)
    bp = torch.zeros((2, npol, cfg.nchan), device=cuda)
    for _ in range(2):                      # second 2 carries the bandpass
        want = tmk.chain_second_v2_plain(raw, bp, cfg)
        got = tmk.chain_second_v2(raw, bp, cfg)
        torch.cuda.synchronize()
        for g, w in zip(got[:2], want[:2]):
            _assert_levels(g, w)
        assert torch.equal(got[2], want[2])
        np.testing.assert_allclose(got[3].cpu().numpy(),
                                   want[3].cpu().numpy(), atol=1e-6)
        _assert_bp(got[4], want[4])
        bp = got[4]
    if rfi_mode:
        assert float(got[2].mean()) < 1.0   # the gates fired


def _mk_cfg(**kw):
    return PipelineConfig(sample_rate=2048 * 16 * 3, seg_per_sec=3,
                          nfft=2048, nkurto=256, chanmin=101, chanmax=612,
                          nscrunch=8, **kw)


@pytest.mark.parametrize("npol", [1, 2])
def test_pretranspose_kernel_matches_plain(cuda, npol):
    cfg = _mk_cfg()
    raw = torch.from_numpy(np.ascontiguousarray(
        _noise(cfg.sample_rate, seed=8)[:npol])).to(cuda)
    raw[0, :100] = 0                        # zero bytes convert to 0.0
    args = (raw, cfg.nfft, npol, cfg.seg_per_sec)
    for dtype in (torch.uint8, torch.bfloat16):
        got = tmk.pallas_pretranspose(*args, dtype)
        want = tmk.pallas_pretranspose_plain(*args, dtype)
        torch.cuda.synchronize()
        assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(tmk.pallas_pretranspose(*args),
                       tmk.pretranspose_u8(*args))


@pytest.mark.parametrize("offset", [0, 5])
@pytest.mark.parametrize("npol", [1, 2])
@pytest.mark.parametrize("nfft", [12500, 2048, 10000, 630])
def test_pretranspose_kernel_every_alignment(cuda, nfft, npol, offset):
    """Frames 4-byte (12500), 16-byte (2048), 16-byte (10000) and 2-byte
    (630) aligned, from a buffer at a 16-byte boundary or 5 bytes past
    one, over enough tiles that the blocks walk runs of frames whose
    length is no multiple of the ring's slots (and at most grid + 1
    tiles, where a block holds one or two frames)."""
    lib = _build.load("pretranspose")
    lib.vf_pretranspose_grid.argtypes = [ctypes.c_int, ctypes.c_longlong,
                                         ctypes.c_int]
    lib.vf_pretranspose_grid.restype = ctypes.c_int
    for extra in (1, None):
        grid = lib.vf_pretranspose_grid(nfft, 10 ** 6, 0)    # the u8 grid
        assert grid >= 1
        ntile = grid + 1 if extra else 4 * grid + 5
        ffts = -(-ntile // (2 * npol))
        nsamp = 2 * ffts * nfft
        rng = np.random.default_rng(nfft + npol)
        buf = torch.from_numpy(rng.integers(0, 256, npol * nsamp + offset,
                                            dtype=np.uint8)).to(cuda)
        raw = buf[offset:].view(npol, nsamp)
        raw[0, :100] = 0                    # zero bytes convert to 0.0
        args = (raw, nfft, npol, 2)
        for dtype in (torch.uint8, torch.bfloat16):
            got = tmk.pallas_pretranspose(*args, dtype)
            want = tmk.pallas_pretranspose_plain(*args, dtype)
            torch.cuda.synchronize()
            assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("npol", [1, 2])
@pytest.mark.parametrize("rfi_mode", [0, 1, 2])
def test_chain_second_kernel_matches_plain(cuda, rfi_mode, npol):
    """Kernel B in its three pretranspose modes: byte-identical to each
    other, and at the chain bar against plain and against the v2 kernel,
    over two seconds with the bandpass carried."""
    cfg = _mk_cfg(rfi_mode=rfi_mode, npol_in=npol)
    raw = torch.from_numpy(np.ascontiguousarray(
        _noise(cfg.sample_rate, seed=7, burst_at=40000)[:npol])).to(cuda)
    bp = torch.zeros((2, npol, cfg.nchan), device=cuda)
    for _ in range(2):
        want = tmk.chain_second_ct_plain(raw, bp, cfg)
        v2 = tmk.chain_second_v2(raw, bp, cfg)
        outs = [tmk.chain_second(raw, bp, cfg, pretranspose=m)
                for m in tmk.PRETRANSPOSE]
        torch.cuda.synchronize()
        for got in outs[1:]:
            for g, r in zip(got, outs[0]):
                assert torch.equal(g, r)
        got = outs[0]
        # against the v2 kernel (split-plane bf16 DFT): the chain bar
        for g, r in zip(got[:2], v2[:2]):
            _assert_levels(g, r)
        assert torch.equal(got[2], v2[2])
        np.testing.assert_allclose(got[3].cpu().numpy(), v2[3].cpu().numpy(),
                                   atol=1e-6)
        _assert_bp(got[4], v2[4])
        for g, w in zip(got[:2], want[:2]):
            _assert_levels(g, w)
        assert torch.equal(got[2], want[2])
        np.testing.assert_allclose(got[3].cpu().numpy(),
                                   want[3].cpu().numpy(), atol=1e-6)
        _assert_bp(got[4], want[4])
        bp = got[4]
    if rfi_mode:
        assert float(got[2].mean()) < 1.0   # the gates fired


@pytest.mark.parametrize("pre_dtype", ["u8", "bf16"])
@pytest.mark.parametrize("npol", [1, 2])
@pytest.mark.parametrize("rfi_mode", [0, 1, 2])
def test_chain_second_v4_kernel_matches_plain(cuda, rfi_mode, npol,
                                              pre_dtype):
    cfg = _mk_cfg(rfi_mode=rfi_mode, npol_in=npol)
    raw = torch.from_numpy(np.ascontiguousarray(
        _noise(cfg.sample_rate, seed=9, burst_at=40000)[:npol])).to(cuda)
    bp = torch.zeros((2, npol, cfg.nchan), device=cuda)
    for _ in range(2):
        want = tmk.chain_second_v4_plain(raw, bp, cfg)
        got = tmk.chain_second_v4(raw, bp, cfg, pre_dtype=pre_dtype)
        torch.cuda.synchronize()
        for g, w in zip(got[:2], want[:2]):
            _assert_levels(g, w)
        assert torch.equal(got[2], want[2])
        np.testing.assert_allclose(got[3].cpu().numpy(),
                                   want[3].cpu().numpy(), atol=1e-6)
        _assert_bp(got[4], want[4])
        bp = got[4]


@pytest.mark.parametrize("npol", [1, 2])
def test_chain_kernel_matches_plain_n2_not_multiple_of_32(cuda, npol):
    """chain_second_v2 at 10000 = 100 x 100: stage 2 walks 32 m2 columns
    per pass, past n2, through W2's zero-padded depth."""
    cfg = PipelineConfig(sample_rate=10000 * 16 * 2, seg_per_sec=2,
                         nfft=10000, nkurto=500, chanmin=101, chanmax=612,
                         nscrunch=8, rfi_mode=2, npol_in=npol)
    raw = torch.from_numpy(np.ascontiguousarray(
        _noise(cfg.sample_rate, seed=13, burst_at=90000)[:npol])).to(cuda)
    bp = torch.zeros((2, npol, cfg.nchan), device=cuda)
    want = tmk.chain_second_v2_plain(raw, bp, cfg)
    got = tmk.chain_second_v2(raw, bp, cfg)
    torch.cuda.synchronize()
    for g, w in zip(got[:2], want[:2]):
        _assert_levels(g, w)
    assert torch.equal(got[2], want[2])
    np.testing.assert_allclose(got[3].cpu().numpy(), want[3].cpu().numpy(),
                               atol=1e-6)
    _assert_bp(got[4], want[4])
    assert float(got[2].mean()) < 1.0       # the gates fired


@pytest.mark.parametrize("flagged", ["all", "none"])
def test_chain_kernel_every_block_flagged_or_none(cuda, flagged):
    """chain_second_v2 where the list of blocks flagged in part is empty:
    a loud tone over the whole second (every window flagged, every weight
    0) and a gate no window reaches (every weight 1, the kurtosis stream
    on the plain power throughout)."""
    cfg = _mk_cfg(rfi_mode=2, dag_thresh=1e30 if flagged == "none" else 3.0)
    raw = _noise(cfg.sample_rate, seed=12)
    if flagged == "all":
        tone = (100 * np.sin(0.3 * np.arange(cfg.sample_rate)))
        raw = np.clip(raw + tone.astype(np.int16), 0, 255).astype(np.uint8)
    raw = torch.from_numpy(raw).to(cuda)
    bp = torch.zeros((2, 2, cfg.nchan), device=cuda)
    want = tmk.chain_second_v2_plain(raw, bp, cfg)
    got = tmk.chain_second_v2(raw, bp, cfg)
    torch.cuda.synchronize()
    assert bool((got[2] == (0.0 if flagged == "all" else 1.0)).all())
    for g, w in zip(got[:2], want[:2]):
        _assert_levels(g, w)
    assert torch.equal(got[2], want[2])
    np.testing.assert_allclose(got[3].cpu().numpy(), want[3].cpu().numpy(),
                               atol=1e-6)
    _assert_bp(got[4], want[4])


def _chain_ema_plain(power, power_kur, partial, weights, bp, cfg):
    """The chain's EMA launch (csrc/chain.cuh) in torch, its sequential
    arithmetic in its order, every channel at once: per segment the seed,
    then per spectrum the EMA (plain stream; weighted stream with the
    stale test and the clip), pscrunch, tscrunch, the 2-bit levels.
    Stream 1 reads power_kur where `partial` flags the block (everywhere
    without it).

    power / power_kur f32 (npol, nblk, nchan); weights f32 (npol, nblk);
    bp f32 (2, npol, nchan).  Returns (packed, packed_kur, bp_new) as the
    chain kernels do (a stream the rfi_mode does not compute stays 0, its
    bandpass unchanged)."""
    npol, nblk, nchan = power.shape
    # scalars: f32 values as Python floats (a tensor op rounds a Python
    # scalar to the tensor's f32; a division by one goes through a full
    # tensor, since on the card torch divides by a scalar as a multiply by
    # its reciprocal), the per-spectrum weight sums in numpy f32
    f32 = np.float32
    r = lambda v: float(f32(v))
    div = lambda a, v: a / torch.full_like(a, float(v))
    s, oms = (r(v) for v in tnorm.ema_constants(cfg.bp_scale))
    ffts, ns = cfg.ffts_per_seg, cfg.nscrunch
    nout, nseg = ffts // ns, nblk // ffts
    rffts, rns = r(tnorm.recip(ffts)), f32(tnorm.recip(ns))
    isn, sqh = r(tnorm.inv_sqrt(ns)), r(tnorm._SQRT_HALF)
    minw, clip = f32(cfg.min_weight), r(C.BP_CLIP_RATIO)
    kur = power_kur if partial is None else torch.where(
        partial.bool()[None, :, None], power_kur, power)
    bp = bp.clone()
    ts = torch.zeros((2, nseg * nout, nchan), dtype=torch.float32,
                     device=power.device)
    one = torch.ones_like(bp[0])
    wn = weights.cpu().numpy()
    for seg in range(nseg):
        t0 = seg * ffts
        if cfg.rfi_mode != 1:
            b = bp[0]
            acc = torch.zeros_like(b)
            for t in range(ffts):
                acc = acc + power[:, t0 + t]
            seed = acc * rffts
            seed = torch.where(seed == 0.0, one, seed)
            b = torch.where(b == 0.0, seed, b)
            for o in range(nout):
                acc = torch.zeros_like(b[0])
                for q in range(ns):
                    v = power[:, t0 + o * ns + q]
                    b = s * v + oms * b
                    op = v / b - 1.0
                    acc = acc + (sqh * (op[0] + op[1]) if npol == 2
                                 else op[0])
                ts[0, seg * nout + o] = acc * isn
            bp[0] = b
        if cfg.rfi_mode != 0:
            b = bp[1]
            acc = torch.zeros_like(b)
            ngood = np.zeros(npol, np.int64)
            for t in range(ffts):
                for p in range(npol):
                    w = float(wn[p, t0 + t])
                    if w > 0:
                        acc[p] = acc[p] + div(kur[p, t0 + t], w)
                        ngood[p] += 1
            for p in range(npol):
                seed = div(acc[p], ngood[p]) if ngood[p] else one[p]
                b0 = torch.where(b[p] == 0.0, seed, b[p])
                stale = (seed > 5.0 * b0) | (seed < r(0.2) * b0)
                b[p] = torch.where(stale, seed, b0) if ngood[p] else b0
            for o in range(nout):
                acc = torch.zeros_like(b[0])
                wsum, cnt = f32(0.0), 0
                for q in range(ns):
                    t = t0 + o * ns + q
                    op, wp = [], []
                    for p in range(npol):
                        w = f32(wn[p, t])
                        if w > 0:
                            x = div(kur[p, t], w)
                            clipped = x > b[p] * clip
                            b[p] = torch.where(clipped, b[p],
                                               s * x + oms * b[p])
                            op.append(torch.where(
                                clipped, torch.full_like(x, C.BP_CLIP_VALUE),
                                x / b[p] - 1.0))
                        else:
                            op.append(torch.zeros_like(b[p]))
                        wp.append(w)
                    if npol == 2:
                        g0, g1 = wp[0] >= minw, wp[1] >= minw
                        if g0 and g1:
                            v = sqh * (op[0] + op[1])
                            wt = f32(0.5) * (wp[0] + wp[1])
                        else:
                            v = op[0] * float(g0) + op[1] * float(g1)
                            wt = wp[0] * f32(g0) + wp[1] * f32(g1)
                    else:
                        v, wt = op[0], wp[0]
                    wg = wt if wt >= minw else f32(0.0)
                    cnt += bool(wt >= minw)
                    wsum = f32(wsum + wg)
                    acc = acc + float(wg) * v
                ok = wsum * rns >= minw
                ts[1, seg * nout + o] = \
                    div(acc, np.sqrt(f32(max(cnt, 1)))) if ok \
                    else torch.zeros_like(acc)
            bp[1] = b
    packed = [tq.sel_and_dig(ts[i][None], cfg.chanmin, cfg.chanmax, 2)
              for i in range(2)]
    return packed[0], packed[1], bp


@pytest.mark.parametrize("ffts", [16, 48])
@pytest.mark.parametrize("npol", [1, 2])
def test_chain_ema_matches_sequential_torch(cuda, npol, ffts):
    """The EMA launch of chain_second_v2 alone (ema_probe.chain_ema: the
    shipped build of csrc/chain.cu) on seeded power planes with
    blocks of weight 0, between 0 and 1 (flagged in part: the kurtosis
    plane) and 1 (the plain plane), bit-equal to _chain_ema_plain, the
    same sequential arithmetic in torch.  The kurtosis plane is NaN
    outside the blocks flagged in part, so a read of it there shows.
    16 spectra per segment: the bandpass walk computes the seeds from its
    registers; 48 (more than its chunk): seed_kernel computes them."""
    cfg = PipelineConfig(sample_rate=2048 * ffts * 3, seg_per_sec=3,
                         nfft=2048, nkurto=256, chanmin=101, chanmax=612,
                         nscrunch=8, rfi_mode=2, npol_in=npol)
    nblk = cfg.seg_per_sec * cfg.ffts_per_seg
    rng = np.random.default_rng(npol)
    plain = rng.chisquare(2, (npol, nblk, cfg.nchan)).astype(np.float32)
    plain[:, 5] = 0.0                       # dead spectrum
    plain[:, 20:36] *= 10.0                 # a step: the stale check fires
    plain[0, 40] *= 400.0                   # clipped spectrum
    kur = rng.chisquare(2, plain.shape).astype(np.float32) * 0.7
    w = np.ones(nblk, np.float32)
    w[[3, 17, 30]] = 0.0
    w[[8, 9, 25, 40, 41]] = np.float32(5 / 8)
    partial = ((w > 0) & (w < 1)).astype(np.uint8)
    kur[:, partial == 0] = np.nan
    bp = np.full((2, npol, cfg.nchan), 1.5, np.float32)
    bp[:, :, ::3] = 0.0                     # cold channels seed
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    args = (dev(plain), dev(kur), dev(partial),
            dev(np.tile(w, (npol, 1))), dev(bp), cfg)
    got = ema_probe.chain_ema(_build.load("chain"), *args)
    want = _chain_ema_plain(*args)
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        assert torch.equal(g, r)
    assert tq.unpack_bits(got[1].cpu(), 2).float().std() > 0


# the CT-major programs: chain_second in its three pretranspose modes and
# chain_second_v4 on u8 and bf16 tiles
CT_PROGRAMS = [("chain_second", {"pretranspose": m})
               for m in tmk.PRETRANSPOSE] \
    + [("chain_second_v4", {"pre_dtype": d}) for d in ("u8", "bf16")]


def _ct_bit_identical(cfg, raw, cuda):
    """Each CT-major program gives chain_second_v2's five outputs bit for
    bit over two seconds, each carrying its own bandpass: the same
    tensor-core DFT on the same bf16 frames, the same front and EMA."""
    npol = cfg.npol_in
    outs = {}
    for name, kw in [("chain_second_v2", {})] + CT_PROGRAMS:
        bp = torch.zeros((2, npol, cfg.nchan), device=cuda)
        outs[name, str(kw)] = []
        for _ in range(2):
            got = getattr(tmk, name)(raw, bp, cfg, **kw)
            outs[name, str(kw)].append(got)
            bp = got[4]
    torch.cuda.synchronize()
    v2 = outs.pop(("chain_second_v2", "{}"))
    for key, got in outs.items():
        for sec in range(2):
            for i, (g, w) in enumerate(zip(got[sec], v2[sec])):
                assert torch.equal(g, w), (key, sec, i)
    return v2


@pytest.mark.parametrize("npol", [1, 2])
@pytest.mark.parametrize("rfi_mode", [0, 1, 2])
def test_ct_chains_bit_identical_to_v2(cuda, rfi_mode, npol):
    cfg = _mk_cfg(rfi_mode=rfi_mode, npol_in=npol)
    raw = torch.from_numpy(np.ascontiguousarray(
        _noise(cfg.sample_rate, seed=7, burst_at=40000)[:npol])).to(cuda)
    v2 = _ct_bit_identical(cfg, raw, cuda)
    if rfi_mode:
        assert float(v2[1][2].mean()) < 1.0     # the gates fired


@pytest.mark.parametrize("npol", [1, 2])
def test_ct_chains_bit_identical_to_v2_n2_not_multiple_of_32(cuda, npol):
    """10000 = 100 x 100: the last slice of a tile is 4 rows, and the
    masked frames' windows (nkurto 500) cover 5 whole m1 rows."""
    cfg = PipelineConfig(sample_rate=10000 * 16 * 2, seg_per_sec=2,
                         nfft=10000, nkurto=500, chanmin=101, chanmax=612,
                         nscrunch=8, rfi_mode=2, npol_in=npol)
    raw = torch.from_numpy(np.ascontiguousarray(
        _noise(cfg.sample_rate, seed=13, burst_at=90000)[:npol])).to(cuda)
    v2 = _ct_bit_identical(cfg, raw, cuda)
    assert float(v2[1][2].mean()) < 1.0


@pytest.mark.parametrize("flagged", ["all", "none"])
def test_ct_chains_bit_identical_to_v2_every_block_flagged_or_none(
        cuda, flagged):
    """No block flagged in part (the list is empty): every window
    flagged, or none."""
    cfg = _mk_cfg(rfi_mode=2, dag_thresh=1e30 if flagged == "none" else 3.0)
    raw = _noise(cfg.sample_rate, seed=12)
    if flagged == "all":
        tone = (100 * np.sin(0.3 * np.arange(cfg.sample_rate)))
        raw = np.clip(raw + tone.astype(np.int16), 0, 255).astype(np.uint8)
    v2 = _ct_bit_identical(cfg, torch.from_numpy(raw).to(cuda), cuda)
    assert bool((v2[0][2] == (0.0 if flagged == "all" else 1.0)).all())


def test_chain_kernel_rejects_unsupported(cuda):
    cfg = PipelineConfig.tiny()             # 8-bit: not the kernel's
    raw = torch.zeros((2, cfg.sample_rate), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        tmk.chain_second_v2(raw, torch.zeros((2, 2, cfg.nchan),
                                             device=cuda), cfg)


@pytest.mark.parametrize("nsub", [64, 128])
@pytest.mark.parametrize("mode", ["linear", "tol"])
def test_dedisperse_kernel_matches_plain(cuda, mode, nsub):
    freqs = np.linspace(400.0, 350.0, 256)
    scfg = SearchConfig(dm_min=0.0, dm_max=100.0, ndm=64, dm_grid_mode=mode)
    dms = tsearch.make_dm_grid(scfg, 2e-3, freqs)
    plan = tdd.make_plan(dms, freqs, 2e-3, nsub=nsub, nbatch=16,
                         zap_ranges=((0, 10),), device=cuda)
    rng = np.random.default_rng(nsub)
    fb = torch.from_numpy(rng.standard_normal(
        (300 + plan.max_delay, 256)).astype(np.float32)).to(cuda)
    got = tddp.dedisperse_pallas(fb, plan, 300)
    want = tdd.dedisperse(fb, plan, 300)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-4)


def test_launch_counters_count_kernel_launches(cuda):
    cfg = PipelineConfig(sample_rate=2048 * 16, seg_per_sec=1, nfft=2048,
                         nkurto=256, chanmin=100, chanmax=611)
    raw = torch.from_numpy(_noise(cfg.sample_rate, seed=1)).to(cuda)
    before = dict(tmk.LAUNCHES)
    tmk.chain_second_v2(raw, torch.zeros((2, 2, cfg.nchan), device=cuda),
                        cfg)
    tmk.chain_second_v2_plain(raw, torch.zeros((2, 2, cfg.nchan),
                                               device=cuda), cfg)
    assert tmk.LAUNCHES == dict(before, chain_second_v2=before[
        "chain_second_v2"] + 1)
    before = dict(tmk.LAUNCHES)
    bp0 = torch.zeros((2, 2, cfg.nchan), device=cuda)
    for mode in tmk.PRETRANSPOSE:
        tmk.chain_second(raw, bp0, cfg, pretranspose=mode)
    tmk.chain_second_v4(raw, bp0, cfg)
    tmk.chain_second_ct_plain(raw, bp0, cfg)
    tmk.pallas_pretranspose_plain(raw, cfg.nfft, 2, 1)
    # 'xla' relayouts with torch; 'pallas', 'pallas_bf16' and v4 each
    # launch the pretranspose kernel
    assert tmk.LAUNCHES == dict(
        before,
        chain_second=before["chain_second"] + 3,
        chain_second_v4=before["chain_second_v4"] + 1,
        pallas_pretranspose=before["pallas_pretranspose"] + 3)
    before = trfi.LAUNCHES
    trfi.rfi_front(raw, cfg.nkurto, cfg.nfft)
    trfi.rfi_front_plain(raw, cfg.nkurto, cfg.nfft)
    assert trfi.LAUNCHES == before + 1
    p = torch.rand((2, 16, 33), device=cuda)
    bp, w = torch.zeros((2, 33), device=cuda), torch.ones((2, 16),
                                                          device=cuda)
    before = dict(tpk.LAUNCHES)
    tpk.normalize_ema_pallas(p, bp, 0.02)
    tpk.normalize_ema_weighted_pallas(p, w, bp, 0.02)
    tdsp.norm_ops.normalize_ema(p, bp, 0.02)
    assert tpk.LAUNCHES == {k: v + 1 for k, v in before.items()}


# sha-256 of the fine TS (f32 bytes) that the first design of
# csrc/rfi_front.cu (one byte per lane from device memory, the gates on one
# thread) gave on an H100 for _rfi_input(nkurto, nfft, npol): the redesign
# keeps every sum's order, so its TS are these bits
RFI_TS_SHA256 = {
    (30, 600, 1):
        "8e50c33b7f90c2c8650700d242c58ed8fb247993fc8f65dfe3c0100b3d62b7d3",
    (30, 600, 2):
        "c47eba58b77aed24e6610e1036312d78ea2658a2275c76c9ab5958d788b4cc68",
    (45, 630, 1):
        "12559231ed0d83790095000c1464e285af2f4c9b70c78848e982358402f5ec75",
    (45, 630, 2):
        "6db0cff3bed0534eda01bf9b67c3827a4b0dd785f7e702f57cdeb64500b9e831",
    (50, 500, 1):
        "2a8c33f95192319d98ea3fa2e580701dfa3efff72261d382dce48ba1a780b43a",
    (50, 500, 2):
        "5cd3d3cc668cbcc87123a36ce6c502d923324aab4bd5f5300f22c9eb6c2591de"}


def _rfi_input(nkurto, nfft, npol, cuda):
    """300 FFT blocks of _noise with the burst at 40000 and a square wave
    over block 10 of pol 0 (every window of the block flagged); npol 1 at
    a byte offset of 3 from its allocation (no block 16-byte aligned)."""
    raw = _noise(300 * nfft, seed=3, burst_at=40000)
    raw[0, 10 * nfft:11 * nfft] = np.where(np.arange(nfft) % 8 < 4, 228, 28)
    if npol == 2:
        return torch.from_numpy(raw).to(cuda)
    flat = np.zeros(raw.shape[1] + 3, np.uint8)
    flat[3:] = raw[0]
    return torch.from_numpy(flat).to(cuda)[3:].reshape(1, -1)


@pytest.mark.parametrize("dag_fb_thresh", [0.0, 5.0])
@pytest.mark.parametrize("npol", [1, 2])
@pytest.mark.parametrize("nkurto,nfft", [(50, 500), (30, 600), (45, 630)])
def test_rfi_front_kernel_matches_plain(cuda, npol, dag_fb_thresh, nkurto,
                                        nfft):
    """tiny()'s geometry (nkurto 50, nfft 500), and two where a float4 of
    the output straddles two windows (nfft 630: 16-byte boundaries fall
    inside blocks of the output too)."""
    raw = _rfi_input(nkurto, nfft, npol, cuda)
    thresh = PipelineConfig.tiny().dag_thresh
    got = trfi.rfi_front(raw, nkurto, nfft, thresh, dag_fb_thresh)
    want = trfi.rfi_front_plain(raw, nkurto, nfft, thresh, dag_fb_thresh)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[2] >= thresh, want[2] >= thresh)
    np.testing.assert_allclose(got[2].cpu().numpy(), want[2].cpu().numpy(),
                               rtol=0, atol=1e-5)
    ts = hashlib.sha256(got[2].cpu().numpy().tobytes()).hexdigest()
    assert ts == RFI_TS_SHA256[(nkurto, nfft, npol)]
    wpf = nfft // nkurto
    assert bool((got[2][10 * wpf:11 * wpf] >= thresh).all())
    assert bool((got[1][:, 10] == 0.0).all())
    assert not bool(got[0][:, 10 * nfft:11 * nfft].any())
    assert float(got[1].max()) == 1.0


def _ema_inputs(seed, cuda):
    rng = np.random.default_rng(seed)
    p = rng.chisquare(2, (2, 96, 300)).astype(np.float32)
    p[:, 17] = 0.0                          # dead spectrum
    p[:, 64:] *= 10.0                       # a step: the stale check fires
    p[0, 40] *= 400.0                       # clipped spectrum
    bp = np.full((2, 300), 1.5, np.float32)
    bp[:, ::3] = 0.0                        # cold channels seed
    w = np.ones((2, 96), np.float32)
    w[:, 10] = 0.0                          # zero-weight row
    w[1, 30:35] = 0.5
    return (torch.from_numpy(a).to(cuda) for a in (p, bp, w))


@pytest.mark.parametrize("npol", [1, 2])
@pytest.mark.parametrize("time_tile", [0, 1, 16, 32])
def test_ema_kernel_matches_plain(cuda, time_tile, npol):
    """The unweighted EMA (chain.cuh's plain stream: the seed pass where a
    tile is longer than the walk's 32-spectrum chunk, here the whole block
    of 96; the walk; the output pass) bit-equal to its plain version, with
    a dead spectrum, a 10x step, cold channels and, in channels 0, 15,
    30, ..., a first 32 spectra of zero power under a cold bandpass (a
    tile of mean 0 seeds 1, as 'scan')."""
    p, bp, _ = _ema_inputs(4, cuda)
    p[:, :32, ::15] = 0.0
    p, bp = p[:npol].contiguous(), bp[:npol].contiguous()
    got = tpk.normalize_ema_pallas(p, bp, 0.02, time_tile=time_tile)
    want = tdsp.norm_ops.normalize_ema(p, bp, 0.02, time_tile)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(torch.isfinite(got[0]).all())


@pytest.mark.parametrize("time_tile", [0, 16])
def test_ema_weighted_kernel_matches_plain(cuda, time_tile):
    p, bp, w = _ema_inputs(5, cuda)
    got = tpk.normalize_ema_weighted_pallas(p, w, bp, 0.05,
                                            time_tile=time_tile)
    want = tdsp.norm_ops.normalize_ema_weighted(p, w, bp, 0.05,
                                                time_tile=time_tile)
    torch.cuda.synchronize()
    for g, ww in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), ww.cpu().numpy(),
                                   rtol=2e-6, atol=2e-6)
    assert (got[0][:, 10] == 0.0).all()
    assert (got[0][0, 40] == 10.0).any()


@pytest.mark.parametrize("arm", [False, True])
@pytest.mark.parametrize("rfi_mode", [0, 1, 2])
def test_armed_second_kernels_match_plain(cuda, rfi_mode, arm):
    """process_second (the three kernels) against process_second_plain
    (torch ops, segment by segment) on the card, over two seconds."""
    cfg = PipelineConfig.tiny(rfi_mode=rfi_mode, nbit=2, inject_frb=True,
                              inject_dm=30.0, inject_amp=1.5)
    st_k = st_p = tdsp.init_state(cfg, cuda)
    before = (trfi.LAUNCHES, dict(tpk.LAUNCHES))
    for sec, seed in enumerate((1, 2)):
        raw = torch.from_numpy(_noise(cfg.sample_rate, seed=seed,
                                      burst_at=40000)).to(cuda)
        got, st_k = tdsp.process_second(cfg, raw, st_k, arm and sec == 0)
        want, st_p = tdsp.process_second_plain(cfg, raw, st_p,
                                               arm and sec == 0)
        torch.cuda.synchronize()
        for field in ("packed", "packed_kur"):
            _assert_levels(getattr(got, field), getattr(want, field))
        assert torch.equal(got.weights, want.weights)
        assert abs(float(got.dag_frac) - float(want.dag_frac)) < 1e-6
        _assert_bp(st_k.bp, st_p.bp)
        _assert_bp(st_k.bp_kur, st_p.bp_kur)
        assert st_k.segs_since_inject == st_p.segs_since_inject
    assert trfi.LAUNCHES - before[0] == (2 if rfi_mode else 0)
    assert tpk.LAUNCHES["normalize_ema_pallas"] - \
        before[1]["normalize_ema_pallas"] == (0 if rfi_mode == 1 else 2)
    assert tpk.LAUNCHES["normalize_ema_weighted_pallas"] - \
        before[1]["normalize_ema_weighted_pallas"] == (2 if rfi_mode else 0)


def test_pipeline_off_megakernel_config_matches_cpu(cuda, tmp_path):
    """An 8-bit configuration (no chain kernel) runs on the card: the
    twin is process_second, and the candidates are the CPU run's
    (compared as tests/test_torch_pipeline.py compares them)."""
    cfg = PipelineConfig.tiny(inject_frb=True, inject_dm=30.0,
                              inject_amp=2.0, inject_width_s=8e-3)
    scfg = SearchConfig.tiny()
    rng = np.random.default_rng(17)
    secs = [np.clip(rng.standard_normal((2, cfg.sample_rate)) / 0.05914
                    + 128.5, 0, 255).astype(np.uint8) for _ in range(3)]
    results = []
    for dev in ("cpu", cuda):
        pipe = StationPipeline(1, cfg, scfg, out_dir=str(tmp_path),
                               write_cands=False, device=dev)
        assert pipe._twin is tdsp.process_second
        pipe.prewarm()                      # its launches are set-up
        before = (trfi.LAUNCHES, dict(tpk.LAUNCHES))
        results.append(pipe.run_observation(
            ((1.6e9 + s, b) for s, b in enumerate(secs)),
            ObservationDocument(name="CUDA", start_time=1.6e9),
            write_fil=False))
    # on the card every second (armed and twin) went through the kernels
    assert trfi.LAUNCHES - before[0] == len(secs)
    assert all(v - before[1][k] == len(secs)
               for k, v in tpk.LAUNCHES.items())
    clear = scfg.snr_thresh + 0.5
    cands = [sorted((c for c in r.candidates if c.snr > clear),
                    key=lambda c: (c.peak_idx, c.dmi)) for r in results]
    assert len(cands[0]) >= 1
    assert [(c.dmi, c.peak_idx, c.tfilt) for c in cands[1]] == \
        [(c.dmi, c.peak_idx, c.tfilt) for c in cands[0]]
    np.testing.assert_allclose([c.snr for c in cands[1]],
                               [c.snr for c in cands[0]], rtol=1e-3)


def test_pipeline_megakernel4_matches_cpu(cuda, tmp_path):
    """twin_chain_impl='megakernel4' on the card: every twin second
    launches the pretranspose and the v4 chain kernel once (never the v2
    kernel), and the candidates are the CPU run's."""
    cfg = PipelineConfig.tiny(nbit=2, inject_frb=True, inject_dm=30.0,
                              inject_amp=2.0, inject_width_s=8e-3,
                              twin_chain_impl="megakernel4")
    scfg = SearchConfig.tiny()
    rng = np.random.default_rng(17)
    secs = [np.clip(rng.standard_normal((2, cfg.sample_rate)) / 0.05914
                    + 128.5, 0, 255).astype(np.uint8) for _ in range(4)]
    ntwin = len(secs) - tdsp.inject_window_seconds(cfg)
    assert ntwin >= 1
    results = []
    for dev in ("cpu", cuda):
        pipe = StationPipeline(1, cfg, scfg, out_dir=str(tmp_path),
                               write_cands=False, device=dev)
        assert pipe._twin is tdsp.twin_second
        assert pipe._cfg_noinject.chain_impl == "megakernel4"
        pipe.prewarm()                      # its launches are set-up
        before = dict(tmk.LAUNCHES)
        results.append(pipe.run_observation(
            ((1.6e9 + s, b) for s, b in enumerate(secs)),
            ObservationDocument(name="CUDA", start_time=1.6e9),
            write_fil=False))
    assert tmk.LAUNCHES == dict(
        before, chain_second_v4=before["chain_second_v4"] + ntwin,
        pallas_pretranspose=before["pallas_pretranspose"] + ntwin)
    clear = scfg.snr_thresh + 0.5
    cands = [sorted((c for c in r.candidates if c.snr > clear),
                    key=lambda c: (c.peak_idx, c.dmi)) for r in results]
    assert len(cands[0]) >= 1
    assert [(c.dmi, c.peak_idx, c.tfilt) for c in cands[1]] == \
        [(c.dmi, c.peak_idx, c.tfilt) for c in cands[0]]
    np.testing.assert_allclose([c.snr for c in cands[1]],
                               [c.snr for c in cands[0]], rtol=1e-3)


def _uniform(npol, nsamp, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 256, size=(npol, nsamp), dtype=np.uint8)


# tests/test_megakernel.py's geometry (nfft 2048 = 32 x 64, 16 FFTs, 3
# segments), and the production CT split (12500 = 100 x 125) on 2 short
# segments
STAGED = [(2048, 16, 3), (12500, 4, 2)]


# besides: n1 = 20 (not a multiple of 16) with frames 4-byte aligned
# (500 % 16 == 4), n2 = 100 (not a multiple of 32: stage 2 reads W2's
# padded depth), and the split mode (124 x 124: two blocks per frame)
@pytest.mark.parametrize("nfft,ffts,nseg",
                         STAGED + [(500, 8, 2), (10000, 2, 2), (15376, 2, 2)])
@pytest.mark.parametrize("npol", [1, 2])
def test_dft_detect_power_kernel_matches_oracle(cuda, npol, nfft, ffts,
                                                nseg):
    raw = torch.from_numpy(_uniform(npol, nfft * ffts * nseg, 3)).to(cuda)
    raw[0, :50] = 0                         # zero bytes convert to 0.0
    if npol == 1:
        # a buffer 4 bytes past a 16-byte boundary, ending mid-span
        buf = torch.from_numpy(_uniform(1, nfft * ffts * nseg + 8, 4)).to(
            cuda)
        raw = buf[:, 4:4 + nfft * ffts * nseg]
        assert raw.is_contiguous() and raw.data_ptr() % 16 == 4
    before = dict(tmk.LAUNCHES)
    got = tmk.dft_detect_power(raw, nfft, npol, nseg)
    want = tmk.dft_detect_oracle(raw, nfft, npol, nseg)
    torch.cuda.synchronize()
    assert tmk.LAUNCHES == dict(
        before, dft_detect_power=before["dft_detect_power"] + 1)
    assert got.shape == want.shape == (nseg, npol * ffts, nfft // 2 + 1)
    rel = (got - want).abs() / want.abs().clamp(min=1e-3)
    assert float(rel.max()) < 2e-3, float(rel.max())


@pytest.mark.parametrize("nfft,ffts,nseg", STAGED)
@pytest.mark.parametrize("npol", [1, 2])
def test_chain_second_plain_kernel_matches_oracle(cuda, npol, nfft, ffts,
                                                  nseg):
    nscrunch = 4 if ffts % 8 else 8
    chanmin, chanmax = (101, 612) if nfft == 2048 else (2155, 6250)
    chanmax -= (chanmax - chanmin + 1) % 4
    args = (nfft, npol, nseg, nscrunch, 0.02, chanmin, chanmax)
    bp_k = bp_p = torch.zeros((npol, nfft // 2 + 1), device=cuda)
    for seed in (5, 6):                     # the second carries the bandpass
        raw = torch.from_numpy(_uniform(npol, nfft * ffts * nseg,
                                        seed)).to(cuda)
        before = dict(tmk.LAUNCHES)
        got, bp_k = tmk.chain_second_plain(raw, bp_k, *args)
        want, bp_p = tmk.chain_second_plain_oracle(raw, bp_p, *args)
        torch.cuda.synchronize()
        assert tmk.LAUNCHES == dict(
            before, chain_second_plain=before["chain_second_plain"] + 1)
        assert got.shape == want.shape == (
            nseg * ffts // nscrunch, (chanmax - chanmin + 1) // 4)
        _assert_levels(got, want)
        _assert_bp(bp_k, bp_p)


def _sha256(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _tc_digests(cuda) -> dict:
    """sha-256 of what the kernels on dft_tc.cuh's raw-second loader give
    on fixed inputs: chain_second_v2's five outputs over two seconds
    (bandpass carried, rfi_mode 2, npol 1 and 2, the burst), and
    dft_detect_power's power and chain_second_plain's rows and bandpass
    at the STAGED geometries."""
    out = {}
    for npol in (1, 2):
        cfg = _mk_cfg(rfi_mode=2, npol_in=npol)
        raw = torch.from_numpy(np.ascontiguousarray(
            _noise(cfg.sample_rate, seed=7, burst_at=40000)[:npol])).to(cuda)
        bp, outs = torch.zeros((2, npol, cfg.nchan), device=cuda), []
        for _ in range(2):
            got = tmk.chain_second_v2(raw, bp, cfg)
            outs += got
            bp = got[4]
        out[f"chain_second_v2/npol{npol}"] = _sha256(*outs)
    for nfft, ffts, nseg in STAGED:
        raw = torch.from_numpy(_uniform(2, nfft * ffts * nseg, 3)).to(cuda)
        out[f"dft_detect_power/{nfft}"] = _sha256(
            tmk.dft_detect_power(raw, nfft, 2, nseg))
        chans = (101, 612) if nfft == 2048 else (2155, 6250)
        chans = (chans[0], chans[1] - (chans[1] - chans[0] + 1) % 4)
        packed, bp = tmk.chain_second_plain(
            raw, torch.zeros((2, nfft // 2 + 1), device=cuda), nfft, 2, nseg,
            4, 0.02, *chans)
        out[f"chain_second_plain/{nfft}"] = _sha256(packed, bp)
    return out


# _tc_digests on an H100 with the kernels as they were before the CT-major
# layouts moved onto dft_tc.cuh (its loader template): the raw second's
# path must keep these bits
TC_SHA256 = {
    "chain_second_plain/12500":
        "d3f334799503f95aa2b3e63db50d0d02c9cdac6f408394f8b508a0a1103723a6",
    "chain_second_plain/2048":
        "afd191a9afaffb7f200b96985f5a6e324eb388ff44c982696b15c183281af92a",
    "chain_second_v2/npol1":
        "bddf2a5ee6a319bf9ae2b8eef623424fd4dfb1cdcf065a552657d5fa2ad62e3f",
    "chain_second_v2/npol2":
        "1d398d15a48fd384419bb74e26b37a5ffb1c5ed56c99b38d25a9f4663f729c50",
    "dft_detect_power/12500":
        "c1c0f3ade94533ba3b861480866c822978baa1492c652e70dc45b23495faafbb",
    "dft_detect_power/2048":
        "eab6b0807502b963b97f309c5ccbd019e7086af56fdd0a94fc2b0f9ec955463f"}


def test_tensor_core_kernels_keep_their_bits(cuda):
    assert _tc_digests(cuda) == TC_SHA256


@pytest.mark.parametrize("sub_chunk", [16, 3])
@pytest.mark.parametrize("nsub", [8, 64])
@pytest.mark.parametrize("mode", ["linear", "tol"])
def test_rollsel_kernel_matches_plain(cuda, mode, nsub, sub_chunk):
    freqs = np.linspace(400.0, 350.0, 256)
    scfg = SearchConfig(dm_min=0.0, dm_max=100.0, ndm=64, dm_grid_mode=mode)
    dms = tsearch.make_dm_grid(scfg, 2e-3, freqs)
    plan = tdd.make_plan(dms, freqs, 2e-3, nsub=nsub, nbatch=16,
                         zap_ranges=((0, 10),), device=cuda)
    rng = np.random.default_rng(nsub)
    fb = torch.from_numpy(rng.standard_normal(
        (300 + plan.max_delay, 256)).astype(np.float32)).to(cuda)
    before = tddp.ROLLSEL_LAUNCHES
    got = tddp.dedisperse_pallas_rollsel(fb, plan, 300, sub_chunk)
    want = tddp.dedisperse_rollsel_plain(fb, plan, 300, sub_chunk)
    fold = tddp.dedisperse_pallas(fb, plan, 300)
    torch.cuda.synchronize()
    assert tddp.ROLLSEL_LAUNCHES == before + 1
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.cpu().numpy(), fold.cpu().numpy(),
                               rtol=1e-5, atol=1e-4)


def _dd_plan(cuda, nsub):
    freqs = np.linspace(400.0, 350.0, 256)
    scfg = SearchConfig(dm_min=0.0, dm_max=100.0, ndm=64, dm_grid_mode="tol")
    dms = tsearch.make_dm_grid(scfg, 2e-3, freqs)
    return tdd.make_plan(dms, freqs, 2e-3, nsub=nsub, nbatch=16,
                         zap_ranges=((0, 10), (100, 120)), device=cuda)


@pytest.mark.parametrize("row", [64, 66])
@pytest.mark.parametrize("nsub", [8, 64, 128])
def test_dedisperse_packed_kernel_matches_plain(cuda, nsub, row):
    """The packed entry (two zapped ranges; rows of 64 bytes, or of 66
    holding more channels than nchan and not 8-byte aligned) against its
    plain version, and the f32 entry on the same values; several stage-1
    and stage-2 tiles.  nsub 8 is 32 channels a subband, the production
    width (8-byte rows: one load per row and subband)."""
    plan = _dd_plan(cuda, nsub)
    rng = np.random.default_rng(nsub)
    ntime_out = 700
    packed = torch.from_numpy(rng.integers(
        0, 256, (ntime_out + plan.max_delay, row), dtype=np.uint8)).to(cuda)
    before = (tddp.LAUNCHES, tddp.PACKED_LAUNCHES)
    got = tddp.dedisperse_pallas_packed(packed, 2, 256, plan, ntime_out)
    want = tddp.dedisperse_packed_plain(packed, 2, 256, plan, ntime_out)
    fb = tq.dequantize(packed, 2).reshape(packed.shape[0], -1)[:, :256]
    f32 = tddp.dedisperse_pallas(fb.contiguous(), plan, ntime_out)
    torch.cuda.synchronize()
    assert (tddp.LAUNCHES, tddp.PACKED_LAUNCHES) == (before[0] + 2,
                                                     before[1] + 1)
    for g in (got, f32):
        np.testing.assert_allclose(g.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-5, atol=1e-4)


def test_dedisperse_packed_kernel_other_nbit(cuda):
    """4-bit rows are dequantized and go through the f32 entry."""
    plan = _dd_plan(cuda, 64)
    rng = np.random.default_rng(4)
    packed = torch.from_numpy(rng.integers(
        0, 256, (300 + plan.max_delay, 128), dtype=np.uint8)).to(cuda)
    before = (tddp.LAUNCHES, tddp.PACKED_LAUNCHES)
    got = tddp.dedisperse_pallas_packed(packed, 4, 256, plan, 300)
    want = tddp.dedisperse_packed_plain(packed, 4, 256, plan, 300)
    torch.cuda.synchronize()
    assert (tddp.LAUNCHES, tddp.PACKED_LAUNCHES) == (before[0] + 1,
                                                     before[1])
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-4)


def test_dedisperse_kernel_clamps_at_the_last_sample(cuda):
    """A plan whose last batch reads past the filterbank's end (its
    in-subband delays raised by 80): both entries take the plain
    version's clamp at ntime - 1."""
    plan = _dd_plan(cuda, 8)
    rel = plan.rel_delays.clone()
    rel[-1] += 80
    plan = dataclasses.replace(plan, rel_delays=rel,
                               rel_delays_max=int(rel.max()))
    ntime_out = 600
    ntime = ntime_out + plan.max_delay
    assert ntime_out + plan.max_sub_delay + plan.rel_delays_max > ntime
    rng = np.random.default_rng(9)
    packed = torch.from_numpy(rng.integers(
        0, 256, (ntime, 64), dtype=np.uint8)).to(cuda)
    fb = tq.dequantize(packed, 2).reshape(ntime, -1)
    want = tdd.dedisperse(fb, plan, ntime_out)
    for got in (tddp.dedisperse_pallas(fb, plan, ntime_out),
                tddp.dedisperse_pallas_packed(packed, 2, 256, plan,
                                              ntime_out)):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("time_tile", [1, 32, 0])
def test_ema_weighted_kernel_bit_equal(cuda, time_tile):
    """The weighted EMA (three phases) bit-equal to its plain version:
    time tiles of 1, 32 and the whole block (0; longer than the walk's
    chunk, so the seed pass runs), with a tile of all-zero weights, a
    weight of 0.5, clipped spectra, a tile ten times up (the stale
    reseed) and cold channels."""
    rng = np.random.default_rng(11)
    p = rng.chisquare(2, (2, 128, 300)).astype(np.float32)
    p[:, 64:96] *= 10.0
    p[0, 40] *= 400.0
    p[1, 100, ::7] *= 400.0
    w = np.ones((2, 128), np.float32)
    w[:, 32:64] = 0.0
    w[1, 5:9] = 0.5
    w[0, 100] = 0.0
    bp = np.full((2, 300), 1.5, np.float32)
    bp[:, ::3] = 0.0
    p, w, bp = (torch.from_numpy(a).to(cuda) for a in (p, w, bp))
    got = tpk.normalize_ema_weighted_pallas(p, w, bp, 0.05,
                                            time_tile=time_tile)
    want = tdsp.norm_ops.normalize_ema_weighted(p, w, bp, 0.05,
                                                time_tile=time_tile)
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        assert torch.equal(g, r)
    assert (got[0][:, 32:64] == 0.0).all()
    # a tile of one spectrum reseeds at a spike instead of clipping it
    assert bool((got[0] == C.BP_CLIP_VALUE).any()) == (time_tile != 1)


@pytest.mark.parametrize("nb", [1, 3, 128])
@pytest.mark.parametrize("reps", [1, 7, 320])
@pytest.mark.parametrize("impl", ttp.IMPLS)
def test_tile_bench_kernel_every_cluster_fill(cuda, impl, reps, nb):
    """Clusters of 8 steps: 1 and 7 steps fill none (the idle blocks only
    take part in the cluster's barriers), 320 fill 40."""
    x = torch.from_numpy(np.random.default_rng(nb).standard_normal(
        (nb * ttp.LANE, ttp.LANE)).astype(np.float32)).to(cuda)
    got = ttp.tile_sum(x, impl, reps=reps)
    want = ttp.tile_sum_plain(x, impl)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("impl", ttp.IMPLS)
def test_tile_bench_kernel_matches_plain(cuda, impl):
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (4 * ttp.LANE, ttp.LANE)).astype(np.float32)).to(cuda)
    before = ttp.LAUNCHES
    got = ttp.tile_sum(x, impl, reps=3)
    want = ttp.tile_sum_plain(x, impl)
    torch.cuda.synchronize()
    assert ttp.LAUNCHES == before + 1
    assert torch.equal(got, want)


FIRST_ARMED = r"""
import json, numpy as np, torch
from vlite_fast_tpu_torch import PipelineConfig, SearchConfig
from vlite_fast_tpu_torch.runtime.pipeline import (ObservationDocument,
                                                   StationPipeline)
dev = torch.device("cuda")
cfg = PipelineConfig(inject_frb=True)
gen = torch.Generator(device=dev).manual_seed(3)
secs = [(torch.randn((cfg.npol_in, cfg.sample_rate), generator=gen,
                     device=dev) / 0.05914 + 128.5).clamp(0, 255)
        .to(torch.uint8) for _ in range(3)]
pipe = StationPipeline(1, cfg, SearchConfig(), write_cands=False, device=dev)
pipe.run_observation(((1.7e9 + s, b) for s, b in enumerate(secs)),
                     ObservationDocument(name="COLD"), write_fil=False)
print(json.dumps(pipe.feed_seconds))
"""


def test_first_armed_second_is_not_cold(cuda):
    """In a fresh process at the production geometry, the first armed
    second (second 0) takes at most twice the second armed one: the
    pipeline's prewarm paid every first-use cost before it."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", FIRST_ARMED], cwd=root,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    times = json.loads(res.stdout.strip().splitlines()[-1])
    armed = times["armed"]
    assert len(armed) == tdsp.inject_window_seconds(
        PipelineConfig(inject_frb=True)) and len(armed) >= 2
    assert armed[0] <= 2.0 * armed[1], armed
