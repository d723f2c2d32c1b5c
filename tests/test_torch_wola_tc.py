"""The pfb station's fused WOLA, DFT and detect (ops/megakernel
.wola_dft_detect_power) on the CPU: its plain version, which the kernel
repeats, and the rule that routes process_second to it.

- The plain version equals the f32 polyphase channelizer's |X|^2
  (ch_ops.polyphase_channelize, method 'matmul') to the split-plane DFT's
  bar (2e-3 relative, floor 1e-3 of the mean power; the JAX package's bar
  for its stage A): bf16x3 drops lo * lo, 2^-16 of a product.  With a
  carried tail and without one (the first ntap - 1 blocks as the tail), at
  a small CT split (500 = 20 x 25) and at the production split (12500 =
  100 x 125) on a few frames, from u8 bytes and from f32 voltages.
- Its frame tiles (hi, lo) equal numpy's tap-ordered f32 sum and its
  round-to-nearest-even bf16 split bit for bit.
- process_second takes the kernel only for the pfb channelizer's
  seconds that inject nothing (un-armed, or armed past the track's last
  spectrum) on a card at a geometry the kernel takes; on the CPU it
  keeps the f32 path and launches nothing.
- The masked stream computed only in the frames whose taps reach a block
  the RFI front masked (wola_masked_frames), over the plain stream's
  rows, equals it computed whole, bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vlite_fast_tpu_torch.config import PipelineConfig
from vlite_fast_tpu_torch.models import baseband_dsp as tdsp
from vlite_fast_tpu_torch.ops import channelize as tch
from vlite_fast_tpu_torch.ops import megakernel as tmk
from vlite_fast_tpu_torch.ops import normalize as tnorm
from vlite_fast_tpu_torch.ops import unpack as tunpack

torch.set_num_threads(1)


def _cfg(nfft, nblk):
    return PipelineConfig(channelizer="pfb", nfft=nfft,
                          sample_rate=nfft * nblk, seg_per_sec=1,
                          nscrunch=1, nkurto=nfft, chanmin=0, chanmax=3)


def _raw(npol, nsamp, seed):
    rng = np.random.default_rng(seed)
    raw = np.clip(rng.standard_normal((npol, nsamp)) / 0.05914 + 128.5, 0,
                  255).astype(np.uint8)
    raw[0, :50] = 0                         # zero bytes convert to 0.0
    return torch.from_numpy(raw)


def _source(raw, src, seed):
    """The stream's voltages: the raw bytes (stream 0) or masked f32
    voltages (stream 1: windows zeroed, the rest exact k/128)."""
    if src == "u8":
        return raw
    x = tunpack.convert_uint8(raw)
    keep = torch.from_numpy(np.random.default_rng(seed).random(x.shape)
                            > 0.1)
    return x * keep


@pytest.mark.parametrize("src", ["u8", "f32"])
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("nfft,nblk,npol", [(500, 40, 2), (12500, 6, 1)])
def test_plain_matches_f32_channelizer(nfft, nblk, npol, carried, src):
    ntap = 4
    nh = ntap - 1
    cfg = _cfg(nfft, nblk)
    v = _source(_raw(npol, (nblk + nh) * nfft, 3), src, 4)
    x = tunpack.convert_uint8(v) if src == "u8" else v
    if carried:
        tail = torch.from_numpy(np.random.default_rng(5).standard_normal(
            (npol, nh * nfft)).astype(np.float32) * 0.3)
        got = tmk.wola_dft_detect_power(v[:, nh * nfft:].contiguous(), tail,
                                        cfg)
        spec = tch.polyphase_channelize(x[:, nh * nfft:], nfft, ntap,
                                        method="matmul", tail=tail)
    else:
        # the first ntap - 1 blocks as the tail: the frames of x alone
        got = tmk.wola_dft_detect_power(v[:, nh * nfft:].contiguous(),
                                        x[:, :nh * nfft].contiguous(), cfg)
        spec = tch.polyphase_channelize(x, nfft, ntap, method="matmul")
    want = tnorm.detect(spec)
    assert got.shape == want.shape == (npol, nblk, nfft // 2 + 1)
    rel = (got - want).abs() / want.abs().clamp(min=1e-3 * float(
        want.mean()))
    assert float(rel.max()) < 2e-3, float(rel.max())


def _bf16_rne(a: np.ndarray) -> np.ndarray:
    """float32 -> the nearest bfloat16 value (ties to even), as float32."""
    u = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("src", ["u8", "f32"])
def test_frame_tiles_are_the_tap_ordered_sum_split(src):
    nfft, ntap, nblk, npol = 500, 4, 12, 2
    v = _source(_raw(npol, nblk * nfft, 6), src, 7)
    tail = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (npol, (ntap - 1) * nfft)).astype(np.float32))
    hi, lo = tmk.wola_split_frames(v, tail, nfft, ntap)
    x = (tunpack.convert_uint8(v) if src == "u8" else v).numpy()
    win = tch._pfb_window(ntap, nfft).reshape(ntap, nfft)
    ext = np.concatenate([tail.numpy(), x], axis=1).reshape(npol, -1, nfft)
    f = ext[:, 0:nblk] * win[0]
    for t in range(1, ntap):
        f = f + ext[:, t:t + nblk] * win[t]
    assert f.dtype == np.float32
    want_hi = _bf16_rne(f)
    want_lo = _bf16_rne(f - want_hi)
    assert np.array_equal(hi.numpy().view(np.uint32), want_hi.view(np.uint32))
    assert np.array_equal(lo.numpy().view(np.uint32), want_lo.view(np.uint32))
    assert np.array_equal(_bf16_rne(hi.numpy()), hi.numpy())
    assert np.array_equal(_bf16_rne(lo.numpy()), lo.numpy())


class _Cuda:
    """A stand-in for a tensor on a card: only its device is read."""

    device = torch.device("cuda")


def test_process_second_routes_by_what_it_sees():
    cfg = PipelineConfig(channelizer="pfb", inject_frb=True)

    def takes(c, v, since):
        # process_second's route: the kernel in a twin second alone
        return (tdsp.second_program(c, since)[0] == "twin"
                and tdsp.wola_kernel_takes(c, v))

    assert takes(cfg, _Cuda(), -1)                   # a twin second
    assert takes(dataclasses.replace(cfg, inject_frb=False), _Cuda(), 5)
    assert not takes(cfg, _Cuda(), 0)                # the arming second
    assert not takes(cfg, _Cuda(), 317)              # the track reaches it
    assert takes(cfg, _Cuda(), 320)                  # armed, past the track
    assert takes(cfg, _Cuda(), 640)
    assert not takes(cfg, torch.zeros(2, 4), -1)     # the CPU
    assert not takes(dataclasses.replace(cfg, channelizer="matmul"),
                     _Cuda(), -1)
    # f32 asked for: the kernel's bf16x3 would be less
    assert not takes(dataclasses.replace(cfg, dft_precision="highest"),
                     _Cuda(), -1)
    # geometries the gate refuses: a tap count not built, no CT split, a
    # split past two warpgroups
    assert not takes(dataclasses.replace(cfg, pfb_ntap=3), _Cuda(), -1)
    assert not tmk.wola_fits(12500, 8)
    assert not tmk.wola_fits(12503, 4)               # prime: no CT split
    assert not tmk.wola_fits(130 * 130, 4)           # n1 = 130 > 128
    # the budget at production: W1 93 KB, W2 64 KB, the hi and lo tiles
    # 28 KB each, no ring (csrc/dft_tc.cuh's make_geom with wola)
    g = tmk.tc_geometry(12500, wola=True)
    assert (g.nslot, g.split, g.smem) == (0, False, 216064)
    assert tmk.tc_geometry(12500) == tmk.tc_geometry(12500, 0, False)


def test_process_second_on_the_cpu_launches_nothing():
    cfg = PipelineConfig.tiny(channelizer="pfb", nbit=2, rfi_mode=2)
    raw = _raw(2, cfg.sample_rate, 9)
    before = dict(tmk.LAUNCHES)
    got, st = tdsp.process_second(cfg, raw, tdsp.init_state(cfg, "cpu"))
    want, st_w = tdsp.process_second_plain(cfg, raw,
                                           tdsp.init_state(cfg, "cpu"))
    assert tmk.LAUNCHES == before
    assert torch.equal(got.weights, want.weights)
    assert torch.equal(st.tail, st_w.tail)


def _masked_second(cfg, seed):
    """A second's raw bytes with bursts, and the RFI front's masked
    voltages and raw block weights (the plain front)."""
    from vlite_fast_tpu_torch.ops import rfi_pallas
    rng = np.random.default_rng(seed)
    raw = np.clip(rng.standard_normal((2, cfg.sample_rate)) / 0.05914
                  + 128.5, 0, 255).astype(np.int16)
    t = np.arange(3000)
    for at in (40000, 400000):
        raw[0, at:at + 3000] += (60 * np.sin(0.3 * t)).astype(np.int16)
    raw = torch.from_numpy(np.clip(raw, 0, 255).astype(np.uint8))
    x_kur, w, _ = rfi_pallas.rfi_front_plain(
        raw, cfg.nkurto, cfg.nfft, dag_thresh=cfg.dag_thresh,
        dag_fb_thresh=cfg.dag_fb_thresh)
    return raw, x_kur, w


def test_masked_frames_are_those_whose_taps_reach_a_masked_block():
    ntap, npol, nspec = 4, 2, 50
    rng = np.random.default_rng(10)
    w = np.ones((npol, nspec), np.float32)
    w[rng.random((npol, nspec)) < 0.08] = 0.6
    w[1, 20] = 0.0
    wtail = np.ones((npol, ntap - 1), np.float32)
    wtail[0, 1] = 0.96
    frames, count = tmk.wola_masked_frames(torch.from_numpy(w),
                                           torch.from_numpy(wtail), ntap)
    ext = np.concatenate([wtail, w], axis=1) < 1
    want = [p * nspec + j for p in range(npol) for j in range(nspec)
            if ext[p, j:j + ntap].any()]
    assert frames.dtype == count.dtype == torch.int32
    assert frames.shape == (npol * nspec + 1,) and count.shape == (1,)
    assert int(count[0]) == len(want)
    assert frames[:len(want)].tolist() == want


def test_masked_stream_keeps_the_plain_rows_elsewhere():
    """The plain version of the masked stream computed over the plain
    stream's rows equals it computed whole, bit for bit: a frame whose taps
    reach no masked block has the plain stream's samples exactly."""
    cfg = PipelineConfig.tiny(channelizer="pfb", nbit=2, rfi_mode=2)
    raw, x_kur, w = _masked_second(cfg, 14)
    rng = np.random.default_rng(15)
    tail = torch.from_numpy(rng.standard_normal(
        (2, (cfg.pfb_ntap - 1) * cfg.nfft)).astype(np.float32))
    wtail = torch.ones((2, cfg.pfb_ntap - 1))
    frames = tmk.wola_masked_frames(w, wtail, cfg.pfb_ntap)
    n = int(frames[1][0])
    assert 0 < n < w.numel()            # some frames reach a masked block
    plain = tmk.wola_dft_detect_power(raw, tail, cfg)
    whole = tmk.wola_dft_detect_power(x_kur, tail, cfg)
    got = tmk.wola_dft_detect_power(x_kur, tail, cfg, frames, plain.clone())
    assert torch.equal(got, whole)
    rows = torch.ones(w.numel(), dtype=torch.bool)
    rows[frames[0][:n].long()] = False
    flat = lambda p: p.reshape(w.numel(), -1)
    assert torch.equal(flat(whole)[rows], flat(plain)[rows])
    assert not torch.equal(flat(whole)[~rows], flat(plain)[~rows])
