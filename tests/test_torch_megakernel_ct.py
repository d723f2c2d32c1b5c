"""The port's pretransposed chain kernels against the JAX package's, on
the CPU: pallas_pretranspose, chain_second (three pretranspose modes) and
chain_second_v4 (u8 and bf16 tiles), the TPU kernels in interpret mode.

Geometry of tests/test_megakernel.py: nfft 2048 (CT 32 x 64), 16 FFTs
per segment, 3 segments, nkurto 256, chanmin 101 (not a multiple of 4),
with a sinusoidal burst so the kurtosis gates fire.  On the CPU the
port's wrappers run their plain versions (the torch chain), which the
CUDA kernels are held against on the card (tests/test_torch_cuda.py).

Bars: the relayout byte-equal (u8) and value-equal (bf16); the chains to
the JAX package's bar for its own chain variants: >= 0.9999 of 2-bit
levels agree and none differs by more than one level, weights bit-equal,
dag_frac within 1e-6, bandpass within 1e-4 relative.  The TPU kernels'
factored outputs are refolded by the JAX package's own helpers
(unfactor_pack_realign / bp_from_factored for chain_second, the _v2
helpers for chain_second_v4, which writes v2 layouts).  Each JAX
reference is computed once per module.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlite_fast_tpu.config import PipelineConfig
from vlite_fast_tpu.models import baseband_dsp as jdsp
from vlite_fast_tpu.ops import megakernel as jmk
from vlite_fast_tpu.ops import quantize as jq
from vlite_fast_tpu_torch import config as tconfig
from vlite_fast_tpu_torch import interop
from vlite_fast_tpu_torch.models import baseband_dsp as tdsp
from vlite_fast_tpu_torch.ops import megakernel as tmk

torch.set_num_threads(1)


def _t(cfg):
    """The port's config of the same class and fields as a JAX package one."""
    return getattr(tconfig, type(cfg).__name__)(**dataclasses.asdict(cfg))


NFFT, NSEG = 2048, 3


def _cfg(rfi_mode=2, **kw):
    return PipelineConfig(sample_rate=NFFT * 16 * NSEG, seg_per_sec=NSEG,
                          nfft=NFFT, nkurto=256, chanmin=101, chanmax=612,
                          nscrunch=8, rfi_mode=rfi_mode, **kw)


def _noise(nsamp, seed, burst_at=None):
    """Gaussian 8-bit voltages with an optional sinusoidal burst in pol 0
    (tests/test_torch_chain.py's inputs)."""
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


def _assert_levels(got, want):
    la = np.asarray(jq.unpack_bits(jnp.asarray(np.asarray(got)), 2))
    lb = np.asarray(jq.unpack_bits(jnp.asarray(np.asarray(want)), 2))
    la, lb = la.astype(np.int16), lb.astype(np.int16)
    assert la.shape == lb.shape
    assert (la == lb).mean() >= 0.9999, (la == lb).mean()
    assert np.abs(la - lb).max() <= 1


def _assert_bp(got, want):
    got, want = np.asarray(got), np.asarray(want)
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-6)
    assert rel.max() < 1e-4, rel.max()


@pytest.fixture(scope="module")
def raw():
    cfg = _cfg()
    return _noise(cfg.sample_rate, seed=5, burst_at=40000)


def _jax_args(cfg):
    return (NFFT, 2, NSEG, cfg.nscrunch, cfg.nkurto, cfg.rfi_mode,
            float(cfg.bp_scale), float(cfg.dag_thresh),
            float(cfg.dag_fb_thresh))


@pytest.fixture(scope="module")
def jax_v1(raw):
    """JAX chain_second (pretranspose 'xla') per rfi_mode, refolded; the
    JAX package's own test holds its three pretranspose modes
    byte-identical."""
    out = {}
    for mode in (0, 1, 2):
        cfg = _cfg(mode)
        bp0 = jmk.bp_to_factored(jnp.zeros((4, cfg.nchan), jnp.float32),
                                 NFFT)
        pp, kk, w, dag, bp = jmk.chain_second(jnp.asarray(raw), bp0,
                                              *_jax_args(cfg))
        out[mode] = _refold(cfg, pp, kk, w, dag, bp, jmk.unfactor_pack_realign,
                            jmk.bp_from_factored)
    return out


@pytest.fixture(scope="module")
def jax_v4(raw):
    """JAX chain_second_v4 (pre_impl 'xlu') per pre_dtype at rfi_mode 2,
    refolded with the v2 helpers."""
    cfg = _cfg(2)
    bp0 = jmk.bp_to_factored_v2(jnp.zeros((4, cfg.nchan), jnp.float32), NFFT)
    out = {}
    for pre_dtype in ("u8", "bf16"):
        pp, kk, w, dag, bp = jmk.chain_second_v4(
            jnp.asarray(raw), bp0, *_jax_args(cfg), pre_dtype=pre_dtype,
            pre_impl="xlu")
        out[pre_dtype] = _refold(cfg, pp, kk, w, dag, bp,
                                 jmk.unfactor_pack_realign_v2,
                                 jmk.bp_from_factored_v2)
    return out


def _refold(cfg, pp, kk, w, dag, bp, unfact, from_fact):
    """The TPU kernel's outputs in the port's layouts: packed rows,
    weights (npol, nblk) from rows b = pol * ffts + t, dag_frac (nseg,),
    bandpass (2, npol, nchan)."""
    w = np.asarray(w)[:, :, 0]
    weights = np.concatenate([w[s].reshape(2, cfg.ffts_per_seg)
                              for s in range(NSEG)], axis=1)
    bp = np.asarray(bp)
    return (np.asarray(unfact(pp, NFFT, cfg.chanmin, cfg.chanmax)),
            np.asarray(unfact(kk, NFFT, cfg.chanmin, cfg.chanmax)),
            weights, np.asarray(dag)[:, 0],
            np.stack([from_fact(bp[:2], NFFT, cfg.nchan),
                      from_fact(bp[2:], NFFT, cfg.nchan)]))


def _assert_chain_matches(cfg, got, want):
    """The chain bar on the streams rfi_mode produces."""
    streams = [s for s, on in ((0, cfg.rfi_mode != 1),
                               (1, cfg.rfi_mode != 0)) if on]
    for s in streams:
        _assert_levels(got[s], want[s])
        _assert_bp(got[4][s], want[4][s])
    assert np.array_equal(got[2].numpy(), want[2])
    np.testing.assert_allclose(got[3].numpy(), want[3], atol=1e-6)
    if cfg.rfi_mode:
        assert want[2].mean() < 1.0           # the gates fired


def test_pallas_pretranspose_matches_jax(raw):
    """u8 tiles byte-equal to JAX's pretranspose_u8 and its Pallas
    relayout (interpret mode); bf16 tiles value-equal to the Pallas
    relayout's converted voltages."""
    r = raw.copy()
    r[1, :64] = 0                         # zero bytes convert to 0.0
    args = (NFFT, 2, NSEG)
    want_u8 = np.asarray(jmk.pretranspose_u8(jnp.asarray(r), *args))
    assert np.array_equal(np.asarray(jmk.pallas_pretranspose(
        jnp.asarray(r), *args)), want_u8)
    t = torch.from_numpy(r)
    assert np.array_equal(tmk.pretranspose_u8(t, *args).numpy(), want_u8)
    got_u8 = tmk.pallas_pretranspose(t, *args)
    assert got_u8.dtype == torch.uint8
    assert np.array_equal(got_u8.numpy(), want_u8)
    want_bf = np.asarray(jmk.pallas_pretranspose(
        jnp.asarray(r), *args, out_dtype=jnp.bfloat16)).astype(np.float32)
    got_bf = tmk.pallas_pretranspose(t, *args, torch.bfloat16)
    assert got_bf.dtype == torch.bfloat16
    assert np.array_equal(got_bf.float().numpy(), want_bf)
    assert tmk.LAUNCHES["pallas_pretranspose"] == 0    # CPU: plain


@pytest.mark.parametrize("pretranspose", ["xla", "pallas", "pallas_bf16"])
@pytest.mark.parametrize("rfi_mode", [0, 1, 2])
def test_chain_second_matches_jax(raw, jax_v1, rfi_mode, pretranspose):
    cfg = _cfg(rfi_mode)
    got = tmk.chain_second(torch.from_numpy(raw),
                           torch.zeros((2, 2, cfg.nchan)), _t(cfg),
                           pretranspose=pretranspose)
    assert tmk.LAUNCHES["chain_second"] == 0
    _assert_chain_matches(cfg, got, jax_v1[rfi_mode])


@pytest.mark.parametrize("pre_dtype", ["u8", "bf16"])
def test_chain_second_v4_matches_jax(raw, jax_v4, pre_dtype):
    cfg = _cfg(2)
    got = tmk.chain_second_v4(torch.from_numpy(raw),
                              torch.zeros((2, 2, cfg.nchan)), _t(cfg),
                              pre_dtype=pre_dtype, pre_impl="xlu")
    assert tmk.LAUNCHES["chain_second_v4"] == 0
    _assert_chain_matches(cfg, got, jax_v4[pre_dtype])


def test_wrappers_reject_unknown_modes(raw):
    cfg, t = _t(_cfg()), torch.from_numpy(raw)
    bp = torch.zeros((2, 2, cfg.nchan))
    with pytest.raises(ValueError, match="pretranspose"):
        tmk.chain_second(t, bp, cfg, pretranspose="mxu")
    with pytest.raises(ValueError, match="pre_dtype"):
        tmk.chain_second_v4(t, bp, cfg, pre_dtype="f32")


@pytest.mark.parametrize("chain_impl", ["megakernel", "megakernel4"])
def test_state_carry_from_jax_megakernel_second(chain_impl):
    """The JAX megakernel programs carry the natural DSPState: the port's
    twin, started from state_from_jax of a JAX second run with the same
    chain_impl, matches JAX's next second."""
    cfg = dataclasses.replace(_cfg(2), chain_impl=chain_impl)
    raws = [_noise(cfg.sample_rate, seed=s, burst_at=20000) for s in (31, 32)]
    _, st1 = jdsp.process_second(cfg, jnp.asarray(raws[0]),
                                 jdsp.init_state(cfg), jnp.asarray(False))
    oj, st2 = jdsp.process_second(cfg, jnp.asarray(raws[1]), st1,
                                  jnp.asarray(False))
    st_t = interop.state_from_jax(
        np.asarray(st1.bp), np.asarray(st1.bp_kur),
        np.asarray(st1.segs_since_inject), np.asarray(st1.tail),
        np.asarray(st1.wtail), device="cpu")
    assert tdsp.twin_program(_t(cfg)) is tdsp.twin_second
    ot, stt = tdsp.twin_second(_t(cfg), torch.from_numpy(raws[1]), st_t)
    for field in ("packed", "packed_kur"):
        _assert_levels(getattr(ot, field), getattr(oj, field))
    assert np.array_equal(ot.weights.numpy(), np.asarray(oj.weights))
    assert abs(float(ot.dag_frac) - float(oj.dag_frac)) < 1e-6
    _assert_bp(stt.bp, st2.bp)
    _assert_bp(stt.bp_kur, st2.bp_kur)
    assert stt.segs_since_inject == int(st2.segs_since_inject)


@pytest.mark.parametrize("rfi_mode", [0, 2])
def test_ct_plain_is_split_plane_at_seed_9(rfi_mode):
    """The CT chains' plain version runs the TPU kernels' split-plane bf16
    DFT: on the card test's seed-9 input (npol 2), where the f32 chain
    puts plain-stream level [2, 237] of second 0 one level off, it gives
    the JAX package's chain_second_v4 (interpret mode) level for level."""
    cfg = _cfg(rfi_mode)
    raw = _noise(cfg.sample_rate, seed=9, burst_at=40000)
    bp0 = jmk.bp_to_factored_v2(jnp.zeros((4, cfg.nchan), jnp.float32), NFFT)
    want = _refold(cfg, *jmk.chain_second_v4(
        jnp.asarray(raw), bp0, *_jax_args(cfg), pre_dtype="u8",
        pre_impl="xlu"), jmk.unfactor_pack_realign_v2,
        jmk.bp_from_factored_v2)
    bp = torch.zeros((2, 2, cfg.nchan))
    got = tmk.chain_second_v4_plain(torch.from_numpy(raw), bp, _t(cfg))
    f32 = tmk.chain_second_v2_plain(torch.from_numpy(raw), bp, _t(cfg))
    _assert_chain_matches(cfg, got, want)
    lev = lambda p: np.asarray(jq.unpack_bits(jnp.asarray(np.asarray(p)), 2))
    assert lev(got[0])[2, 237] == lev(want[0])[2, 237]
    assert lev(f32[0])[2, 237] != lev(want[0])[2, 237]


def test_split_power_matches_dft_detect_oracle():
    """split_power on converted bytes is stage A's oracle (one function,
    two layouts)."""
    cfg = _t(_cfg(0))
    raw = torch.from_numpy(_noise(cfg.sample_rate, seed=3))
    want = tmk.dft_detect_oracle(raw, NFFT, 2, NSEG)
    x = tdsp.unpack_ops.convert_uint8(raw)
    got = tmk.split_power(cfg, x, -1)                # (2, 48, nchan)
    ffts = cfg.ffts_per_seg
    got = got.reshape(2, NSEG, ffts, -1).transpose(0, 1).reshape(want.shape)
    assert torch.equal(got, want)


@pytest.mark.parametrize("npol", [1, 2])
@pytest.mark.parametrize("nfft", [12500, 2048, 10000, 630])
def test_pallas_pretranspose_every_frame_size_matches_jax(nfft, npol):
    """Frames that start 4-, 16-, 16- and 2-byte aligned in the second
    (the CUDA tests run the kernel on them at every alignment): u8 tiles
    byte-equal to JAX's pretranspose_u8, bf16 tiles value-equal to the
    JAX package's Pallas relayout (interpret mode)."""
    nseg, ffts = 2, 3
    r = np.random.default_rng(nfft + npol).integers(
        0, 256, (npol, nseg * ffts * nfft), dtype=np.uint8)
    r[0, :100] = 0                        # zero bytes convert to 0.0
    args = (nfft, npol, nseg)
    want_u8 = np.asarray(jmk.pretranspose_u8(jnp.asarray(r), *args))
    t = torch.from_numpy(r)
    got_u8 = tmk.pallas_pretranspose(t, *args)
    assert got_u8.shape == (nseg, npol * ffts * tmk.LANE, tmk.LANE)
    assert np.array_equal(got_u8.numpy(), want_u8)
    want_bf = np.asarray(jmk.pallas_pretranspose(
        jnp.asarray(r), *args, out_dtype=jnp.bfloat16)).astype(np.float32)
    got_bf = tmk.pallas_pretranspose(t, *args, torch.bfloat16)
    assert np.array_equal(got_bf.float().numpy(), want_bf)


def test_pallas_pretranspose_rejects_what_the_kernel_does_not_take():
    raw = torch.zeros((2, 2048 * 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="out_dtype"):
        tmk.pallas_pretranspose(raw, 2048, 2, 2, torch.float32)
    with pytest.raises(ValueError, match="exceed"):
        tmk.pallas_pretranspose(torch.zeros((2, 40000), dtype=torch.uint8),
                                40000, 2, 1)
    for bad in (raw.to(torch.int16), raw[:1], raw[:, :2048 * 3],
                raw.t().contiguous().t(), raw[:, ::2]):
        with pytest.raises(ValueError, match="contiguous uint8"):
            tmk.pallas_pretranspose(bad, 2048, 2, 2)
