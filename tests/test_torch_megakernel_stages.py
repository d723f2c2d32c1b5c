"""The port's staged chain (stage A: dft_detect_power; stage B:
chain_second_plain) against the JAX package's, on the CPU.

The JAX kernels run in interpret mode, as tests/test_megakernel.py runs
them, at its geometry (nfft 2048 split 32 x 64, 16 FFTs per segment, 3
segments, chanmin 101 so that chanmin % 4 != 0, chanmax 612).  The port
returns linear channels; the JAX side is unfolded with its own helpers
(unfactor_pack_realign, bp_from_factored).  Bars: tests/test_megakernel.py's
own for its stages — stage A within 2e-3 relative (floor 1e-3) of the
kernel and of the bf16-emulation oracle, 5e-3 (floor 1e-2) of the f32 XLA
chain; stage B's 2-bit levels agree on > 0.9999, bandpass within 1e-4
relative.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vlite_fast_tpu.config import PipelineConfig
from vlite_fast_tpu.models import baseband_dsp as jdsp
from vlite_fast_tpu.ops import channelize as jch
from vlite_fast_tpu.ops import megakernel as jmk
from vlite_fast_tpu.ops import normalize as jnorm
from vlite_fast_tpu.ops import quantize as jq
from vlite_fast_tpu.ops import unpack as junpack
from vlite_fast_tpu_torch import interop
from vlite_fast_tpu_torch.ops import channelize as tch
from vlite_fast_tpu_torch.ops import megakernel as tmk

torch.set_num_threads(1)

NFFT, FFTS, NSEG = 2048, 16, 3
SEG_SAMPS = NFFT * FFTS
N1, N2 = 32, 64
N2O = NFFT // 2 // N1 + 1
NCHAN = NFFT // 2 + 1


def _cfg(**kw):
    kw = dict(dict(chanmin=101, chanmax=612), **kw)
    return PipelineConfig(sample_rate=SEG_SAMPS * NSEG, seg_per_sec=NSEG,
                          nfft=NFFT, nkurto=256, nscrunch=8, rfi_mode=0,
                          ema_impl="scan", dft_exact_input=True, **kw)


def _raw(npol, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 256, size=(npol, SEG_SAMPS * NSEG), dtype=np.uint8)


def _unfold(planes, npol):
    """JAX stage A's factored (nseg, nb, 64, 128) planes -> the port's
    (nseg, npol * ffts, nchan)."""
    p = np.asarray(planes)[:, :, :N2O, :N1]
    return p.reshape(NSEG, npol * FFTS, -1)[:, :, :NCHAN]


def _rel(got, want, floor):
    got, want = np.asarray(got), np.asarray(want)
    return float((np.abs(got - want) / np.maximum(np.abs(want), floor)).max())


def _levels(packed):
    return np.asarray(jq.unpack_bits(jnp.asarray(np.asarray(packed)), 2))


def _agree(a, b):
    la, lb = _levels(a), _levels(b)
    assert la.shape == lb.shape
    return float((la == lb).mean())


def _stage_b_args(cfg, npol):
    return (NFFT, npol, NSEG, cfg.nscrunch, float(cfg.bp_scale),
            cfg.chanmin, cfg.chanmax)


@pytest.mark.parametrize("npol", [1, 2])
def test_stage_a_plain_matches_jax_kernel_and_oracle(npol):
    raw = _raw(npol)
    raw[0, :50] = 0                        # zero bytes convert to 0.0
    got = tmk.dft_detect_power(torch.from_numpy(raw), NFFT, npol, NSEG)
    assert tmk.LAUNCHES["dft_detect_power"] == 0      # CPU: the plain version
    assert got.shape == (NSEG, npol * FFTS, NCHAN)
    kern = _unfold(jmk.dft_detect_power(jnp.asarray(raw), NFFT, npol, NSEG),
                   npol)
    oracle = _unfold(jmk.dft_detect_oracle(raw, NFFT, npol, NSEG), npol)
    assert _rel(got, kern, 1e-3) < 2e-3
    assert _rel(got, oracle, 1e-3) < 2e-3
    assert torch.equal(got, tmk.dft_detect_oracle(torch.from_numpy(raw),
                                                  NFFT, npol, NSEG))


def test_stage_a_matches_f32_chain():
    """The split-plane power against the f32 channelizer's |X|^2."""
    raw = _raw(2)
    got = tmk.dft_detect_power(torch.from_numpy(raw), NFFT, 2, NSEG)
    x = junpack.convert_uint8(jnp.asarray(raw[:, :SEG_SAMPS]))
    spec = jch.channelize(x, NFFT, method="matmul", precision="high",
                          exact_bf16_input=True)
    want = np.asarray(jnorm.detect(spec)).reshape(2 * FFTS, -1)
    assert _rel(got[0], want, 1e-2) < 5e-3


@pytest.mark.parametrize("npol", [1, 2])
def test_stage_b_plain_matches_jax_over_two_calls(npol):
    """Two seconds with the bandpass carried.  The port's second call
    starts from the JAX bandpass of the first (interop.bp_from_factored);
    the port's own carry matches JAX's too."""
    cfg = _cfg()
    args = _stage_b_args(cfg, npol)
    raws = [_raw(npol, seed) for seed in (11, 12)]
    bpf = jmk.bp_to_factored(jnp.zeros((npol, NCHAN), jnp.float32), NFFT)
    bp_t = torch.zeros((npol, NCHAN))
    for sec, raw in enumerate(raws):
        planes, bpf_next = jmk.chain_second_plain(
            jnp.asarray(raw), bpf, NFFT, npol, NSEG, cfg.nscrunch,
            float(cfg.bp_scale))
        want = jmk.unfactor_pack_realign(planes, NFFT, cfg.chanmin,
                                         cfg.chanmax)
        start = torch.from_numpy(interop.bp_from_factored(bpf, NFFT, NCHAN))
        got, bp_from_jax = tmk.chain_second_plain(torch.from_numpy(raw),
                                                  start, *args)
        assert got.shape == tuple(want.shape) and got.dtype == torch.uint8
        assert _agree(got, want) > 0.9999
        got_own, bp_t = tmk.chain_second_plain(torch.from_numpy(raw), bp_t,
                                               *args)
        assert _agree(got_own, want) > 0.9999
        bp_j = interop.bp_from_factored(bpf_next, NFFT, NCHAN)
        assert _rel(bp_from_jax, bp_j, 1e-6) < 1e-4
        assert _rel(bp_t, bp_j, 1e-6) < 1e-4
        bpf = bpf_next
    assert tmk.LAUNCHES["chain_second_plain"] == 0


@pytest.mark.parametrize("chanmin,chanmax", [(101, 612), (100, 611)])
def test_stage_b_plain_matches_jax_xla_chain(chanmin, chanmax):
    """Stage B against the JAX package's XLA chain (process_segment, the
    sequential EMA), chanmin % 4 != 0 and == 0."""
    cfg = _cfg(chanmin=chanmin, chanmax=chanmax)
    raw = _raw(2)
    st = jdsp.init_state(cfg)
    outs = []
    for s in range(NSEG):
        seg = jnp.asarray(raw[:, s * SEG_SAMPS:(s + 1) * SEG_SAMPS])
        o, st = jdsp.process_segment(cfg, seg, st)
        outs.append(np.asarray(o.packed))
    got, bp = tmk.chain_second_plain(torch.from_numpy(raw),
                                     torch.zeros((2, NCHAN)),
                                     *_stage_b_args(cfg, 2))
    assert _agree(got, np.concatenate(outs)) > 0.9999
    assert _rel(bp, st.bp, 1e-6) < 1e-4


def test_bp_from_factored_inverts_jax_bp_to_factored():
    bp = np.random.default_rng(1).random((2, NCHAN), dtype=np.float32)
    back = interop.bp_from_factored(jmk.bp_to_factored(jnp.asarray(bp), NFFT),
                                    NFFT, NCHAN)
    assert np.array_equal(back, bp)
    assert np.array_equal(
        back, np.asarray(jmk.bp_from_factored(
            jmk.bp_to_factored(jnp.asarray(bp), NFFT), NFFT, NCHAN)))


@pytest.mark.parametrize("nfft", [2048, 12500])
def test_split_planes_match_jax_dft_planes(nfft):
    """The port's natural-shape split planes are the JAX package's padded
    DFTPlanes, unpadded: W1 transposed, the twiddle's first b-block, and
    the packed [w2r | w2i] columns apart."""
    n1, n2 = tch._ct_split(nfft)
    n2o = nfft // 2 // n1 + 1
    jp = jmk.dft_planes(nfft, 1)
    sp = tmk.split_planes(nfft, "cpu")
    for got, want in ((sp.w1r_hi, jp.w1r_hi), (sp.w1r_lo, jp.w1r_lo),
                      (sp.w1i_hi, jp.w1i_hi), (sp.w1i_lo, jp.w1i_lo)):
        assert np.array_equal(got.numpy(), want[:n1, :n1].T)
    assert np.array_equal(sp.twr.numpy(), jp.twr[:n2, :n1].T)
    assert np.array_equal(sp.twi.numpy(), jp.twi[:n2, :n1].T)
    for got, want in ((sp.w2r_hi, jp.w2c_hi[:n2, :n2o]),
                      (sp.w2r_lo, jp.w2c_lo[:n2, :n2o]),
                      (sp.w2i_hi, jp.w2c_hi[:n2, 64:64 + n2o]),
                      (sp.w2i_lo, jp.w2c_lo[:n2, 64:64 + n2o])):
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("nfft", [500, 2048, 12500])
def test_tc_planes_hold_the_split_planes_in_fragment_order(nfft):
    """Reading tc_planes' twiddle back through the accumulator layout of
    wgmma m64nNk16 (per warp of 16 rows k1 and n8 chunk of columns m2:
    rows g, g+8 and columns 2t, 2t+1, lane = 4 g + t) gives the split
    planes' twiddle, zero-padded to the warpgroups' 64-row tiles and the
    32-column passes; these fragments, twiddled and split, are stage 2's
    A operand in registers."""
    geo = tmk.tc_geometry(nfft)
    n1, n2 = tch._ct_split(nfft)
    _, tw, _ = tmk.tc_planes(nfft, "cpu")
    tw = tw.numpy()
    assert tw.shape == (2, 4 * geo.nwg, 4 * geo.npass, 32, 4)
    sp = tmk.split_planes(nfft, "cpu")
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    for p, plane in enumerate((sp.twr, sp.twi)):
        w = np.zeros((64 * geo.nwg, 32 * geo.npass), np.float32)
        for i in range(4 * geo.nwg):
            for j in range(4 * geo.npass):
                r, c, f = 16 * i + g, 8 * j + 2 * t, tw[p, i, j]
                w[r, c], w[r, c + 1] = f[:, 0], f[:, 1]
                w[r + 8, c], w[r + 8, c + 1] = f[:, 2], f[:, 3]
        want = np.zeros_like(w)
        want[:n1, :n2] = plane.numpy()
        assert np.array_equal(w, want)


@pytest.mark.parametrize("nfft", [500, 2048, 10000, 12500])
def test_tc_planes_hold_the_split_planes_in_core_matrices(nfft):
    """tc_planes' W1 and W2 read back as wgmma's no-swizzle K-major core
    matrices (element [group, block, row, e] is matrix entry [8 group +
    row, 8 block + e]; W1 as [k1, m1], W2 stored as [k2, m2]) are the
    split planes, zero-padded, and the shared memory the kernel needs
    fits the block at the test and production splits.  W2 holds every
    column m2 that stage 2's k-steps read (10000 = 100 x 100: n2 is not a
    multiple of 32)."""
    geo = tmk.tc_geometry(nfft)
    assert tmk.tc_fits(nfft) and geo.smem <= tmk.TC_SMEM_MAX
    assert 8 * geo.kb2 == 32 * geo.npass
    n1, n2 = tch._ct_split(nfft)
    n2o = nfft // 2 // n1 + 1
    w1, _, w2 = (t.float().numpy() for t in tmk.tc_planes(nfft, "cpu"))
    assert w1.shape == (4, geo.rg1, geo.kb1, 8, 8)
    assert w2.shape == (4, 8, geo.kb2, 8, 8)
    sp = tmk.split_planes(nfft, "cpu")
    unfold = lambda c: c.transpose(0, 2, 1, 3).reshape(
        8 * c.shape[0], 8 * c.shape[1])
    for p, plane in enumerate((sp.w1r_hi, sp.w1r_lo, sp.w1i_hi, sp.w1i_lo)):
        want = np.zeros((8 * geo.rg1, 8 * geo.kb1), np.float32)
        want[:n1, :n1] = plane.numpy()
        assert np.array_equal(unfold(w1[p]), want)
    for p, plane in enumerate((sp.w2r_hi, sp.w2r_lo, sp.w2i_hi, sp.w2i_lo)):
        want = np.zeros((64, 8 * geo.kb2), np.float32)
        want[:n2o, :n2] = plane.numpy().T
        assert np.array_equal(unfold(w2[p]), want)


@pytest.mark.parametrize("ct", [1, 2])
@pytest.mark.parametrize("nfft", [500, 2048, 10000, 12500, 15376])
def test_tc_geometry_ct_ring_holds_a_pass_of_lead(nfft, ct):
    """The ring of the CT-major tiles' loader (dft_tc.cuh's make_geom with
    `ct` bytes an element): slots of 32 tile rows (n2 where n2 < 32),
    128-byte multiples so every bulk copy stays 16-byte aligned, at least
    npass + 1 of them (one pass of lead, or the consumers would wait on a
    slice never fetched), beside the same planes and frame tile as the raw
    second's loader, within a block's shared memory; tc_fits holds for
    the split (15376 = 124 x 124 runs two blocks per frame)."""
    nat, geo = tmk.tc_geometry(nfft), tmk.tc_geometry(nfft, ct)
    n1, n2 = tch._ct_split(nfft)
    assert tmk.tc_fits(nfft) and geo.smem <= tmk.TC_SMEM_MAX
    slot = min(32, n2) * tmk.LANE * ct
    assert geo.npass < geo.nslot <= tmk.TC_CT_SLOTS
    # the ring (then its barriers) follows the raw second's planes and
    # frame tile
    ring = geo.smem - geo.nslot * (slot + 8)
    assert ring == nat.smem - nat.nslot * (-(-nfft // 16) * 16 + 16 + 8)
    assert ring % 128 == 0 and slot % 128 == 0
    assert geo[:8] == nat[:8] and geo.split == nat.split == (nfft == 15376)


def test_staged_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a card is refused: the
    wrappers launch the kernel or raise, and never fall back."""
    raw = torch.zeros((2, SEG_SAMPS * NSEG), dtype=torch.uint8,
                      device="meta")
    with pytest.raises(ValueError, match="device"):
        tmk.dft_detect_power(raw, NFFT, 2, NSEG)
    with pytest.raises(ValueError, match="device"):
        tmk.chain_second_plain(raw, torch.zeros((2, NCHAN), device="meta"),
                               *_stage_b_args(_cfg(), 2))
