"""The port's DSP chain against the JAX package's, on the CPU.

Bars (the JAX package's own for its chain variants,
tests/test_megakernel.py): >= 0.9999 of output levels agree and none
differs by more than one level (f32 DFTs summed in different orders move
a few samples across a quantizer edge); weights bit-equal; dag_frac
within 1e-6; carried bandpass within 1e-4 relative.  The JAX chain runs
with ema_impl='scan', the sequential EMA the port implements, and with
its one-pass program (ema_impl='pallas', rfi_impl='pallas'), which the
port's armed program mirrors.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vlite_fast_tpu.config import PipelineConfig
from vlite_fast_tpu.models import baseband_dsp as jdsp
from vlite_fast_tpu.ops import megakernel as jmk
from vlite_fast_tpu.ops import quantize as jq
from vlite_fast_tpu_torch import interop
from vlite_fast_tpu_torch.models import baseband_dsp as tdsp
from vlite_fast_tpu_torch.ops import megakernel as tmk

torch.set_num_threads(1)


def _noise(nsamp, seed, burst_at=None):
    """Gaussian 8-bit voltages (the numpy form of
    models/synthesis.white_noise_uint8) with an optional sinusoidal burst
    in pol 0, so the kurtosis gates fire."""
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


def _levels(packed, nbit):
    return np.asarray(jq.unpack_bits(jnp.asarray(np.asarray(packed)),
                                     nbit)).astype(np.int16)


def _assert_levels(a, b, nbit):
    la, lb = _levels(a, nbit), _levels(b, nbit)
    assert la.shape == lb.shape
    assert (la == lb).mean() >= 0.9999, (la == lb).mean()
    assert np.abs(la - lb).max() <= 1


def _assert_bp(got, want):
    got, want = np.asarray(got), np.asarray(want)
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-6)
    assert rel.max() < 1e-4, rel.max()


def _jax_state(st):
    return interop.state_from_jax(np.asarray(st.bp), np.asarray(st.bp_kur),
                                  np.asarray(st.segs_since_inject),
                                  np.asarray(st.tail), np.asarray(st.wtail))


def _assert_second_matches_jax(cfg, nbit, arm, port_second):
    raw0 = _noise(cfg.sample_rate, seed=1)
    raw1 = _noise(cfg.sample_rate, seed=2, burst_at=40000)
    # one clean second seeds the bandpass in JAX; both packages continue
    # from that state (through interop)
    _, st_j = jdsp.process_second(cfg, jnp.asarray(raw0),
                                  jdsp.init_state(cfg), jnp.asarray(False))
    st_t = _jax_state(st_j)
    oj, sj = jdsp.process_second(cfg, jnp.asarray(raw1), st_j,
                                 jnp.asarray(arm))
    ot, stt = port_second(cfg, torch.from_numpy(raw1), st_t, arm)
    for field in ("packed", "packed_kur"):
        _assert_levels(getattr(ot, field), getattr(oj, field), nbit)
    assert np.array_equal(ot.weights.numpy(), np.asarray(oj.weights))
    assert abs(float(ot.dag_frac) - float(oj.dag_frac)) < 1e-6
    if cfg.rfi_mode:
        assert float(ot.dag_frac) > 0          # the burst was flagged
    _assert_bp(stt.bp, sj.bp)
    _assert_bp(stt.bp_kur, sj.bp_kur)
    assert stt.segs_since_inject == int(sj.segs_since_inject)


def _armed_cfg(rfi_mode, nbit, **kw):
    return PipelineConfig.tiny(rfi_mode=rfi_mode, nbit=nbit, inject_frb=True,
                               inject_dm=30.0, inject_amp=1.5, **kw)


@pytest.mark.parametrize("arm", [False, True])
@pytest.mark.parametrize("nbit", [2, 8])
@pytest.mark.parametrize("rfi_mode", [0, 1, 2])
def test_process_second_matches_jax(rfi_mode, nbit, arm):
    """The armed program against the JAX sequential ('scan') chain."""
    _assert_second_matches_jax(_armed_cfg(rfi_mode, nbit, ema_impl="scan"),
                               nbit, arm, tdsp.process_second)


@pytest.mark.parametrize("arm", [False, True])
@pytest.mark.parametrize("rfi_mode", [0, 1, 2])
def test_process_second_matches_jax_pallas_program(rfi_mode, arm):
    """The armed program against the JAX package's one-pass program
    (ema_impl='pallas', rfi_impl='pallas': the Pallas RFI front per
    segment, each Pallas EMA once per second), kernels in interpret
    mode."""
    cfg = _armed_cfg(rfi_mode, 2, ema_impl="pallas", rfi_impl="pallas")
    _assert_second_matches_jax(cfg, 2, arm, tdsp.process_second)


@pytest.mark.parametrize("arm", [False, True])
@pytest.mark.parametrize("rfi_mode", [0, 2])
def test_process_second_plain_matches_jax(rfi_mode, arm):
    """The segment-by-segment torch composition (the kernel path's
    oracle on the card) against the JAX sequential chain."""
    _assert_second_matches_jax(_armed_cfg(rfi_mode, 2, ema_impl="scan"),
                               2, arm, tdsp.process_second_plain)


def test_twin_program_dispatch(tmp_path):
    """The twin is the chain kernel only where megakernel_supported
    takes the configuration (the JAX package's resolve_twin_impl)."""
    from vlite_fast_tpu.config import SearchConfig
    from vlite_fast_tpu_torch.runtime.pipeline import StationPipeline
    assert tdsp.twin_program(PipelineConfig()) is tdsp.twin_second
    assert tdsp.twin_program(PipelineConfig(inject_frb=True)) is \
        tdsp.twin_second
    assert tdsp.twin_program(PipelineConfig.tiny()) is tdsp.process_second
    pipe = StationPipeline(1, PipelineConfig.tiny(inject_frb=True),
                           SearchConfig.tiny(), out_dir=str(tmp_path))
    assert pipe._twin is tdsp.process_second
    pipe = StationPipeline(1, PipelineConfig.tiny(nbit=2),
                           SearchConfig.tiny(), out_dir=str(tmp_path))
    assert pipe._twin is tdsp.twin_second


# tests/test_megakernel.py geometry: nfft 2048 (CT 32x64), 16 FFTs per
# segment, 3 segments, nkurto 256, chanmin % 4 != 0
def _mk_cfg(**kw):
    return PipelineConfig(sample_rate=2048 * 16 * 3, seg_per_sec=3,
                          nfft=2048, nkurto=256, chanmin=101, chanmax=612,
                          nscrunch=8, rfi_mode=2, ema_impl="scan",
                          rfi_impl="xla", front_layout="flat",
                          dft_exact_input=True, **kw)


def test_kernel1_plain_matches_jax_chain_second_v2():
    """The plain version of the chain kernel against the TPU kernel in
    interpret mode (its factored outputs refolded by the JAX package's own
    helpers)."""
    cfg = _mk_cfg()
    assert tdsp.megakernel_supported(cfg)
    raw = _noise(cfg.sample_rate, seed=5, burst_at=40000)
    bp0 = jmk.bp_to_factored_v2(jnp.zeros((4, cfg.nchan), jnp.float32),
                                cfg.nfft)
    pp, kk, w, dag, bp_new = jmk.chain_second_v2(
        jnp.asarray(raw), bp0, cfg.nfft, 2, cfg.seg_per_sec, cfg.nscrunch,
        cfg.nkurto, 2, float(cfg.bp_scale), float(cfg.dag_thresh),
        float(cfg.dag_fb_thresh))
    packed, packed_kur, weights, dag_t, bp_t = tmk.chain_second_v2(
        torch.from_numpy(raw), torch.zeros((2, 2, cfg.nchan)), cfg)
    assert tmk.LAUNCHES["chain_second_v2"] == 0   # CPU: the plain version
    _assert_levels(packed, jmk.unfactor_pack_realign_v2(
        pp, cfg.nfft, cfg.chanmin, cfg.chanmax), 2)
    _assert_levels(packed_kur, jmk.unfactor_pack_realign_v2(
        kk, cfg.nfft, cfg.chanmin, cfg.chanmax), 2)
    w = np.asarray(w)[:, :, 0]
    want_w = np.concatenate([w[s].reshape(2, cfg.ffts_per_seg)
                             for s in range(cfg.seg_per_sec)], axis=1)
    assert np.array_equal(weights.numpy(), want_w)
    assert want_w.mean() < 1.0                # the gates fired
    np.testing.assert_allclose(dag_t.numpy(), np.asarray(dag)[:, 0],
                               atol=1e-6)
    bpj = np.asarray(bp_new)
    _assert_bp(bp_t[0], jmk.bp_from_factored_v2(bpj[:2], cfg.nfft,
                                                cfg.nchan))
    _assert_bp(bp_t[1], jmk.bp_from_factored_v2(bpj[2:], cfg.nfft,
                                                cfg.nchan))


def test_state_carry_two_seconds():
    """state_from_jax starts the port mid-observation: second 2 from the
    JAX state after second 1 matches JAX's second 2; the port's own carry
    over both seconds matches too."""
    cfg = _mk_cfg()
    raws = [_noise(cfg.sample_rate, seed=s) for s in (21, 22)]
    st_j = jdsp.init_state(cfg)
    outs_j = []
    for r in raws:
        o, st_j_next = jdsp.process_second(cfg, jnp.asarray(r), st_j,
                                           jnp.asarray(False))
        outs_j.append((o, st_j, st_j_next))
        st_j = st_j_next
    # from JAX's state after second 1
    _, st1, st2 = outs_j[1]
    ot, stt = tdsp.twin_second(cfg, torch.from_numpy(raws[1]),
                               _jax_state(st1))
    _assert_levels(ot.packed_kur, outs_j[1][0].packed_kur, 2)
    _assert_bp(stt.bp_kur, st2.bp_kur)
    # the port carrying its own state across both seconds
    st_t = tdsp.init_state(cfg)
    for r in raws:
        ot, st_t = tdsp.twin_second(cfg, torch.from_numpy(r), st_t)
    _assert_levels(ot.packed, outs_j[1][0].packed, 2)
    _assert_bp(st_t.bp, st2.bp)
    _assert_bp(st_t.bp_kur, st2.bp_kur)
    back = interop.state_to_numpy(st_t)
    assert back["bp"].shape == np.asarray(st2.bp).shape


def test_twin_rejects_unsupported_on_cuda_only():
    """megakernel_supported is the JAX package's gate and
    chain_kernel_takes the CUDA kernels' own; the armed config is
    supported by neither, the twin by both."""
    cfg = PipelineConfig(inject_frb=True)
    assert not tdsp.megakernel_supported(cfg)
    assert not tdsp.chain_kernel_takes(cfg)
    cfg0 = dataclasses.replace(cfg, inject_frb=False)
    assert tdsp.megakernel_supported(cfg0)
    assert tdsp.chain_kernel_takes(cfg0)
    assert tdsp.chain_kernel_takes(cfg0, "ct")
    assert not tdsp.megakernel_supported(PipelineConfig.tiny())   # 8-bit
    assert not tdsp.chain_kernel_takes(PipelineConfig.tiny())
    assert tdsp.inject_window_seconds(cfg) == \
        jdsp.inject_window_seconds(cfg)
