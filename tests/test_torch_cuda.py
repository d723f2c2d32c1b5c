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
same f32 terms summed in another order); the EMA kernels allclose(rtol=
2e-6, atol=2e-6) (the JAX package's bar for its Pallas EMAs; kernel and
plain version sum in the same order); the RFI front kernel equal masked
voltages, weights and flags, TS within 1e-5 absolute (cbrtf against a
float64 cube root, then the cancellation Z22 - cbrt t); the
pretranspose kernel byte-equal (u8) and value-equal (bf16) to its plain
version; chain_second's three modes byte-identical to each other and to
chain_second_v2 (one loader-agnostic sum order).
"""

import numpy as np
import pytest
import torch

from vlite_fast_tpu.config import PipelineConfig, SearchConfig
from vlite_fast_tpu_torch.models import baseband_dsp as tdsp
from vlite_fast_tpu_torch.models import search as tsearch
from vlite_fast_tpu_torch.ops import dedisperse as tdd
from vlite_fast_tpu_torch.ops import dedisperse_pallas as tddp
from vlite_fast_tpu_torch.ops import megakernel as tmk
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


@pytest.mark.parametrize("npol", [1, 2])
@pytest.mark.parametrize("rfi_mode", [0, 1, 2])
def test_chain_second_kernel_matches_plain(cuda, rfi_mode, npol):
    """Kernel B in its three pretranspose modes: byte-identical to each
    other and to the v2 kernel, and at the chain bar against plain, over
    two seconds with the bandpass carried."""
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
        for got in outs:
            for g, r in zip(got, v2):
                assert torch.equal(g, r)
        got = outs[0]
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


def test_chain_second_v4_chunks_agree(cuda, monkeypatch):
    """The intermediate walked in chunks of one segment gives the whole
    second's result."""
    cfg = _mk_cfg(rfi_mode=2)
    raw = torch.from_numpy(_noise(cfg.sample_rate, seed=4,
                                  burst_at=40000)).to(cuda)
    bp = torch.zeros((2, 2, cfg.nchan), device=cuda)
    whole = tmk.chain_second_v4(raw, bp, cfg)
    monkeypatch.setattr(tmk, "V4_CHUNK_BYTES", 1)
    chunked = tmk.chain_second_v4(raw, bp, cfg)
    torch.cuda.synchronize()
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


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
        chain_second_v2=before["chain_second_v2"],
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


@pytest.mark.parametrize("dag_fb_thresh", [0.0, 5.0])
@pytest.mark.parametrize("npol", [1, 2])
def test_rfi_front_kernel_matches_plain(cuda, npol, dag_fb_thresh):
    cfg = PipelineConfig.tiny()             # nkurto 50, nfft 500
    raw = torch.from_numpy(np.ascontiguousarray(
        _noise(200_000, seed=3, burst_at=40000)[:npol])).to(cuda)
    got = trfi.rfi_front(raw, cfg.nkurto, cfg.nfft, cfg.dag_thresh,
                         dag_fb_thresh)
    want = trfi.rfi_front_plain(raw, cfg.nkurto, cfg.nfft, cfg.dag_thresh,
                                dag_fb_thresh)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[2] >= cfg.dag_thresh, want[2] >= cfg.dag_thresh)
    np.testing.assert_allclose(got[2].cpu().numpy(), want[2].cpu().numpy(),
                               rtol=0, atol=1e-5)
    assert float(got[1].min()) < 1.0        # the gates fired


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


@pytest.mark.parametrize("time_tile", [0, 16])
def test_ema_kernel_matches_plain(cuda, time_tile):
    p, bp, _ = _ema_inputs(4, cuda)
    got = tpk.normalize_ema_pallas(p, bp, 0.02, time_tile=time_tile)
    want = tdsp.norm_ops.normalize_ema(p, bp, 0.02, time_tile)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=2e-6, atol=2e-6)


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
