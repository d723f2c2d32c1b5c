"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked `cuda` and skips without an NVIDIA GPU (a CUDA
kernel has no interpret mode).  This file imports no jax, so it runs on
a machine without it; tests/conftest.py imports jax, so run it there as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Bars: the chain kernel to the chain bar of tests/test_torch_chain.py
(>= 0.9999 of 2-bit levels, none off by more than one, weights equal,
dag_frac within 1e-6, bandpass within 1e-4 relative); the dedispersion
kernel allclose(rtol=1e-5, atol=1e-4) (the same f32 terms summed in
another order).
"""

import numpy as np
import pytest
import torch

from vlite_fast_tpu.config import PipelineConfig, SearchConfig
from vlite_fast_tpu_torch.models import search as tsearch
from vlite_fast_tpu_torch.ops import dedisperse as tdd
from vlite_fast_tpu_torch.ops import dedisperse_pallas as tddp
from vlite_fast_tpu_torch.ops import megakernel as tmk
from vlite_fast_tpu_torch.ops import quantize as tq

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
    before = tmk.LAUNCHES
    tmk.chain_second_v2(raw, torch.zeros((2, 2, cfg.nchan), device=cuda),
                        cfg)
    tmk.chain_second_v2_plain(raw, torch.zeros((2, 2, cfg.nchan),
                                               device=cuda), cfg)
    assert tmk.LAUNCHES == before + 1
