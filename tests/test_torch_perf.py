"""The port's cost models (vlite_fast_tpu_torch/utils/perf.py) against the
JAX package's (vlite_fast_tpu/utils/perf.py), on the CPU.

Bars: counts are integers of the geometry, so equal means equal.  The
nominal DFT products and the chain's device-memory bytes equal the JAX
module's; the fold kernel's adds are no more than the Pallas kernel's,
which pads time to 128 lanes (the gap is 0.042% of the Pallas count on
the tolerance grid's production gulp, 0.161% on the linear grid's); the
twin's tensor-core products and the chain's bound equal the formulas
chip_smoke.py held before they moved here, pinned at the production
geometry.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from vlite_fast_tpu.config import PipelineConfig as JPipelineConfig
from vlite_fast_tpu.config import SearchConfig as JSearchConfig
from vlite_fast_tpu.models import search as jsearch
from vlite_fast_tpu.ops import dedisperse as jdd
from vlite_fast_tpu.utils import perf as jperf
from vlite_fast_tpu_torch import config as tconfig
from vlite_fast_tpu_torch.ops import channelize as tch
from vlite_fast_tpu_torch.ops import dedisperse as tdd
from vlite_fast_tpu_torch.ops import megakernel as tmk
from vlite_fast_tpu_torch.utils import perf

torch.set_num_threads(1)

CONFIGS = {"production": {}, "armed": {"inject_frb": True},
           "rfi_mode 0": {"rfi_mode": 0}, "8-bit": {"nbit": 8}}


def _t(cfg):
    """The port's config of the same class and fields as a JAX package one."""
    return getattr(tconfig, type(cfg).__name__)(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("kw", list(CONFIGS.values()), ids=list(CONFIGS))
def test_nominal_dft_and_chain_bytes_equal_jax(kw):
    cfg = JPipelineConfig(**kw)
    got = perf.dft_flops_per_data_second(_t(cfg))
    assert got["nominal_flops"] == \
        jperf.dft_flops_per_data_second(cfg)["nominal_flops"]
    assert perf.chain_hbm_bytes_per_data_second(_t(cfg)) == \
        jperf.chain_hbm_bytes_per_data_second(cfg)


# (tolerance-grid trials, adds of the fold kernel, of the Pallas kernel)
PRODUCTION_GULPS = {"tol": (4864, 23_780_130_816, 23_790_092_288),
                    "linear": (1024, 15_946_219_520, 15_971_909_632)}


@pytest.mark.parametrize("mode", list(PRODUCTION_GULPS))
def test_fold_adds_within_the_pallas_cost(mode):
    """The production gulp of each grid, on the pipeline's plan geometry
    (nsub 128, nbatch 128): the fold kernel's adds below the Pallas
    kernel's by the 128-lane padding alone."""
    cfg = JPipelineConfig()
    scfg = JSearchConfig(dm_grid_mode=mode)
    freqs = cfg.freqs_mhz()
    dms = jsearch.make_dm_grid(scfg, cfg.tsamp, freqs)
    jplan = jdd.make_plan(dms, freqs, cfg.tsamp, nsub=128, nbatch=128,
                          zap_ranges=scfg.zap_ranges)
    tplan = tdd.make_plan(dms, freqs, cfg.tsamp, nsub=128, nbatch=128,
                          zap_ranges=scfg.zap_ranges, device="cpu")
    ntime_out = scfg.gulp_samps
    got = perf.dedisp_fold_cost(tplan, cfg.nchanout, ntime_out)
    want = jperf.dedisp_pallas_cost(jplan, cfg.nchanout, ntime_out)
    trials, adds, pallas_adds = PRODUCTION_GULPS[mode]
    assert len(dms) == trials
    assert (got["adds"], want["adds"]) == (adds, pallas_adds)
    assert got["adds"] <= want["adds"]
    assert 0 < 1 - got["adds"] / want["adds"] < 2e-3
    assert got["sol_hbm_s"] == got["hbm_bytes"] / perf.HBM_BYTES_PER_S


def _former_tc_dft_ops(cfg, frames):
    """chip_smoke.py's tc_dft_ops before it moved to utils/perf."""
    g = tmk.tc_geometry(cfg.nfft)
    rows, cols = 64 * g.nwg, 32 * g.npass
    return frames * 2 * (4 * rows * cols * 8 * g.kb1 + 12 * rows * 64 * cols)


def test_twin_dft_count_pinned_at_production():
    cfg = tconfig.PipelineConfig()
    frames = cfg.npol_in * cfg.seg_per_sec * cfg.ffts_per_seg
    got = perf.dft_flops_per_data_second(cfg)["twin_bf16_flops"]
    assert got == _former_tc_dft_ops(cfg, frames) == 816_043_786_240
    assert perf.tc_dft_ops(cfg, frames) == got


def test_armed_gemm_count_is_what_torch_counts():
    """armed_f32_flops is the products ops/channelize.matmul_rfft issues:
    torch's own FlopCounterMode counts the same on one second of each
    stream (rfi_mode 0: one stream; 2: two)."""
    for rfi_mode, nstreams in ((0, 1), (2, 2)):
        cfg = tconfig.PipelineConfig.tiny(rfi_mode=rfi_mode)
        x = torch.zeros((cfg.npol_in, cfg.sample_rate))
        per_stream = perf.torch_cost(tch.channelize, x, cfg.nfft, "matmul")
        assert perf.dft_flops_per_data_second(cfg)["armed_f32_flops"] == \
            nstreams * per_stream["flops"]


def _former_chain_bound(cfg, raw, outs):
    """chip_smoke.py's chain_bound (with its bound()) before the move."""
    frames = cfg.npol_in * cfg.seg_per_sec * cfg.ffts_per_seg
    nstreams = 2 if cfg.rfi_mode == 2 else 1
    masked = int((outs[2] < 1).sum()) if cfg.rfi_mode == 2 else 0
    ops = (frames + masked) * 2.5 * cfg.nfft * math.log2(cfg.nfft) \
        + nstreams * frames * 8 * cfg.nchan
    moved = sum(t.numel() * t.element_size() for t in (raw, *outs))
    t_bytes = moved / 3.35e12 * 1e3
    t_ops = ops / 67e12 * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


@pytest.mark.parametrize("masked", [0, 3214, 20480])
def test_chain_bound_pinned_at_the_production_second(masked):
    """[2]'s second: the raw second and chain_second_v2's outputs at their
    production shapes (meta tensors), `masked` frames with weight < 1."""
    cfg = tconfig.PipelineConfig()
    rows = cfg.seg_per_sec * cfg.out_samps_per_seg
    row_bytes = cfg.npol_out * cfg.nchanout * cfg.nbit // 8
    nspec = cfg.seg_per_sec * cfg.ffts_per_seg
    meta = dict(device="meta")
    raw = torch.empty((cfg.npol_in, cfg.sample_rate), dtype=torch.uint8,
                      **meta)
    weights = torch.ones(cfg.npol_in * nspec)
    weights[:masked] = 0.5
    outs = (torch.empty((rows, row_bytes), dtype=torch.uint8, **meta),
            torch.empty((rows, row_bytes), dtype=torch.uint8, **meta),
            weights.reshape(cfg.npol_in, nspec),
            torch.empty((cfg.seg_per_sec,), **meta),
            torch.empty((2, cfg.npol_in, cfg.nchan), **meta))
    assert perf.chain_bound(cfg, masked) == _former_chain_bound(cfg, raw,
                                                                outs)
    assert perf.chain_bytes(cfg) == 258_804_656
    if masked == 3214:   # PERF.md §6's row #1 bound
        assert round(perf.chain_bound(cfg, masked)["bound_ms"], 3) == 0.181


@pytest.mark.parametrize("rfi_mode", [0, 2])
def test_chain_bytes_equal_the_chains_tensors(rfi_mode):
    """chain_bytes counts the second and the outputs the chain returns
    (chain_second_v2's plain version, tiny geometry)."""
    cfg = tconfig.PipelineConfig.tiny(nbit=2, rfi_mode=rfi_mode)
    raw = torch.from_numpy(np.random.default_rng(3).integers(
        1, 256, (cfg.npol_in, cfg.sample_rate), dtype=np.uint8))
    outs = tmk.chain_second_v2_plain(
        raw, torch.zeros((2, cfg.npol_in, cfg.nchan)), cfg)
    assert perf.chain_bytes(cfg) == sum(
        t.numel() * t.element_size() for t in (raw, *outs))


def test_torch_cost_returns_a_dict():
    a, b = torch.ones((3, 5)), torch.ones((5, 7))
    assert perf.torch_cost(torch.matmul, a, b) == {"flops": 2 * 3 * 5 * 7}
    assert perf.torch_cost(torch.add, a, a) == {}


def test_bound_names_what_bounds_it():
    assert perf.bound(3.35e9, 0) == {"bound_ms": 1.0, "bound_by": "bytes"}
    assert perf.bound(0, 989e9, "bf16") == {"bound_ms": 1.0,
                                            "bound_by": "operations"}
