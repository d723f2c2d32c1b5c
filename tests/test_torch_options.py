"""The station options the port runs beside its main path, against the
JAX package on the CPU: DOHISTO histograms from every program and as an
observation product, the twin's resolution with do_histo (the port used
to refuse the chain kernel for it), run_observation's profile trace, the
WOLA carry through the observation's state reset, and the config matrix
of benchmarks/smoke_config_matrix_tpu.py.
"""

import ast
import dataclasses
import glob
import itertools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlite_fast_tpu.config import PipelineConfig, SearchConfig
from vlite_fast_tpu.models import baseband_dsp as jdsp
from vlite_fast_tpu.ops import kurtosis as jkur
from vlite_fast_tpu.ops import quantize as jq
from vlite_fast_tpu.runtime.control import ObservationDocument as JDoc
from vlite_fast_tpu.runtime.pipeline import StationPipeline as JPipe
from vlite_fast_tpu_torch import config as tconfig
from vlite_fast_tpu_torch.models import baseband_dsp as tdsp
from vlite_fast_tpu_torch.ops import kurtosis as tkur
from vlite_fast_tpu_torch.runtime.pipeline import PROFILE_RANGES
from vlite_fast_tpu_torch.runtime.pipeline import ObservationDocument as TDoc
from vlite_fast_tpu_torch.runtime.pipeline import StationPipeline as TPipe

torch.set_num_threads(1)

MK = ("megakernel", "megakernel2", "megakernel3", "megakernel3f",
      "megakernel4")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(cfg):
    """The port's config of the same class and fields as a JAX package one."""
    return getattr(tconfig, type(cfg).__name__)(**dataclasses.asdict(cfg))


def _noise(nsamp, seed, bursts=()):
    rng = np.random.default_rng(seed)
    raw = np.clip(rng.standard_normal((2, nsamp)) / 0.05914 + 128.5, 0,
                  255).astype(np.int16)
    t = np.arange(3000)
    for at in bursts:
        raw[0, at:at + 3000] += (60 * np.sin(0.3 * t)).astype(np.int16)
    return np.clip(raw, 0, 255).astype(np.uint8)


def test_sample_histogram_matches_jax():
    rng = np.random.default_rng(8)
    u = rng.integers(0, 256, (2, 100_000), dtype=np.uint8)
    u[1, :5000] = 255                       # a saturated run
    got = tkur.sample_histogram(torch.from_numpy(u))
    want = np.asarray(jkur.sample_histogram(jnp.asarray(u)))
    assert got.dtype == torch.int32 and got.shape == (2, 256)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("chain_impl,twin_impl",
                         [("xla", "same"), ("xla", "auto")]
                         + [(m, "auto") for m in MK])
def test_every_program_returns_the_histogram(chain_impl, twin_impl):
    """process_second, process_second_plain and the twin the pipeline
    resolves (the armed program with injection off for 'same', else a
    chain kernel's plain version here) each return the second's
    histogram with do_histo, and an (npol, 0) int32 without."""
    raw = _noise(PipelineConfig.tiny().sample_rate, 3, bursts=(40_000,))
    want = np.asarray(jkur.sample_histogram(jnp.asarray(raw)))
    for do_histo in (True, False):
        cfg = _t(PipelineConfig.tiny(nbit=2, do_histo=do_histo,
                                     chain_impl=chain_impl,
                                     twin_chain_impl=twin_impl))
        _, twin, tcfg = tdsp.second_program(cfg, -1)
        assert (twin is tdsp.twin_second) == (twin_impl == "auto")
        for name, prog, c in (
                ("process_second", tdsp.process_second, cfg),
                ("process_second_plain", tdsp.process_second_plain, cfg),
                ("twin", twin, tcfg)):
            out, _ = prog(c, torch.from_numpy(raw),
                          tdsp.init_state(c, "cpu"), False)
            assert out.histo.dtype == torch.int32, name
            if do_histo:
                assert np.array_equal(out.histo.numpy(), want), name
            else:
                assert tuple(out.histo.shape) == (2, 0), name


def _jax_verdict(cfg):
    """The chain_impl the JAX pipeline runs outside the armed window, or
    'raise' (tests/test_torch_twin_impl.py)."""
    if cfg.inject_frb and cfg.chain_impl in MK:
        return "raise"
    impl = jdsp.resolve_twin_impl(cfg) if cfg.inject_frb else cfg.chain_impl
    if impl in MK and not jdsp.megakernel_supported(dataclasses.replace(
            cfg, inject_frb=False, chain_impl=impl)):
        return "raise"
    return impl


def test_do_histo_resolves_the_twin_as_jax():
    """With do_histo the twin resolves as without it, as in the JAX
    package, whose gate never reads do_histo: the v2 kernel stays the
    'auto' twin (the port used to fall back to the torch chain)."""
    grid = itertools.product(
        (False, True), (2, 8), (1, 2), (20, 50, 250),
        ("xla", "megakernel", "megakernel2", "megakernel4"),
        ("auto", "same", "xla") + MK)
    seen = set()
    for inject, nbit, npol_out, nkurto, chain_impl, twin in grid:
        kw = dict(inject_frb=inject, nbit=nbit, npol_out=npol_out,
                  nkurto=nkurto, chain_impl=chain_impl, twin_chain_impl=twin)
        cfg = PipelineConfig.tiny(do_histo=True, **kw)
        want = _jax_verdict(cfg)
        assert want == _jax_verdict(PipelineConfig.tiny(**kw))
        verdicts = []
        for c in (_t(cfg), _t(PipelineConfig.tiny(**kw))):
            try:
                verdicts.append(tdsp.resolve_twin_impl(c))
            except ValueError:
                verdicts.append("raise")
        got = verdicts[0]
        assert got == verdicts[1], (kw, verdicts)
        seen.add((want, got))
        if not (twin == "auto" and want == "xla" and got == "megakernel2"):
            assert got == want, (kw, got, want)
    assert ("xla", "megakernel2") in seen
    cfg = _t(PipelineConfig(do_histo=True))
    assert tdsp.chain_kernel_takes(cfg)
    assert tdsp.second_program(cfg, -1)[1] is tdsp.twin_second


def test_histogram_product_matches_jax(tmp_path):
    """tests/test_diagnostics.py's observation in both packages: the
    _histo.npz histograms are equal, every sample binned."""
    cfg = PipelineConfig.tiny(do_histo=True, rfi_mode=0)
    scfg = SearchConfig.tiny()
    rng = np.random.default_rng(2)
    raw = np.clip(rng.standard_normal((2, cfg.sample_rate)) / 0.05914
                  + 128.5, 0, 255).astype(np.uint8)
    raw2 = _noise(cfg.sample_rate, 9)
    hists = []
    for pipe_cls, doc in ((JPipe, JDoc), (TPipe, TDoc)):
        out = tmp_path / pipe_cls.__module__
        kw = dict(out_dir=str(out), keep_ring=False)
        pipe = JPipe(1, cfg, scfg, **kw) if pipe_cls is JPipe else \
            TPipe(1, _t(cfg), _t(scfg), device="cpu", **kw)
        pipe.begin_observation(doc(name="H", start_time=1.6e9),
                               search_live=False)
        for s, buf in enumerate((raw, raw2)):
            pipe.feed_second(1.6e9 + s, buf)
        pipe.end_observation()
        pipe.close()
        files = glob.glob(str(out / "*_histo.npz"))
        assert len(files) == 1
        hists.append(np.load(files[0])["histogram"])
    hj, ht = hists
    assert ht.shape == hj.shape == (2, 256)
    assert np.array_equal(ht, hj)
    assert ht.sum() == 2 * 2 * cfg.sample_rate
    want = np.stack([np.bincount(raw[p], minlength=256)
                     + np.bincount(raw2[p], minlength=256) for p in (0, 1)])
    assert np.array_equal(ht, want)


def test_profile_trace_holds_the_ranges(tmp_path):
    cfg = _t(PipelineConfig.tiny(nbit=2, inject_frb=True))
    pipe = TPipe(1, cfg, _t(SearchConfig.tiny()), out_dir=str(tmp_path),
                 keep_ring=False, write_cands=False, device="cpu")
    secs = [(1.6e9 + s, _noise(cfg.sample_rate, 30 + s)) for s in range(4)]
    prod = pipe.run_observation(iter(secs), TDoc(name="P", start_time=1.6e9),
                                profile_dir=str(tmp_path / "prof"))
    assert prod.seconds == 4
    assert os.path.dirname(pipe.profile_path) == str(tmp_path / "prof")
    with open(pipe.profile_path) as fp:
        names = {e.get("name") for e in json.load(fp)["traceEvents"]}
    assert set(PROFILE_RANGES) <= names, set(PROFILE_RANGES) - names
    assert pipe.metrics.get("vfast_gulps_searched") >= 1
    # the profiled observation computed what an unprofiled one does
    again = pipe.run_observation(iter(secs),
                                 TDoc(name="P", start_time=1.6e9))
    assert [tuple(c) for c in again.candidates] == \
        [tuple(c) for c in prod.candidates]


def test_pfb_carry_resets_with_the_observation(tmp_path):
    """The WOLA tails start each observation from the fresh state, as the
    bandpasses do: the same seconds give the same .fil twice."""
    cfg = _t(PipelineConfig.tiny(channelizer="pfb", nbit=2))
    pipe = TPipe(1, cfg, _t(SearchConfig.tiny()), out_dir=str(tmp_path),
                 keep_ring=False, write_cands=False, device="cpu")
    secs = [(1.6e9 + s, _noise(cfg.sample_rate, 40 + s)) for s in range(2)]
    fils = []
    for obs in range(2):
        pipe.out_dir = str(tmp_path / f"obs{obs}")
        os.makedirs(pipe.out_dir)
        prod = pipe.run_observation(iter(secs),
                                    TDoc(name="R", start_time=1.6e9),
                                    search_live=False)
        assert pipe.state.tail.abs().sum() > 0
        assert pipe.state.tail.shape == (2, 2, 3 * cfg.nfft)
        with open(prod.fil_path, "rb") as fp:
            fils.append(fp.read())
        pipe.begin_observation(TDoc(name="R", start_time=1.6e9))
        assert pipe.state.tail.abs().sum() == 0
        assert bool((pipe.state.wtail == 1).all())
        pipe.end_observation()
    assert fils[0] == fils[1]


def _matrix():
    """benchmarks/smoke_config_matrix_tpu.py's VARIANTS, read from its
    source (the script runs a TPU smoke when imported)."""
    with open(os.path.join(ROOT, "benchmarks",
                           "smoke_config_matrix_tpu.py")) as fp:
        tree = ast.parse(fp.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", "") == "VARIANTS":
            return ast.literal_eval(node.value)
    raise AssertionError("no VARIANTS")


def test_port_config_matrix_is_the_benchmarks():
    assert [tuple(v) for v in _matrix()] == list(tconfig.CONFIG_MATRIX)


def _levels(packed, nbit):
    return np.asarray(jq.unpack_bits(jnp.asarray(np.asarray(packed)),
                                     nbit)).astype(np.int16)


def _run(make_cfg, second, secs):
    """Each second through `second(cfg, raw, state, arm)` from a fresh
    state (armed at the first where the configuration injects): the
    outputs and states, or the exception type where it refuses."""
    try:
        cfg = make_cfg()
        st = None
        res = []
        for i, raw in enumerate(secs):
            out, st = second(cfg, raw, st, i == 0 and cfg.inject_frb)
            res.append((out, st))
        return res
    except (ValueError, NotImplementedError) as e:
        return type(e)


@pytest.mark.parametrize("name,kw", tconfig.CONFIG_MATRIX,
                         ids=[n for n, _ in tconfig.CONFIG_MATRIX])
def test_config_matrix_matches_jax(name, kw):
    """Each variant over two seconds at the small geometry (2-bit unless
    the variant sets nbit, the production default): the port's program
    (the armed one for the injecting variant, else the twin the pipeline
    resolves) against the JAX package's process_second (ema_impl 'scan'
    where the variant names no EMA), at the chain bar."""
    base = dict(nbit=2, ema_impl="scan", inject_dm=30.0, inject_amp=1.5)
    cfg_j = PipelineConfig.tiny(**{**base, **kw})
    secs = [_noise(cfg_j.sample_rate, 50 + i, bursts=(40_000,))
            for i in range(2)]

    def jax_second(cfg, raw, st, arm):
        st = jdsp.init_state(cfg) if st is None else st
        return jdsp.process_second(cfg, jnp.asarray(raw), st,
                                   jnp.asarray(arm))

    def port_second(cfg, raw, st, arm):
        st = tdsp.init_state(cfg, "cpu") if st is None else st
        tdsp.twin_config(cfg)       # refused as the pipeline refuses it
        _, prog, pcfg = tdsp.second_program(
            cfg, 0 if arm else st.segs_since_inject)
        return prog(pcfg, torch.from_numpy(raw), st, arm)

    want = _run(lambda: PipelineConfig.tiny(**{**base, **kw}), jax_second,
                secs)
    got = _run(lambda: _t(PipelineConfig.tiny(**{**base, **kw})),
               port_second, secs)
    if isinstance(want, type) or isinstance(got, type):
        assert got is want, (got, want)         # refused alike
        return
    nbit = cfg_j.nbit
    for (ot, st_t), (oj, st_j) in zip(got, want):
        for field in ("packed", "packed_kur"):
            lt, lj = _levels(getattr(ot, field), nbit), \
                _levels(getattr(oj, field), nbit)
            assert lt.shape == lj.shape, field
            assert (lt == lj).mean() >= 0.9999, (field, (lt == lj).mean())
        np.testing.assert_allclose(ot.weights.numpy(), np.asarray(oj.weights),
                                   rtol=1e-6)
        assert abs(float(ot.dag_frac) - float(oj.dag_frac)) < 1e-6
        assert np.array_equal(ot.histo.numpy(), np.asarray(oj.histo))
        for f in ("bp", "bp_kur"):
            a, b = getattr(st_t, f).numpy(), np.asarray(getattr(st_j, f))
            rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-6)
            assert rel.max() < 1e-4, (f, rel.max())
        assert np.array_equal(st_t.tail.numpy(), np.asarray(st_j.tail))
        assert st_t.segs_since_inject == int(st_j.segs_since_inject)
    if cfg_j.rfi_mode:
        assert float(got[0][0].dag_frac) > 0    # the burst was flagged
