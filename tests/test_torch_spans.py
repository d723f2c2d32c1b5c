"""The station's span recorder (vlite_fast_tpu_torch/utils/spans) on the
CPU: a tiny observation's records nest and carry one id each, their
counters count what the search handled, the pipeline's and the search's
timing views are read from them, the stage marks in process_second and
the gulp record nothing outside a bound record and change no output, and
a profiled observation holds the spans' "vfast/..." ranges beside the
pipeline's own PROFILE_RANGES; and a call of the sharded array step
(parallel/sharded_pipeline) on a one-rank gloo mesh fills the call
record it is given, and makes the same bytes without one."""

import json

import numpy as np
import pytest
import torch

from vlite_fast_tpu_torch.config import PipelineConfig, SearchConfig
from vlite_fast_tpu_torch.models import baseband_dsp as dsp
from vlite_fast_tpu_torch.models import search as search_mod
from vlite_fast_tpu_torch.utils import spans
from vlite_fast_tpu_torch.runtime.pipeline import (HOST_PARTS,
                                                   PROFILE_RANGES,
                                                   ObservationDocument,
                                                   StationPipeline)

NSEC = 8


def _cfg(**kw):
    return PipelineConfig.tiny(nbit=2, inject_frb=True, **kw)


def _seconds(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return [np.clip(rng.standard_normal((2, cfg.sample_rate)) / 0.05914
                    + 128.5, 0, 255).astype(np.uint8) for _ in range(n)]


@pytest.fixture(scope="module")
def observed(tmp_path_factory):
    """A tiny observation of NSEC seconds at a low threshold (so that
    noise crosses it), with the rows every cluster_hits call received."""
    cfg = _cfg()
    scfg = SearchConfig.tiny(snr_thresh=4.0)
    pipe = StationPipeline(1, cfg, scfg, keep_ring=False, write_cands=False,
                           out_dir=str(tmp_path_factory.mktemp("spans")),
                           device="cpu")
    clustered = []
    real = search_mod.dd.cluster_hits

    def counting(hits, *a, **kw):
        clustered.append(len(hits))
        return real(hits, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(search_mod.dd, "cluster_hits", counting)
        prod = pipe.run_observation(
            ((1.6e9 + s, b) for s, b in enumerate(_seconds(cfg, NSEC))),
            ObservationDocument(name="SPANS", start_time=1.6e9),
            write_fil=False)
    return pipe, prod, clustered


def test_every_second_and_gulp_has_a_record(observed):
    pipe, prod, _ = observed
    rec = pipe.records
    assert spans.last_observation() is rec
    assert [r.id for r in rec.seconds] == list(range(NSEC)) == \
        list(range(prod.seconds))
    assert [g.id for g in rec.gulps] == list(range(len(rec.gulps)))
    assert len(rec.gulps) == pipe.metrics.get("vfast_gulps_searched") >= 3


@pytest.mark.parametrize("layer", ["seconds", "gulps"])
def test_spans_nest_inside_their_parent(observed, layer):
    """Every span names its parent, the record's root span, and lies
    inside it; the children's durations sum to no more than the root's."""
    for rec in getattr(observed[0].records, layer):
        root = rec.first(rec.layer)
        assert root is not None and root.parent is None
        kids = [s for s in rec.spans if s.parent is not None]
        assert kids and {s.parent for s in kids} == {rec.layer}
        for s in kids:
            assert root.start <= s.start <= s.end <= root.end, (rec.id, s)
        assert sum(s.seconds for s in kids) <= root.seconds


@pytest.mark.parametrize("layer", ["seconds", "gulps"])
def test_one_id_on_every_span_of_a_record(observed, layer):
    for rec in getattr(observed[0].records, layer):
        assert {s.id for s in rec.spans} == {rec.id}


def test_gulp_spans_cover_its_latency(observed):
    """A gulp's root span starts with the feed_second call that fed its
    last row; its children are lag, dispatch, wait, decode and cluster in
    that order; its stall runs from its fetch's return to the end of the
    call, and from the start of the next call to the next dispatch."""
    pipe = observed[0]
    secs = {r.id: r for r in pipe.records.seconds}
    rows = pipe.cfg.seg_per_sec * pipe.cfg.out_samps_per_seg
    gulp, overlap = pipe.scfg.gulp_samps, pipe.search.overlap
    gulps = list(pipe.records.gulps)
    for g in gulps:
        kids = [s.name for s in g.spans if s.parent == "gulp"]
        assert sorted(kids) == sorted(spans.GULP_PARTS)
        order = [g.first(n) for n in spans.GULP_PARTS]
        assert all(a.end <= b.start for a, b in zip(order, order[1:]))
        stop = min(g.id * gulp + gulp + overlap, NSEC * rows)
        last = (stop - 1) // rows
        assert g.first("gulp").start == secs[last].start
        assert g.first("lag").start == secs[last].start
    for g, nxt in zip(gulps, gulps[1:]):
        stall = [s for s in g.spans if s.name == "stall"]
        assert stall[0].start == g.first("wait").end
        assert stall[-1].end <= nxt.first("dispatch").start
        if len(stall) == 2:
            k = g.counters["searched_in"]
            assert stall[0].end == secs[k].first("second").end
            if k + 1 < NSEC:
                assert stall[1].start == secs[k + 1].start
                assert stall[1].end < secs[k + 1].first("program").start
        else:
            assert len(stall) == 1 and stall[0].end == \
                nxt.first("dispatch").start
    assert gulps[-1].first("stall") is None


def test_gulp_counters(observed):
    """cluster_rows is what cluster_hits received; ahead_s counts the
    second being fed (the CPU leaves none unread); a gulp of
    end_observation has no searched_in; injected flags the gulps that
    hold an armed second."""
    pipe, _, clustered = observed
    gulps = list(pipe.records.gulps)
    assert [g.counters["cluster_rows"] for g in gulps] == clustered
    assert sum(clustered) > 0
    assert all(set(g.counters) <= {"ahead_s", "cluster_rows", "injected",
                                   "searched_in"} for g in gulps)
    fed = [g for g in gulps if "searched_in" in g.counters]
    assert 0 < len(fed) < len(gulps)
    assert all(g.counters["ahead_s"] == 1 for g in fed)
    assert all(g.counters["ahead_s"] == 0 for g in gulps[len(fed):])
    rows = pipe.cfg.seg_per_sec * pipe.cfg.out_samps_per_seg
    armed = {r.id for r in pipe.records.seconds if r.counters["armed"]}
    gulp, overlap = pipe.scfg.gulp_samps, pipe.search.overlap
    for g in gulps:
        lo, hi = g.id * gulp, min(g.id * gulp + gulp + overlap, NSEC * rows)
        held = set(range(lo // rows, (hi - 1) // rows + 1))
        assert g.counters["injected"] == int(bool(held & armed))
        if "searched_in" in g.counters:
            assert g.counters["searched_in"] == (hi - 1) // rows + 1


def test_views_are_read_from_the_records(observed):
    """host_seconds keeps HOST_PARTS, one entry a fed second, each the
    second record's span of that part; feed_seconds one device span a
    second under its program; the search's host_seconds the sums of the
    gulp records' spans (GULP_HOST_PARTS: fetch is the span "wait")."""
    pipe, prod, _ = observed
    secs = list(pipe.records.seconds)
    assert tuple(pipe.host_seconds) == HOST_PARTS
    for k in HOST_PARTS:
        assert len(pipe.host_seconds[k]) == prod.seconds
        assert pipe.host_seconds[k] == [r.parts([k])[k] for r in secs]
    assert pipe.host_seconds["search"][-1] > 0
    for kind, flag in (("armed", 1), ("twin", 0)):
        assert pipe.feed_seconds[kind] == [
            r.device_s for r in secs if r.counters["armed"] == flag]
    cfg = pipe.cfg
    assert len(pipe.feed_seconds["armed"]) == sum(
        dsp.second_injects(cfg, s * cfg.seg_per_sec)
        for s in range(prod.seconds))
    assert tuple(pipe.search.host_seconds) == search_mod.GULP_HOST_PARTS
    for part, name in zip(search_mod.GULP_HOST_PARTS,
                          ("dispatch", "wait", "decode", "cluster")):
        assert pipe.search.host_seconds[part] == pytest.approx(
            sum(g.parts([name])[name] for g in pipe.records.gulps),
            rel=1e-9, abs=1e-12)


def test_stages_of_the_records(observed):
    """The armed seconds carry process_second's stages, the twin seconds
    (the chain's plain version here) none; every gulp carries its three."""
    pipe = observed[0]
    for r in pipe.records.seconds:
        want = {"front", "dft", "detect", "ema", "pack"} \
            if r.counters["armed"] else set()
        assert set(r.stages) == want
        assert sum(r.stages.values()) <= r.device_s
    for g in pipe.records.gulps:
        assert set(g.stages) == {"dedisperse", "boxcar", "topk"}
        assert sum(g.stages.values()) == pytest.approx(g.device_s)


@pytest.mark.parametrize("arm", [False, True])
@pytest.mark.parametrize("channelizer", ["matmul", "pfb"])
def test_stage_marks_change_no_output(channelizer, arm):
    """process_second is bit-equal with and without a bound record, and
    only a bound record gets its stages."""
    cfg = _cfg(channelizer=channelizer)
    raw = torch.from_numpy(_seconds(cfg, 1, seed=5)[0])
    st = dsp.init_state(cfg, "cpu")
    plain, st_plain = dsp.process_second(cfg, raw, st, arm)
    rec = spans.Record("second", 0)
    with spans.bound(rec):
        marked, st_marked = dsp.process_second(cfg, raw, st, arm)
    for a, b in zip(plain + tuple(st_plain), marked + tuple(st_marked)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b
    assert spans.bound_record() is None
    rec.resolve()
    want = {"front", "dft", "detect", "ema", "pack"}
    assert set(rec.stages) == want | ({"wola"} if channelizer == "pfb"
                                      else set())


def test_twin_and_unbound_search_mark_nothing():
    cfg = _cfg()
    raw = torch.from_numpy(_seconds(cfg, 1, seed=6)[0])
    rec = spans.Record("second", 0)
    with spans.bound(rec):
        dsp.twin_second(dsp.twin_config(cfg), raw, dsp.init_state(cfg, "cpu"))
    rec.resolve()
    assert rec.stages == {} and rec.device_s is None
    scfg = SearchConfig.tiny()
    eng = search_mod.SinglePulseSearch(scfg, cfg.tsamp, cfg.freqs_mhz(),
                                       device="cpu")
    fb = np.random.default_rng(1).standard_normal(
        (scfg.gulp_samps + eng.overlap, cfg.nchanout)).astype(np.float32)
    eng.search_gulp(fb)
    assert spans.bound_record() is None
    g = spans.Record("gulp", 0)
    with spans.bound(g):
        eng.search_gulp(fb)
    g.resolve()
    assert set(g.stages) == {"dedisperse", "boxcar", "topk"}
    assert [s.name for s in g.spans] == ["dispatch", "wait", "decode",
                                         "cluster"]


def test_recorder_keeps_the_newest_records():
    rec = spans.Recorder()
    assert rec.seconds.maxlen >= 16384 and rec.gulps.maxlen >= 4096
    for i in range(rec.gulps.maxlen + 3):
        rec.gulps.append(spans.Record("gulp", i))
    assert rec.gulps[0].id == 3 and len(rec.gulps) == rec.gulps.maxlen


def test_gulp_summary(observed):
    """The operator's summary of the gulp records: the latency's p50 and
    p95, its p95 over the gulps with and without an injected second, its
    mean by part, the mean stall and the mean rows clustered."""
    gulps = list(observed[0].records.gulps)
    s = spans.gulp_summary(gulps)
    ms = lambda g, n: 1e3 * g.first(n).seconds
    lat = sorted(ms(g, "gulp") for g in gulps)
    assert s["gulps"] == len(gulps)
    assert lat[0] <= s["latency_ms_p50"] <= s["latency_ms_p95"] <= lat[-1]
    for flag, key in ((1, "latency_ms_p95_injected"),
                      (0, "latency_ms_p95_plain")):
        mine = [ms(g, "gulp") for g in gulps
                if g.counters["injected"] == flag]
        assert mine and s[key] == pytest.approx(np.percentile(mine, 95))
    assert set(s["parts_ms_mean"]) == set(spans.GULP_PARTS)
    for k, v in s["parts_ms_mean"].items():
        assert v == pytest.approx(np.mean([ms(g, k) for g in gulps]))
    assert sum(s["parts_ms_mean"].values()) <= np.mean(lat) + 1e-9
    assert s["stall_ms_mean"] > 0
    assert s["cluster_rows_mean"] == pytest.approx(
        np.mean(observed[2]))
    assert spans.gulp_summary([]) == {
        "gulps": 0, "latency_ms_p50": None, "latency_ms_p95": None,
        "latency_ms_p95_injected": None, "latency_ms_p95_plain": None,
        "parts_ms_mean": dict.fromkeys(spans.GULP_PARTS),
        "stall_ms_mean": None, "cluster_rows_mean": None}


def test_profile_trace_holds_the_span_ranges(tmp_path):
    """A profiled observation holds the spans' "vfast/<layer>.<name>"
    ranges: the gulp's inside vfast.gulp_search, the drain's wait inside
    vfast.drain; every range starting "vfast." is one of PROFILE_RANGES."""
    cfg = _cfg()
    pipe = StationPipeline(1, cfg, SearchConfig.tiny(), out_dir=str(tmp_path),
                           keep_ring=False, write_cands=False, device="cpu")
    pipe.block_taps.append(lambda *a: None)
    pipe.run_observation(
        ((1.6e9 + s, b) for s, b in enumerate(_seconds(cfg, 4, seed=3))),
        ObservationDocument(name="P", start_time=1.6e9), write_fil=False,
        profile_dir=str(tmp_path / "prof"))
    with open(pipe.profile_path) as fp:
        ev = [e for e in json.load(fp)["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    names = {e["name"] for e in ev}
    assert set(PROFILE_RANGES) <= names
    assert {n for n in names if n.startswith("vfast.")} <= \
        set(PROFILE_RANGES)
    assert {"vfast/second.staging", "vfast/second.program",
            "vfast/second.copy", "vfast/second.wait", "vfast/second.drain",
            "vfast/second.search", "vfast/gulp.dispatch", "vfast/gulp.wait",
            "vfast/gulp.decode", "vfast/gulp.cluster"} <= names

    def inside(name, outer):
        holders = [(e["ts"], e["ts"] + e["dur"]) for e in ev
                   if e["name"] == outer]
        mine = [e for e in ev if e["name"] == name]
        assert mine
        for e in mine:
            assert any(a <= e["ts"] and e["ts"] + e["dur"] <= b
                       for a, b in holders), (name, outer)

    for part in ("dispatch", "wait", "decode", "cluster"):
        inside(f"vfast/gulp.{part}", "vfast.gulp_search")
    inside("vfast/second.wait", "vfast.drain")
    inside("vfast.armed_second", "vfast/second.program")


CALL_STAGES = {"front", "dft", "detect", "ema", "pack", "reshard",
               "dedisperse", "boxcar", "topk", "coadd", "coadd_search"}


@pytest.fixture(scope="module")
def array_calls():
    """Two calls of the tiny array (portbench/tests/_tiny_array) with a
    record and two without, at a low threshold (so that noise crosses
    it), with the rows every cluster_hits call received in the first."""
    from portbench.tests import _tiny_array as ta
    from vlite_fast_tpu_torch.parallel import sharded_pipeline as sp
    cell = ta.tiny_array_cell(snr_thresh=4.0)
    clustered = []
    real = sp.dd.cluster_hits

    def counting(hits, *a, **kw):
        clustered.append(len(hits))
        return real(hits, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sp.dd, "cluster_hits", counting)
        with_rec = ta.array_calls(cell, 2, seed=5)
    without = ta.array_calls(cell, 2, seed=5, record=False)
    return with_rec, without, clustered


def test_call_record_spans_nest(array_calls):
    """A call's host spans, one id each: the root "call" around the
    step's "dispatch", "gather", "decode" and "cluster", in that order."""
    for k, c in enumerate(array_calls[0]["calls"]):
        rec = c["record"]
        assert rec.layer == "call" and rec.id == k
        assert [(s.name, s.parent) for s in rec.spans] == [
            ("dispatch", "call"), ("gather", "call"), ("decode", "call"),
            ("cluster", "call"), ("call", None)]
        assert {s.id for s in rec.spans} == {k}
        root = rec.first("call")
        for a, b in zip(rec.spans, rec.spans[1:4]):
            assert a.end <= b.start
        assert all(root.start <= s.start <= s.end <= root.end
                   for s in rec.spans)


def test_call_record_counters(array_calls):
    from portbench.tests import _tiny_array as ta
    ran, _, clustered = array_calls
    info = ran["info"]
    assert sum(clustered) > 0
    n = 0
    for c in ran["calls"]:
        cnt = c["record"].counters
        assert cnt["antenna_seconds"] == info.nant * ta.NSEC
        assert cnt["beams"] == info.nant
        assert cnt["crossings"] == c["stats"]["n_crossings"] > 0
        assert cnt["saturated_bands"] == c["stats"]["saturated_bands"]
        k = len(c["per_beam"]) + (1 if c["coadd"] else 0)
        assert cnt["cluster_rows"] == sum(clustered[n:n + k])
        n += k


def test_call_record_stages_sum_to_its_device_span(array_calls):
    """Every stage of the call is marked, the first call's bandpass seed
    outside them, and they sum to (nearly all of) the step's span."""
    for c in array_calls[0]["calls"]:
        rec = c["record"]
        assert set(rec.stages) == CALL_STAGES
        total = sum(rec.stages.values())
        assert 0.8 * rec.device_s <= total <= rec.device_s + 1e-9


def test_call_record_changes_no_output(array_calls):
    """The step's outputs, state and candidates are the same bytes with a
    record bound and without."""
    for a, b in zip(*(r["calls"] for r in array_calls[:2])):
        for x, y in zip(a["full"], b["full"]):
            assert np.array_equal(x, y)
        for x, y in zip(a["state"], b["state"]):
            assert torch.equal(x, y)
        assert a["per_beam"] == b["per_beam"] and a["coadd"] == b["coadd"]
    assert spans.bound_record() is None


def test_fullgeom_parts_read_the_call_record(array_calls):
    """benchmarks/fullgeom_mesh.part_ms gives the step's parts from the
    call record's stages, every stage in one part."""
    from vlite_fast_tpu_torch.benchmarks import fullgeom_mesh as fg
    rec = array_calls[0]["calls"][1]["record"]
    parts = fg.part_ms(rec)
    assert list(parts) == ["dsp", "reshard", "beam_search",
                           "coadd_allreduce", "coadd_search"]
    assert set(rec.stages) <= {s for v in fg.PARTS.values() for s in v}
    assert sum(parts.values()) == pytest.approx(
        1e3 * sum(rec.stages.values()))
