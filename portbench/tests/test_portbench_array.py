"""The array cell's pieces on the CPU: its generator, its driver at the
tiny geometry (portbench/tests/_tiny_array) with and without a trace and
against a program whose step keeps no call record (as before the array
step took one), its readers on fake call records, and its work count."""

import types

import numpy as np
import pytest
import torch

from portbench import check_array, run, spec
from portbench.generators import array_baseband
from portbench.tests import _tiny_array as ta
from portbench.work import array_counts, counts
from vlite_fast_tpu_torch.utils import spans

SPAN_READERS = ("array_dsp_ms", "array_beam_search_ms", "array_coadd_ms",
                "array_host_ms", "array_cluster_rows")
SEED = 2 ** 31 + 7


def test_the_cell_is_declared():
    cell = spec.load_cell("array8.coadd")
    assert cell.config["driver"] == "array_step"
    assert cell.traffic["generator"] == "array_baseband"
    assert {m["name"] for m in cell.end_to_end} == {"antennas_per_card",
                                                     "setup_s"}
    assert {m["name"] for m in cell.per_layer} == set(SPAN_READERS) | {
        "array_roofline_pct"}
    assert set(cell.limits) == set(check_array.NUMBERS)
    arr = cell.config["array"]
    assert (arr["nant"], arr["mesh_ant"], arr["mesh_time"],
            arr["nsec_per_call"], arr["inject_sec"]) == (8, 1, 1, 20, 2)
    station = spec.load_cell("station_fft.noise").config
    assert cell.config["dsp"] == station["dsp"]
    assert cell.config["search"] == station["search"]


def test_generator_is_seeded_and_antennas_independent():
    t = dict(spec.load_cell("array8.coadd").traffic, seconds=2)
    bufs = []
    for seed in (SEED, SEED, SEED + 1):
        raw = torch.empty((3, 2, 2000), dtype=torch.uint8)
        array_baseband.fill_call(t, raw, 1000, seed)
        bufs.append(raw)
    assert torch.equal(bufs[0], bufs[1])
    assert not torch.equal(bufs[0], bufs[2])
    assert not torch.equal(bufs[0][0], bufs[0][1])
    x = bufs[0].double()
    assert abs(float(x.mean()) - 128.0) < 1.0
    assert abs(float(x.std()) - 1 / t["digitize"]["scale"]) < 1.0
    # one antenna's call alone is its row of the whole call
    dsp = {"sample_rate": 1000, "npol_in": 2}
    for a in range(3):
        assert torch.equal(array_baseband.antenna_call(t, dsp, SEED, a,
                                                       "cpu"), bufs[0][a])
    with pytest.raises(ValueError):
        array_baseband.fill_call(t, torch.empty((3, 2, 3000),
                                                dtype=torch.uint8), 1000, 1)


def _execute(trace: bool, seed: int = SEED):
    import time
    return run.execute(ta.tiny_array_cell(), seed, 0.5, trace, "cpu",
                       time.time())


def test_driver_untraced():
    out = _execute(False)
    assert out["correct"] is True, out["compared"]
    # the tiny band's sweep (a few samples) cannot place the burst's DM
    # within 10%: `failed` is counted, not asserted, at this size
    assert out["attempted"] >= 1 and 0 <= out["failed"] <= out["attempted"]
    assert set(out["metrics"]) == {"antennas_per_card", "setup_s"}
    assert list(out["compared"]) == list(check_array.NUMBERS)


def test_driver_traced():
    out = _execute(True, SEED + 1)
    assert out["correct"] is True, out["compared"]
    assert out["attempted"] >= 2
    # on the CPU the trace holds no device operation: no roofline
    assert set(out["metrics"]) == set(SPAN_READERS)
    assert out["device"]["window_s"] > 0


def test_driver_on_a_program_without_call_records(monkeypatch):
    """A step that takes no record (the program before the call records)
    runs the cell as well, and every span reader reads no value."""
    from vlite_fast_tpu_torch.parallel import sharded_pipeline as sp
    real = sp.build_array_step

    def without_records(*a, **kw):
        step_fn, make_inputs, plan, info = real(*a, **kw)
        return ((lambda raw, bp, bp_kur, tail=None:
                 step_fn(raw, bp, bp_kur, tail)), make_inputs, plan, info)

    monkeypatch.setattr(sp, "build_array_step", without_records)
    out = _execute(True, SEED + 2)
    assert out["correct"] is True, out["compared"]
    assert out["metrics"] == {}


def _call(k, dsp_s, beam_s, coadd_s, host_s, rows):
    r = spans.Record("call", k)
    r.counters.update(antenna_seconds=160, beams=8, cluster_rows=rows)
    r.stages = {"front": dsp_s / 2, "dft": dsp_s / 4, "pack": dsp_s / 4,
                "reshard": 1.0, "dedisperse": beam_s / 2,
                "boxcar": beam_s / 4, "topk": beam_s / 4,
                "coadd": coadd_s / 2, "coadd_search": coadd_s / 2}
    r.add("decode", 0.0, host_s / 2)
    r.add("cluster", 1.0, 1.0 + host_s / 2)
    return r


def test_readers_on_fake_records():
    calls = [_call(1, 8.0, 0.8, 0.1, 0.02, 100),
             _call(2, 8.32, 0.88, 0.3, 0.04, 300),
             _call(3, 8.16, 0.96, 0.2, 0.06, 200)]
    r = types.SimpleNamespace(calls=calls)
    got = {m: spec.reader(m)(r) for m in SPAN_READERS}
    assert got == pytest.approx({
        "array_dsp_ms": 1e3 * 8.16 / 160,
        "array_beam_search_ms": 1e3 * 0.88 / 8,
        "array_coadd_ms": 200.0, "array_host_ms": 40.0,
        "array_cluster_rows": 200.0})
    empty = types.SimpleNamespace(calls=[])
    assert all(spec.reader(m)(empty) is None for m in SPAN_READERS)


def test_roofline_reader():
    cell = spec.load_cell("array8.coadd")
    r = types.SimpleNamespace(cell=cell, masked_share=0.1, trace={
        "by_range": {"vfast.array_call": (4.0, 1)}})
    least = array_counts.call_work(cell.config, 0.1)["seconds"]
    assert spec.reader("array_roofline_pct")(r) == pytest.approx(
        100 * least / 4.0)
    for bare in (dict(r.__dict__, trace=None),
                 dict(r.__dict__, masked_share=None)):
        assert spec.reader("array_roofline_pct")(
            types.SimpleNamespace(**bare)) is None


def test_call_work_is_its_seconds_and_searches():
    cfg = spec.load_cell("array8.coadd").config
    w = array_counts.call_work(cfg, 0.3)
    dsp = cfg["dsp"]
    sec = counts.second_work(dsp, False, 0.3)
    gulp = counts.gulp_work(dsp, dict(cfg["search"], gulp_samps=25600,
                                      topk=65536))
    assert w["ops"] > 160 * sec["ops"] + 9 * gulp["ops"]
    assert w["ops"] < 160 * sec["ops"] + 9 * gulp["ops"] + 1e9
    assert w["bound_by"] == "operations"
    # tens of ms: the FFT's operations, ~0.17 ms a second at 67 TFLOP/s
    assert 0.02 < w["seconds"] < 0.1
    assert np.isfinite(w["bytes"])
