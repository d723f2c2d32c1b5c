"""The readers of the program's span records pick the window's seconds
and gulps (the last window_data_s seconds fed, the gulps searched in
their calls) and read nothing where the program keeps no records."""

import importlib
import sys
import types

import numpy as np
import pytest

from portbench import spec
from portbench.metrics import _spans
from vlite_fast_tpu_torch.utils import spans

SPAN_READERS = ("gulp_wait_p95_ms", "gulp_ahead_s", "cluster_rows_per_gulp",
                "gulp_stall_ms", "gulp_dedisp_ms", "gulp_boxcar_ms",
                "gulp_topk_ms", "dsp_wola_ms", "dsp_dft_ms", "dsp_detect_ms",
                "dsp_pack_ms")


def _second(k, stages):
    r = spans.Record("second", k)
    r.stages = dict(stages)
    return r


def _gulp(g, searched_in, wait, stall, ahead, rows, dedisp):
    r = spans.Record("gulp", g)
    r.add("wait", 10.0, 10.0 + wait)
    if stall is not None:
        r.add("stall", 20.0, 20.0 + stall, parent=None)
    r.counters.update(ahead_s=ahead, cluster_rows=rows)
    if searched_in is not None:
        r.counters["searched_in"] = searched_in
    r.stages = {"dedisperse": dedisp, "boxcar": dedisp / 2,
                "topk": dedisp / 4}
    return r


@pytest.fixture
def published(monkeypatch):
    rec = spans.Recorder()
    for k in range(10):
        # seconds 0-5 before the window, 6-9 in it; 8 ran the twin chain
        stages = {} if k == 8 else {"wola": 1e-3 * (k + 1),
                                    "dft": 2e-3 * (k + 1),
                                    "detect": 3e-3, "pack": 4e-3}
        rec.seconds.append(_second(k, stages))
    rec.gulps.extend([
        _gulp(0, 3, 0.5, 0.01, 9, 100, 0.004),     # before the window
        _gulp(1, 6, 0.1, 0.02, 8, 10, 0.005),
        _gulp(2, 9, 0.3, None, 12, 30, 0.007),
        _gulp(3, None, 0.9, None, 0, 1000, 0.009),  # end_observation's
    ])
    monkeypatch.setattr(spans, "_last", rec)
    return types.SimpleNamespace(window_data_s=4)


def test_readers_read_the_window(published):
    read = {m: spec.reader(m)(published) for m in SPAN_READERS}
    assert read["gulp_wait_p95_ms"] == pytest.approx(
        1e3 * np.percentile([0.1, 0.3], 95))
    assert read["gulp_ahead_s"] == 10.0
    assert read["cluster_rows_per_gulp"] == 20.0
    assert read["gulp_stall_ms"] == pytest.approx(20.0)
    assert read["gulp_dedisp_ms"] == pytest.approx(6.0)
    assert read["gulp_boxcar_ms"] == pytest.approx(3.0)
    assert read["gulp_topk_ms"] == pytest.approx(1.5)
    # seconds 6, 7 and 9 ran process_second
    assert read["dsp_wola_ms"] == pytest.approx(8.0)
    assert read["dsp_dft_ms"] == pytest.approx(16.0)
    assert read["dsp_detect_ms"] == pytest.approx(3.0)
    assert read["dsp_pack_ms"] == pytest.approx(4.0)


def test_no_stage_no_value(published):
    for r in spans.last_observation().seconds:
        r.stages.pop("wola", None)
    assert spec.reader("dsp_wola_ms")(published) is None
    assert spec.reader("dsp_dft_ms")(published) is not None


@pytest.mark.parametrize("metric", SPAN_READERS)
def test_nothing_to_read(monkeypatch, metric):
    """No observation published, an empty window, or a program without
    utils/spans (an older checkout): None."""
    run = types.SimpleNamespace(window_data_s=4)
    monkeypatch.setattr(spans, "_last", None)
    assert spec.reader(metric)(run) is None
    monkeypatch.setattr(spans, "_last", spans.Recorder())
    assert spec.reader(metric)(run) is None
    monkeypatch.setitem(sys.modules, _spans.MODULE, None)
    assert spec.reader(metric)(run) is None


def test_a_broken_recorder_raises(monkeypatch):
    """A recorder module that is there but fails to import is a fault of
    the program, not an older checkout: the readers raise."""
    def broken(name, *a):
        if name == _spans.MODULE:
            raise ModuleNotFoundError("No module named 'numpy.x'",
                                      name="numpy.x")
        return real(name, *a)
    real = importlib.import_module
    monkeypatch.setattr(_spans.importlib, "import_module", broken)
    with pytest.raises(ModuleNotFoundError):
        _spans.window(types.SimpleNamespace(window_data_s=4))
