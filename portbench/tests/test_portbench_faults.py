"""The comparison fails a run whose timed path is broken underneath: a
step that hands its state on unchanged, half of each second's input
left out, the search's S/N answers altered where they are made.  A sound
run of the same tiny cell passes."""

import copy

from portbench.drivers import station
from portbench.tests._tiny import tiny_cell

SEED = 2 ** 31 + 99


def _cell():
    # the pulsar ten times brighter, so that the tiny gulps have crossings
    cell = tiny_cell(traffic="pulsar")
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.traffic["pulsar"]["amp"] = 0.5
    return cell


def _run(cell):
    import time
    r, res = station.run(cell, SEED, 1.0, False, "cpu", time.time())
    return res


def _dsp_fault(monkeypatch, make):
    from vlite_fast_tpu_torch.models import baseband_dsp
    for name in ("process_second", "twin_second"):
        monkeypatch.setattr(baseband_dsp, name,
                            make(getattr(baseband_dsp, name)))


def test_sound_run_is_correct():
    res = _run(_cell())
    assert res.correct, res.compared()


def test_state_unchanged(monkeypatch):
    def make(fn):
        def step(cfg, raw, state, arm=False):
            out, _ = fn(cfg, raw, state, arm)
            return out, state
        return step
    _dsp_fault(monkeypatch, make)
    res = _run(_cell())
    assert not res.correct
    assert (res.values["bandpass_rel_median"]
            > res.limits["bandpass_rel_median"])


def test_half_the_input_left_out(monkeypatch):
    def make(fn):
        def step(cfg, raw, state, arm=False):
            # the second pol dropped, the first taken for both
            return fn(cfg, raw[[0, 0]].contiguous(), state, arm)
        return step
    _dsp_fault(monkeypatch, make)
    res = _run(_cell())
    assert not res.correct
    assert res.values["levels_mismatch"] > res.limits["levels_mismatch"]


def test_answer_altered(monkeypatch):
    from vlite_fast_tpu_torch.ops import dedisperse
    orig = dedisperse.boxcar_snr
    monkeypatch.setattr(dedisperse, "boxcar_snr",
                        lambda *a, **k: orig(*a, **k) * 1.25)
    res = _run(_cell())
    assert not res.correct
    assert res.values["crossings_rel_gap"] > res.limits["crossings_rel_gap"]
