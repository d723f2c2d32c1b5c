"""array_fused_share on fake call records: the median share of a call's
antenna-seconds handed to a fused launch, a record without the counter
reading 0 beside records with it, and no value where no record has it
(a program that keeps no such counter) or there is no record."""

import types

import pytest

from portbench import spec
from vlite_fast_tpu_torch.utils import spans


def _call(k, fused=None):
    r = spans.Record("call", k)
    r.counters.update(antenna_seconds=160, beams=8)
    if fused is not None:
        r.counters["fused_seconds"] = fused
    return r


def test_reads_the_median_share():
    read = spec.reader("array_fused_share")
    calls = [_call(1, 152), _call(2, 152), _call(3, 144)]
    assert read(types.SimpleNamespace(calls=calls)) == pytest.approx(0.95)
    calls = [_call(1, 152), _call(2), _call(3)]
    assert read(types.SimpleNamespace(calls=calls)) == 0.0


def test_no_counter_no_value():
    read = spec.reader("array_fused_share")
    assert read(types.SimpleNamespace(calls=[_call(1), _call(2)])) is None
    assert read(types.SimpleNamespace(calls=[])) is None
    assert read(types.SimpleNamespace()) is None


def test_declared_for_the_array_cell():
    cell = spec.load_cell("array8.coadd")
    m = {m["name"]: m for m in cell.per_layer}["array_fused_share"]
    assert (m["source"], m["moves"], m["layer"]) == (
        "program_counter", "antennas_per_card", "armed program")
    station = spec.load_cell("station_fft.noise")
    assert "array_fused_share" not in {m["name"] for m in station.per_layer}
