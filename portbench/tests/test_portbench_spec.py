"""Every cell, configuration, traffic mix, metric and limit that
BENCHMARK.json names is found by name and read."""

import json
import re

import pytest

from portbench import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads(cell):
    c = spec.load_cell(cell)
    assert c.config["dsp"] and c.config["search"]
    assert c.traffic["seconds"] >= 1
    assert callable(spec.driver(c).run)
    assert callable(spec.generator(c.traffic).staged_seconds)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    from portbench import check
    assert set(c.limits) == set(check.NUMBERS)


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_reader(metric):
    assert callable(spec.reader(metric))


def test_names_and_units():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
    layers = {m["moves"] for m in BENCH["per_layer"]}
    assert layers <= {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads",
                                                    m["workloads"]))


@pytest.mark.parametrize("conf", BENCH["configs"])
def test_config_file(conf):
    d = json.loads((spec.ROOT / conf["file"]).read_text())
    assert d["name"] == conf["name"] and d["reduced"] == conf["reduced"]
    assert d["source"] == conf["source"]
    from vlite_fast_tpu_torch.config import PipelineConfig
    PipelineConfig(**d["dsp"])
