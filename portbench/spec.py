"""A cell as BENCHMARK.json names it: its configuration, its traffic, the
metrics it reports and the limits of its comparison, and the code that
runs it, each found by name under portbench/:

  configs/<config>.json     the configuration; its "driver" names
                            drivers/<driver>.py, which runs the program
                            (set-up, window, comparison)
  traffic/<traffic>.json    the traffic mix; its "generator" names
                            generators/<generator>.py, which makes it
  metrics/<metric>.py       a metric's reader
  limits/<cell>.json        the limits of the cell's comparison

A later cell adds files and entries: a new kind of program entry or of
load brings a driver or a generator of its own, and edits none here.
"""

from __future__ import annotations

import importlib
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    config: dict            # portbench/configs/<config>.json
    traffic: dict           # portbench/traffic/<traffic>.json
    end_to_end: list        # metric entries of BENCHMARK.json it reports
    per_layer: list
    limits: dict            # portbench/limits/<name>.json
    chips: int = 1


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = json.loads(Path(bench_path).read_text())
    w = {x["name"]: x for x in bench["workloads"]}.get(name)
    if w is None:
        raise KeyError(f"no workload {name!r} in {bench_path}")
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name,
        config=json.loads((ROOT / conf["file"]).read_text()),
        traffic=json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                           .read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        limits=json.loads((HERE / "limits" / f"{name}.json").read_text()),
        chips=w["chips"])


def driver(cell: Cell):
    """portbench/drivers/<config's driver>.py.  Its `run(cell, seed,
    seconds, trace, device, t_process)` returns (run, result): `run` is
    what the cell's metric readers read, with `attempted`, `failed`,
    `memory_peak_bytes` and `trace` (trace.analyse's dict, or None);
    `result` has `correct` and `compared()`, each compared number beside
    its limit."""
    return importlib.import_module(
        f"portbench.drivers.{cell.config['driver']}")


def generator(traffic: dict):
    """portbench/generators/<traffic's generator>.py."""
    return importlib.import_module(
        f"portbench.generators.{traffic['generator']}")


def reader(metric: str):
    """The `read(run)` of portbench/metrics/<metric>.py."""
    return importlib.import_module(f"portbench.metrics.{metric}").read
