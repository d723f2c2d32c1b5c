"""Structured logging + metrics (multilog / RT_PROFILE equivalents).

The reference logs through psrdada's multilog to timestamped per-process
files that downstream tools machine-parse (logparse/logparse.py Prometheus
exporter), and keeps a running real-time margin that errors when processing
falls >0.5 s behind per 10 s window (ref src/process_baseband.cu:1461-1481).
Here: a std-logging setup with the same file naming, a counter/gauge
registry exportable in Prometheus textfile format, and an RTMonitor with the
reference's margin semantics.

The port's own copy of the JAX package's vlite_fast_tpu/utils/log.py, kept
whole so that the port imports nothing of that package.
"""

from __future__ import annotations

import logging
import os
import socket
import time
from dataclasses import dataclass, field
from typing import Dict, Optional


def make_logger(proc: str, log_dir: Optional[str] = None,
                stdout: bool = True) -> logging.Logger:
    """Timestamped per-process log file:
    <ts>_<host>_<proc>_<pid>.log (ref src/process_baseband.cu:505-521)."""
    logger = logging.getLogger(f"vfast.{proc}.{os.getpid()}")
    logger.setLevel(logging.INFO)
    if logger.handlers:
        return logger
    fmt = logging.Formatter(
        "%(asctime)s %(levelname)s [%(name)s] %(message)s")
    if stdout:
        h = logging.StreamHandler()
        h.setFormatter(fmt)
        logger.addHandler(h)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        ts = time.strftime("%Y%m%d_%H%M%S")
        host = socket.gethostname().split(".")[0]
        path = os.path.join(log_dir, f"{ts}_{host}_{proc}_{os.getpid()}.log")
        fh = logging.FileHandler(path)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class Metrics:
    """Minimal counter/gauge registry, Prometheus-textfile exportable
    (the logparse/logparse.py role, without the log-scraping indirection)."""

    def __init__(self):
        self._values: Dict[str, float] = {}
        self._help: Dict[str, str] = {}

    def set(self, name: str, value: float, help: str = "") -> None:
        self._values[name] = float(value)
        if help:
            self._help[name] = help

    def inc(self, name: str, delta: float = 1.0) -> None:
        self._values[name] = self._values.get(name, 0.0) + delta

    def get(self, name: str) -> float:
        return self._values.get(name, 0.0)

    def to_textfile(self) -> str:
        lines = []
        for k in sorted(self._values):
            if k in self._help:
                lines.append(f"# HELP {k} {self._help[k]}")
            lines.append(f"{k} {self._values[k]}")
        return "\n".join(lines) + "\n"

    def write_textfile(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as fp:
            fp.write(self.to_textfile())
        os.replace(tmp, path)


@dataclass
class RTMonitor:
    """Real-time margin tracking (ref RT_PROFILE,
    src/process_baseband.cu:1461-1481): compare wall-clock elapsed against
    integrated data seconds; alarm when behind by more than `tolerance`
    within each `window` of data."""

    window: float = 10.0
    tolerance: float = 0.5
    _t0: float = field(default_factory=time.perf_counter)
    data_seconds: float = 0.0
    _last_check: float = 0.0
    behind_events: int = 0

    def add(self, seconds_of_data: float) -> Optional[float]:
        """Record processed data; returns the deficit (s) if we fell behind
        at a window boundary, else None."""
        self.data_seconds += seconds_of_data
        if self.data_seconds - self._last_check >= self.window:
            self._last_check = self.data_seconds
            wall = time.perf_counter() - self._t0
            deficit = wall - self.data_seconds
            if deficit > self.tolerance:
                self.behind_events += 1
                return deficit
        return None

    @property
    def realtime_factor(self) -> float:
        wall = time.perf_counter() - self._t0
        return self.data_seconds / wall if wall > 0 else 0.0
