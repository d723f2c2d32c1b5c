"""The port's span recorder: where a data-second's and a gulp's time
goes, inside StationPipeline, and an array step call's, inside
parallel/sharded_pipeline.

A Record is one data-second (layer "second", id its index in the
observation), one gulp (layer "gulp", id its index in the observation),
one call of the sharded array step (layer "call", id the call's index
in the observation) or one sample range of the host runtime's coadd
(layer "coadd", runtime/pipeline.CoaddSearcher).  It holds

  spans     host spans (Span: name, start, end on time.perf_counter, the
            name of the span that encloses it, the record's id), in the
            order they closed
  counters  numbers taken at the same boundaries
  stages    the device's seconds by stage, from marks made while the
            record was bound (`bound`, `stage`): on a card CUDA events,
            read once the last has completed (`resolve`), on the CPU the
            host clock; stage i runs from its mark to the next one, and a
            mark named None ends a run of stages
  device_s  the device's span from the first mark to the last

A data-second's spans: "second" (the feed_second call), and inside it the
host parts "staging", "program" (the program's dispatch), "copy", "wait",
"drain" and "search"; and "ring", the second's write into its station's
ring, on the ring's thread, outside the call.  A gulp's: "gulp" (from the start of the
feed_second call that handed over its last row to its candidates), and
inside it "lag" (to its dispatch), "dispatch", "wait" (the crossings'
fetch: the card's queue ahead and the gulp's own device time), "decode",
"cluster"; and "stall" (one span or two), the card idle for the
program's host work after the fetch (the card's queue is then empty):
from the fetch's return to the end of the call, and from the start of
each later call to the next dispatch of a program or a gulp onto the
card, leaving out the caller's time between calls.

A coadd range's: "sum" (the dequantize, sum, scale and cast of every
station's rows, dispatched) and "search" (the gulp searches the range
completed).

A call's: "call" (the caller's, around the step, the gather and the
extraction), and inside it "dispatch" (the step's host time), "gather"
(the outputs to the host, which waits for the card), "decode" and
"cluster"; its counters and device stages are listed in
parallel/sharded_pipeline's docstring.  The caller binds nothing: the
step binds the record it is given.

While torch.profiler records, each span entered as a context (`span`)
also enters a record_function range "vfast/<layer>.<name>" with the
record's id as its args: not "vfast.", the prefix of the pipeline's own
PROFILE_RANGES, which readers of a trace take to never nest.

Marks and counts (`count`) are made only where a caller bound a record
(StationPipeline binds one around each program and each gulp search, the
array step the call's record it is given); from anywhere else `stage`
and `count` do nothing.  A Recorder keeps an observation's records, the
oldest dropping off past SECOND_RECORDS and GULP_RECORDS, and
StationPipeline.end_observation publishes it (`last_observation`).
"""

from __future__ import annotations

import collections
import contextvars
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.autograd import profiler as _profiler

SECOND_RECORDS = 16384
GULP_RECORDS = 4096


class Span(NamedTuple):
    name: str
    start: float
    end: float
    parent: Optional[str]
    id: int

    @property
    def seconds(self) -> float:
        return self.end - self.start


class _Open:
    """A span being timed (Record.span)."""

    __slots__ = ("rec", "name", "parent", "t", "rf", "seconds")

    def __init__(self, rec, name, parent):
        self.rec, self.name, self.parent = rec, name, parent

    def __enter__(self):
        self.rf = None
        if _profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(
                f"vfast/{self.rec.layer}.{self.name}", str(self.rec.id))
            self.rf.__enter__()
        self.t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t = time.perf_counter()
        self.seconds = t - self.t
        self.rec.spans.append(Span(self.name, self.t, t, self.parent,
                                   self.rec.id))
        if self.rf is not None:
            self.rf.__exit__(*exc)


class Record:
    """One data-second's or one gulp's spans, counters and device
    stages (see the module docstring)."""

    __slots__ = ("layer", "id", "start", "spans", "counters", "stages",
                 "device_s", "_on_card", "_marks")

    def __init__(self, layer: str, id: int, on_card: bool = False):
        self.layer, self.id = layer, id
        self.start = time.perf_counter()
        self.spans = []
        self.counters = {}
        self.stages = {}
        self.device_s = None
        self._on_card = on_card
        self._marks = []

    def span(self, name: str, parent: Optional[str] = "") -> _Open:
        """A context timing span `name`, inside the record's root span
        (named as the layer) unless `parent` says otherwise."""
        return _Open(self, name, self.layer if parent == "" else parent)

    def add(self, name: str, start: float, end: float,
            parent: Optional[str] = "") -> None:
        """A span whose times were taken elsewhere."""
        self.spans.append(Span(name, start, end,
                               self.layer if parent == "" else parent,
                               self.id))

    def first(self, name: str) -> Optional[Span]:
        return next((s for s in self.spans if s.name == name), None)

    def parts(self, names) -> dict:
        """Seconds in the spans of each of `names` (0.0 for one without
        a span)."""
        out = dict.fromkeys(names, 0.0)
        for s in self.spans:
            if s.name in out:
                out[s.name] += s.end - s.start
        return out

    def mark(self, stage: Optional[str]) -> None:
        """The device reaches `stage` (None: the stages end) here."""
        if self._on_card:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._marks.append((stage, ev))
        else:
            self._marks.append((stage, time.perf_counter()))

    def resolve(self, wait: bool = False) -> bool:
        """Turn the marks into `stages` and `device_s` once the last has
        completed (with wait, the caller has synchronized); whether the
        record holds no unread mark now."""
        marks = self._marks
        if not marks:
            return True
        if self._on_card:
            if not (wait or marks[-1][1].query()):
                return False
            dt = lambda a, b: a.elapsed_time(b) / 1e3
        else:
            dt = lambda a, b: b - a
        for (stage, a), (_, b) in zip(marks, marks[1:]):
            if stage is not None:
                self.stages[stage] = self.stages.get(stage, 0.0) + dt(a, b)
        self.device_s = dt(marks[0][1], marks[-1][1])
        self._marks = []
        return True


_BOUND = contextvars.ContextVar("vfast_spans_bound", default=None)


class bound:
    """Inside: `stage` and `bound_record` reach `rec` (None: no record)."""

    __slots__ = ("rec", "token")

    def __init__(self, rec: Optional[Record]):
        self.rec = rec

    def __enter__(self):
        self.token = _BOUND.set(self.rec)
        return self.rec

    def __exit__(self, *exc):
        _BOUND.reset(self.token)


def bound_record() -> Optional[Record]:
    return _BOUND.get()


def stage(name: Optional[str]) -> None:
    """The device stage `name` starts here (None: the stages end), in the
    bound record; nothing without one."""
    rec = _BOUND.get()
    if rec is not None:
        rec.mark(name)


def count(name: str) -> None:
    """Add 1 to the bound record's counter `name` (from 0); nothing
    without a record."""
    rec = _BOUND.get()
    if rec is not None:
        rec.counters[name] = rec.counters.get(name, 0) + 1


class Recorder:
    """An observation's records, newest last."""

    def __init__(self):
        self.seconds = collections.deque(maxlen=SECOND_RECORDS)
        self.gulps = collections.deque(maxlen=GULP_RECORDS)


# a gulp's latency by part: the children of its "gulp" span
GULP_PARTS = ("lag", "dispatch", "wait", "decode", "cluster")


def gulp_summary(gulps) -> dict:
    """What an operator reads of gulp records: their count; the p50 and
    p95 of the in-program latency (the "gulp" span), and its p95 over the
    gulps that hold an injected second and over the others; the mean ms
    of each part (GULP_PARTS); the mean stall and the mean rows handed to
    the clustering (None where no gulp has one)."""
    gulps = [g for g in gulps if g.first("gulp")]
    ms = lambda g, name: 1e3 * g.parts([name])[name]
    p = lambda v, q: float(np.percentile(v, q)) if v else None
    mean = lambda v: float(np.mean(v)) if v else None
    lat = [ms(g, "gulp") for g in gulps]
    by = {f: [ms(g, "gulp") for g in gulps if g.counters["injected"] == f]
          for f in (0, 1)}
    return {"gulps": len(gulps),
            "latency_ms_p50": p(lat, 50), "latency_ms_p95": p(lat, 95),
            "latency_ms_p95_injected": p(by[1], 95),
            "latency_ms_p95_plain": p(by[0], 95),
            "parts_ms_mean": {k: mean([ms(g, k) for g in gulps])
                              for k in GULP_PARTS},
            "stall_ms_mean": mean([ms(g, "stall") for g in gulps
                                   if g.first("stall")]),
            "cluster_rows_mean": mean([g.counters["cluster_rows"]
                                       for g in gulps
                                       if "cluster_rows" in g.counters])}


_last: Optional[Recorder] = None


def publish(recorder: Recorder) -> None:
    """The records of the observation that has just ended, kept for
    readers in this process after its pipeline is gone."""
    global _last
    _last = recorder


def last_observation() -> Optional[Recorder]:
    return _last
