"""The station driver: one run of a cell whose configuration names
"driver": "station" -- one VLITE station fed through
StationPipeline.feed_second in a closed loop.

Set-up (setup_s, from the process's start): the cell's traffic made on
the device from the seed (its generator), a StationPipeline at the
configuration's settings (no ring, no .fil, no candidate files), its
prewarm (which builds or loads the CUDA kernels), and one observation
begun and fed until its first gulp has been searched, which warms every
shape the cell uses.

The window continues that observation in a closed loop: feed_second on
the cycled seconds (observation second k is staged[k % K]), each call as
soon as the last returns, until `seconds` have elapsed, then one
synchronize.  The window is timed on the host's clock from a synchronize
to the synchronize that closes it.

What the window produced is checked afterwards (check.py): the program's
outputs of every data-second are observed where the program makes them,
through its two public DSP entry points, baseband_dsp.process_second and
baseband_dsp.twin_second (wrapped before the pipeline is built, so that
the pipeline's own program resolution picks up the wrappers; a wrapper
holds references to what the call returned, and copies nothing), and
its candidates are those feed_second returns.  A reservoir drawn from
the seed keeps one gulp of the window, and one gulp that holds an
injected burst, with the seconds that made them.

With trace, torch.profiler records a steady sub-window of PROFILED_S
data-seconds from the first data-minute that starts in the window (an
armed pair and at least two gulps); the window then lasts at least until
that sub-window is done.
"""

from __future__ import annotations

import collections
import os
import random
import sys
import time
from dataclasses import dataclass, field

from portbench import check, spec

PROFILED_S = 36
UNIX0 = 1.7e9          # the observation's first second, unix time
WORK_DIR = spec.ROOT / "build" / "portbench"
FRB_MIN_SNR = 10.0     # a recovered burst: S/N >= 10 within 10% of its DM


@dataclass
class GulpRecord:
    index: int
    start: int              # first row of the gulp (absolute)
    stop: int               # one past its last row, overlap included
    cands: list             # the program's candidates of the gulp
    crossings: int          # the program's threshold crossings count
    seconds: dict = None    # k -> the program's outputs of second k


@dataclass
class Run:
    """Everything a metric reader reads."""

    cell: spec.Cell
    setup_s: float = 0.0
    window_s: float = 0.0
    window_data_s: int = 0
    window_gulps: int = 0
    gulp_latency_s: list = field(default_factory=list)
    host_parts: dict = field(default_factory=dict)     # summed, window
    search_parts: dict = field(default_factory=dict)   # summed, window
    twin_spans: list = field(default_factory=list)
    armed_spans: list = field(default_factory=list)
    trace: dict = None
    masked_share: float = None
    memory_peak_bytes: int = 0
    attempted: int = 0
    failed: int = 0


class Recorder:
    """Wraps a DSP entry point; keeps the outputs of the last `keep`
    seconds while on."""

    def __init__(self):
        self.on = False
        self.k = 0
        self.seconds = None

    def keep(self, n: int) -> None:
        self.seconds = collections.deque(maxlen=n)

    def wrap(self, fn):
        def recorded(cfg, raw, state, arm_inject=False):
            out, new = fn(cfg, raw, state, arm_inject)
            if self.on:
                self.seconds.append((self.k, dict(
                    packed=out.packed, packed_kur=out.packed_kur,
                    weights=out.weights, bp=new.bp, bp_kur=new.bp_kur)))
                self.k += 1
            return out, new
        return recorded

    def span(self, lo: int, hi: int) -> dict:
        have = dict(self.seconds)
        missing = [k for k in range(lo, hi + 1) if k not in have]
        if missing:
            raise RuntimeError(f"seconds {missing} were not observed: the "
                               "pipeline did not run them through "
                               "process_second or twin_second")
        return {k: have[k] for k in range(lo, hi + 1)}


def _configs(cell: spec.Cell):
    from vlite_fast_tpu_torch.config import PipelineConfig, SearchConfig
    s = dict(cell.config["search"])
    s["zap_ranges"] = tuple(tuple(r) for r in s["zap_ranges"])
    return PipelineConfig(**cell.config["dsp"]), SearchConfig(**s)


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool,
        device: str, t_process: float) -> tuple:
    """(Run, check.Result) of one run of `cell` on `device`."""
    import torch
    from vlite_fast_tpu_torch.models import baseband_dsp
    from vlite_fast_tpu_torch.runtime.control import ObservationDocument
    from vlite_fast_tpu_torch.runtime.pipeline import StationPipeline

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg, scfg = _configs(cell)
    dsp_s = cell.config["dsp"]
    run = Run(cell=cell)
    rng = random.Random(seed)

    marks = [("start", t_process), ("imports", time.time())]
    staged = spec.generator(cell.traffic).staged_seconds(
        cell.traffic, dsp_s, seed, device)
    if on_card:
        sync()
        torch.cuda.reset_peak_memory_stats()
    marks.append(("traffic", time.time()))

    rows = cfg.seg_per_sec * cfg.out_samps_per_seg      # rows a second
    gulp = scfg.gulp_samps
    out_dir = WORK_DIR / "out"
    out_dir.mkdir(parents=True, exist_ok=True)
    originals = (baseband_dsp.process_second, baseband_dsp.twin_second)
    rec = Recorder()
    try:
        # wrapped before the pipeline resolves its twin program
        baseband_dsp.process_second = rec.wrap(originals[0])
        baseband_dsp.twin_second = rec.wrap(originals[1])
        pipe = StationPipeline(1, cfg, scfg, out_dir=str(out_dir),
                               keep_ring=False, write_cands=False,
                               device=device)
        overlap = pipe.search.overlap
        rec.keep((gulp + overlap - 1) // rows + 6)
        marks.append(("pipeline", time.time()))
        pipe.prewarm()
        marks.append(("prewarm", time.time()))
        pipe.begin_observation(ObservationDocument(name="PORTBENCH",
                                                   start_time=UNIX0),
                               write_fil=False)
        rec.on = True
        loop = _Loop(pipe, staged, rows, gulp, overlap, cfg, rng, rec)
        while loop.gulps == 0:
            loop.feed(in_window=False)
        sync()
        marks.append((f"{loop.k} warm seconds", time.time()))
        run.setup_s = time.time() - t_process
        print("set-up: " + ", ".join(
            f"{name} {b - a:.3f} s" for (_, a), (name, b)
            in zip(marks, marks[1:])), file=sys.stderr, flush=True)

        k0 = loop.k
        host0 = {p: sum(v) for p, v in pipe.host_seconds.items()}
        search0 = dict(pipe.search.host_seconds)
        # feed_seconds holds every second of the observation, in order
        n_twin0 = sum(1 for k in range(k0) if not loop.armed(k))
        n_armed0 = k0 - n_twin0
        prof = _Profiler(k0) if trace else None
        t0 = time.perf_counter()
        while True:
            if prof:
                prof.before(loop.k)
            loop.feed(in_window=True)
            if prof:
                prof.after(loop.k - 1, sync)
            if time.perf_counter() - t0 >= seconds and (
                    prof is None or prof.done):
                break
        sync()
        run.window_s = time.perf_counter() - t0
        run.window_data_s = loop.k - k0
        if on_card:
            run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
        run.window_gulps = loop.window_gulps
        run.gulp_latency_s = loop.latency
        run.host_parts = {p: sum(v) - host0[p]
                          for p, v in pipe.host_seconds.items()}
        run.search_parts = {p: v - search0[p]
                            for p, v in pipe.search.host_seconds.items()}
        run.attempted, run.failed = loop.attempted, loop.failed
        pipe.end_observation()
        n_twin1 = n_twin0 + sum(1 for k in range(k0, loop.k)
                                if not loop.armed(k))
        run.twin_spans = pipe.feed_seconds["twin"][n_twin0:n_twin1]
        run.armed_spans = pipe.feed_seconds["armed"][
            n_armed0:n_armed0 + (run.window_data_s - len(run.twin_spans))]
        kept = list({g.index: g for g in (loop.keep_any, loop.keep_frb)
                     if g is not None}.values())
        if prof:
            run.trace = prof.analyse()
    finally:
        baseband_dsp.process_second, baseband_dsp.twin_second = originals
    del pipe, rec, loop
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    result = check.check(cell, staged, kept, rows)
    print(f"check: {time.perf_counter() - t:.1f} s", file=sys.stderr,
          flush=True)
    run.masked_share = result.masked_share
    print(f"portbench: window {run.window_s:.3f} s, {run.window_data_s} "
          f"data-seconds, {run.window_gulps} gulps, {len(run.twin_spans)} "
          f"twin and {len(run.armed_spans)} armed spans; set-up "
          f"{run.setup_s:.3f} s; {result.gulps} gulps compared, masked "
          f"share {result.masked_share}; bursts {run.attempted} attempted, "
          f"{run.failed} failed", file=sys.stderr, flush=True)
    return run, result


class _Loop:
    """feed_second in order, with the clocks and reservoirs of the
    window."""

    def __init__(self, pipe, staged, rows, gulp, overlap, cfg, rng, rec):
        from vlite_fast_tpu_torch.models import baseband_dsp
        self.pipe, self.staged, self.rows = pipe, staged, rows
        self.gulp, self.overlap, self.cfg, self.rng = gulp, overlap, cfg, rng
        self.rec = rec
        self.k = 0
        self.gulps = 0
        self.window_gulps = 0
        self.frb_gulps = 0
        self.t_start = {}
        self.latency = []
        self.keep_any = self.keep_frb = None
        self.attempted = self.failed = 0
        self.nwin = (baseband_dsp.inject_window_seconds(cfg)
                     if cfg.inject_frb else 0)

    def armed(self, k: int) -> bool:
        return self.cfg.inject_frb and k % 60 < self.nwin

    def feed(self, in_window: bool) -> None:
        k = self.k
        t0 = time.perf_counter()
        cands = self.pipe.feed_second(UNIX0 + k,
                                      self.staged[k % len(self.staged)])
        t1 = time.perf_counter()
        self.t_start[k] = t0
        self.t_start.pop(k - 64, None)
        self.k += 1
        n = int(self.pipe.metrics.get("vfast_gulps_searched"))
        for g in range(self.gulps, n):
            self._gulp(g, cands, t1, in_window)
        self.gulps = n

    def _gulp(self, g: int, cands: list, t_return: float,
              in_window: bool) -> None:
        start = g * self.gulp
        stop = start + self.gulp + self.overlap
        mine = [c for c in cands if start <= c.peak_idx < start + self.gulp]
        tsamp = self.cfg.tsamp
        first = -(-start // (60 * self.rows)) * 60
        arms = tuple(a for a in range(first, (stop - 1) // self.rows + 1, 60)
                     if self.cfg.inject_frb and a * self.rows
                     < start + self.gulp)
        if not in_window:
            return
        self.window_gulps += 1
        last = (stop - 1) // self.rows
        if last in self.t_start:
            self.latency.append(t_return - self.t_start[last])
        for a in arms:
            self.attempted += 1
            dm = self.cfg.inject_dm
            if not any(abs(c.dm - dm) <= 0.1 * dm and c.snr >= FRB_MIN_SNR
                       and abs(c.peak_idx * tsamp - a) <= 1.0 for c in mine):
                self.failed += 1
        rec = lambda: GulpRecord(
            index=g, start=start, stop=stop, cands=mine,
            crossings=int(self.pipe.metrics.get("vfast_gulp_crossings")),
            seconds=self.rec.span(start // self.rows, last))
        if self.rng.random() * self.window_gulps < 1.0:
            self.keep_any = rec()
        if arms:
            self.frb_gulps += 1
            if self.rng.random() * self.frb_gulps < 1.0:
                self.keep_frb = rec()


class _Profiler:
    """torch.profiler over data-seconds [a, a + PROFILED_S), a the first
    data-minute's start at or after the window's first second."""

    def __init__(self, k0: int):
        self.a = -(-k0 // 60) * 60
        self.prof = self.rng = None   # the profiler and its window range
        self.done = False
        self.path = WORK_DIR / "trace.json"

    def before(self, k: int) -> None:
        if k == self.a:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self.rng = torch.profiler.record_function("portbench.window")
            self.rng.__enter__()

    def after(self, k: int, sync) -> None:
        if k == self.a + PROFILED_S - 1:
            sync()
            self.rng.__exit__(None, None, None)
            self.prof.__exit__(None, None, None)
            self.done = True

    def analyse(self) -> dict:
        from portbench import trace
        self.prof.export_chrome_trace(str(self.path))
        try:
            return trace.analyse(self.path)
        finally:
            os.remove(self.path)
