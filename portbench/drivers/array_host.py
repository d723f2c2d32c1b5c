"""The host driver: one run of a cell whose configuration names
"driver": "array_host" -- an array host in real time through the
program's normal path, runtime/pipeline.ArrayPipeline.run_streaming: N
StationPipelines, each with its voltage ring, the coadd of their rows
searched (CoaddSearcher), the coincidencer, trig.make_triggers and the
TriggeredDumpers.

Set-up (setup_s, from the process's start): each antenna's staged
seconds made from the seed (the traffic's generator, on the device) and
held on the host, the ArrayPipeline made (its rings with it) and
prewarmed, and the observation begun and fed as fast as it takes the data
up to data-second WINDOW_K0, the top of its second data-minute, or for at
most WARM_MAX_S of feeding: a program slower than that starts its window
earlier, and meets no burst in it.

The window continues that observation in an open loop from there: the
second data-minute's burst, armed at its first second, is searched in
the window, and its trigger raised and its dumps queued in it
(production geometry: the burst's gulp 5, data-seconds 60-81, searched
once 81 is in; the trigger raised at the coincidence after 88
data-seconds; gulp 6, 72-93, searched after its dumps); the run is not
correct without both.  The wire's clock starts, and every wall second
each antenna's next data-second becomes due, all antennas aligned;
run_streaming asks for each second in turn, and the first antenna's
second of each data-second is handed over when it is due (at once when
the host lags).  The window lasts `seconds`, and at least WINDOW_MIN_S,
so that three gulp rounds fall in it; no data-second is due after it,
and once the window is over no further data-second is fed: the
data-second in progress ends, then run_streaming's end (each station's
last drain and flush gulp, the coadd's flush, the last coincidence).

Each station's feed_second and the array's coincidence are wrapped (on the
objects, before run_streaming runs) to time them and to see which gulps a
call searched.  A gulp (every beam's and the coadd's) is due when the
data-second after its last one is due: it is attempted when that falls in
the window, and failed when it was not searched by the window's end, or
when its candidates came back after the wire had overwritten its first
data-second in a ring of ring_seconds.  Its latency is the time from the
wire time its last data-second was due to the return of the call that
searched it.  The lag of a data-second is how long after its due time its
first antenna's second was handed over; late_seconds counts those more
than a second late.

What the run produced is checked afterwards (check_host.py): the drawn
antenna's outputs of its seconds are observed where the program makes
them, through its DSP entry points baseband_dsp.process_second and
twin_second (wrapped before the pipeline is built; a wrapper holds
references to what the call returned, and copies nothing), every
antenna's rows of the drawn gulp too; the beam's and the coadd's
candidates are those the normal path returns; the dumps and triggers are
run_streaming's.

With trace, torch.profiler records the whole window.
"""

from __future__ import annotations

import collections
import itertools
import os
import shutil
import signal
import sys
import time
from dataclasses import dataclass, field

from portbench import check_host, spec

WINDOW_MIN_S = 36
WINDOW_K0 = 60         # the window's first data-second, where a burst is armed
WARM_MAX_S = 60.0      # the longest the set-up feeds before the window
UNIX0 = 1.7e9          # the observation's first second, unix time
WORK_DIR = spec.ROOT / "build" / "portbench"
LATE_S = 1.0           # a data-second handed over later than this is late
STATION_PARTS = ("ring", "staging", "program", "copy", "wait", "drain",
                 "search")


@dataclass
class Run:
    """Everything a metric reader reads."""

    cell: spec.Cell
    setup_s: float = 0.0
    window_s: float = 0.0
    window_data_s: int = 0          # data-seconds of each antenna fed
    gulp_latency_s: list = field(default_factory=list)
    second_s: list = field(default_factory=list)    # a data-second's wall
    lag_s: list = field(default_factory=list)
    late_seconds: int = 0
    window_gulps: int = 0       # every beam's and the coadd's, searched
    search_parts: dict = field(default_factory=dict)   # summed, window
    ring_s: list = field(default_factory=list)      # a station-second's
    coadd_sum_s: list = field(default_factory=list)  # a data-second's
    trace: dict = None
    masked_share: float = None
    memory_peak_bytes: int = 0
    attempted: int = 0
    failed: int = 0


class OpenLoop:
    """The wire's clock: once started at data-second k0, data-second
    k0 + j is due at t0 + j; the window ends at t0 + `window_s`."""

    def __init__(self, window_s: float, clock=time.perf_counter,
                 sleep=time.sleep):
        self.window_s = window_s
        self.clock, self.sleep = clock, sleep
        self.t0 = self.k0 = self.t_end = None
        self.lag = []           # each window data-second's lag, in order

    @property
    def started(self) -> bool:
        return self.t0 is not None

    def start(self, k: int) -> None:
        self.t0, self.k0 = self.clock(), k
        self.t_end = self.t0 + self.window_s

    def due(self, k: int) -> float:
        return self.t0 + (k - self.k0)

    def wait(self, k: int) -> bool:
        """Before data-second k is handed over: False once no more is
        due in the window or the window is over; else waits until k is
        due and records its lag."""
        due, now = self.due(k), self.clock()
        if due >= self.t_end or now >= self.t_end:
            return False
        if now < due:
            self.sleep(due - now)
            now = self.clock()
        self.lag.append(now - due)
        return True

    @property
    def late(self) -> int:
        return sum(x > LATE_S for x in self.lag)

    def tally(self, searched: dict, nstreams: int, span,
              ring_seconds: int) -> tuple:
        """(attempted, failed, latencies) of the gulps of `nstreams`
        streams: `searched` maps (stream, gulp) to the time the call that
        searched it returned; `span(g)` gives gulp g's first and last
        data-seconds."""
        attempted = failed = 0
        lat = []
        for s in range(nstreams):
            for g in itertools.count():
                first, last = span(g)
                if self.due(last + 1) >= self.t_end:
                    break
                if last + 1 < self.k0:
                    continue
                attempted += 1
                t = searched.get((s, g))
                if t is not None and t <= self.t_end:
                    lat.append(t - self.due(last))
                if t is None or t > min(self.t_end,
                                        self.due(first + ring_seconds)):
                    failed += 1
        return attempted, failed, lat


class _Outputs:
    """Wraps a DSP entry point; keeps, while on, the outputs of the last
    `keep` station-seconds by (station index, second), and those of the
    first second of station `ant`."""

    def __init__(self, keep: int, ant: int):
        self.on = False
        self.current = None     # (station index, second) being fed
        self.recent = collections.OrderedDict()
        self.keep, self.ant = keep, ant
        self.first = {}

    def wrap(self, fn):
        def recorded(cfg, raw, state, arm_inject=False):
            out, new = fn(cfg, raw, state, arm_inject)
            if self.on and self.current is not None:
                o = dict(packed=out.packed, packed_kur=out.packed_kur,
                         weights=out.weights, bp=new.bp, bp_kur=new.bp_kur)
                self.recent[self.current] = o
                while len(self.recent) > self.keep:
                    self.recent.popitem(last=False)
                if self.current == (self.ant, 0):
                    self.first[0] = o
            return out, new
        return recorded

    def rows(self, i: int, first: int, last: int, start: int, stop: int,
             nrows: int):
        """Station i's packed rows [start, stop) of seconds first..last."""
        import torch
        missing = [k for k in range(first, last + 1)
                   if (i, k) not in self.recent]
        if missing:
            raise RuntimeError(f"station {i}'s seconds {missing} were not "
                               "observed through process_second or "
                               "twin_second")
        cat = torch.cat([self.recent[(i, k)]["packed_kur"]
                         for k in range(first, last + 1)])
        return cat[start - first * nrows:stop - first * nrows]


def _configs(cell: spec.Cell):
    from vlite_fast_tpu_torch.config import (AntennaConfig, ArrayConfig,
                                             PipelineConfig, SearchConfig)
    s = dict(cell.config["search"])
    s["zap_ranges"] = tuple(tuple(r) for r in s["zap_ranges"])
    arr = cell.config["array"]
    return ArrayConfig(
        antennas=tuple(AntennaConfig(i + 1, f"ea{i + 1:02d}")
                       for i in range(arr["nant"])),
        pipeline=PipelineConfig(**cell.config["dsp"]),
        search=SearchConfig(**s))


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool,
        device: str, t_process: float, window_min_s: float = WINDOW_MIN_S,
        window_k0: int = WINDOW_K0) -> tuple:
    """(Run, check_host.Result) of one run of `cell` on `device`."""
    import torch
    from vlite_fast_tpu_torch.models import baseband_dsp
    from vlite_fast_tpu_torch.runtime.pipeline import (ArrayPipeline,
                                                       ObservationDocument)

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    acfg = _configs(cell)
    cfg, scfg = acfg.pipeline, acfg.search
    arr = cell.config["array"]
    nant = acfg.nant
    run = Run(cell=cell)
    rng, ant = check_host.draw(seed, nant)
    marks = [("start", t_process), ("imports", time.time())]

    gen = spec.generator(cell.traffic)
    staged, ant_staged = {}, None
    for i, a in enumerate(acfg.antennas):
        secs = gen.staged_seconds(cell.traffic, cell.config["dsp"], seed,
                                  device, antenna=i)
        staged[a.station_id] = [s.cpu().numpy() for s in secs]
        if i == ant:
            ant_staged = secs
        del secs
    marks.append(("traffic", time.time()))

    rows = cfg.seg_per_sec * cfg.out_samps_per_seg      # rows a second
    gulp = scfg.gulp_samps
    out_dir = WORK_DIR / "host_out"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    originals = (baseband_dsp.process_second, baseband_dsp.twin_second)
    loop = OpenLoop(max(float(seconds), window_min_s))
    ap = None
    # a run stopped by SIGTERM (a time limit) still closes its pipeline,
    # whose rings hold 8 GB of /dev/shm each
    sigterm = signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    try:
        ap = _pipeline(ArrayPipeline, acfg, str(out_dir), device,
                       arr["ring_seconds"])
        overlap = ap.stations[0].search.overlap
        span = lambda g: (g * gulp // rows, (g * gulp + gulp + overlap - 1)
                          // rows)
        outs = _Outputs(nant * (span(0)[1] - span(0)[0] + 8), ant)
        baseband_dsp.process_second = outs.wrap(originals[0])
        baseband_dsp.twin_second = outs.wrap(originals[1])
        marks.append(("pipeline and rings", time.time()))
        ap.prewarm()
        marks.append(("prewarm", time.time()))
        feeds = _Feeds(ap, outs, gulp, overlap, rows, span, rng, ant,
                       window_k0 * rows // gulp)
        prof = _Profiler() if trace else None
        stop = {"t": None}
        search_parts = {}
        t_warm = time.time()

        def begin_round(k: int) -> bool:
            """Station 0 is about to be asked for data-second k."""
            if not loop.started:
                if (k < window_k0 or not feeds.all_searched()) \
                        and time.time() - t_warm < WARM_MAX_S:
                    return True
                sync()
                marks.append((f"{k} warm seconds", time.time()))
                run.setup_s = time.time() - t_process
                print("set-up: " + ", ".join(
                    f"{name} {b - a:.3f} s" for (_, a), (name, b)
                    in zip(marks, marks[1:])), file=sys.stderr, flush=True)
                if on_card:
                    torch.cuda.reset_peak_memory_stats()
                if prof:
                    prof.start()
                loop.start(k)
                feeds.window(loop)
                search_parts[0] = _search_seconds(ap)
            if loop.wait(k):
                feeds.round_start(k, loop.clock())
                return True
            sync()
            stop["t"] = loop.clock()
            search_parts[1] = _search_seconds(ap)
            print(f"portbench: host memory at the window's end: "
                  f"{_host_memory()}", file=sys.stderr, flush=True)
            if on_card:
                run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
            if prof:
                prof.stop(sync)
            return False

        ended = {"flag": False}

        def seconds_of(i: int, sid: int):
            for k in itertools.count():
                if i == 0 and not ended["flag"] and not begin_round(k):
                    ended["flag"] = True
                if ended["flag"]:
                    return
                yield UNIX0 + k, staged[sid][k % len(staged[sid])]

        outs.on = True
        res = ap.run_streaming(
            {a.station_id: seconds_of(i, a.station_id)
             for i, a in enumerate(acfg.antennas)},
            ObservationDocument(name="PORTBENCH_HOST", start_time=UNIX0),
            **_stream_args(ap, arr))
        outs.on = False
        sync()
        t_end = time.perf_counter()
        run.window_s = stop["t"] - loop.t0
        run.window_data_s = len(loop.lag)
        run.lag_s, run.late_seconds = list(loop.lag), loop.late
        run.second_s = feeds.second_s
        run.attempted, run.failed, run.gulp_latency_s = loop.tally(
            feeds.searched, nant + (ap.coadd is not None), span,
            arr["ring_seconds"])
        run.window_gulps = sum(t <= stop["t"]
                               for t in feeds.searched.values())
        run.search_parts = {p: v - search_parts[0][p]
                            for p, v in search_parts[1].items()}
        window_recs = lambda recs: [r for r in recs
                                    if loop.t0 <= r.start < stop["t"]]
        parts = collections.defaultdict(list)
        for st in ap.stations:
            for r in window_recs(st.records.seconds):
                for p, v in r.parts(STATION_PARTS).items():
                    parts[p].append(v)
        run.ring_s = parts["ring"]
        co_recs = window_recs(getattr(ap.coadd, "records", ()))
        run.coadd_sum_s = [r.parts(["sum"])["sum"] for r in co_recs]
        if prof:
            run.trace = prof.analyse()
        _log_breakdown(ap, parts, co_recs, feeds, loop, run, t_end)
        kept = [k for k in (feeds.burst, feeds.kept) if k is not None]
        dumps_bad = check_host.dump_mismatch(
            res["dumps"], staged, UNIX0, res["triggers"], cfg.inject_dm)
        trig_gap = check_host.trigger_gap(check_host.in_window(
            res["triggers"], res["trigger_seconds"], loop.k0,
            run.window_data_s), cfg.inject_dm)
        print(f"portbench: window data-seconds {loop.k0}.."
              f"{loop.k0 + run.window_data_s - 1}; the burst's gulp "
              f"{feeds.burst_g} searched in the window: "
              f"{feeds.burst is not None}", file=sys.stderr, flush=True)
        for t, at in zip(res["triggers"], res["trigger_seconds"]):
            print(f"portbench: trigger DM {t.dm:.2f} S/N {t.sn:.2f} window "
                  f"[{t.t0 - UNIX0:.3f}, {t.t1 - UNIX0:.3f}] s ({t.meta}), "
                  f"raised after {at} data-seconds", file=sys.stderr,
                  flush=True)
        print(f"portbench: {len(res['dumps'])} dumps, "
              f"{sum(d.nbytes for d in res['dumps'])} bytes, seconds "
              f"{sorted({s for d in res['dumps'] for s in d.seconds})}",
              file=sys.stderr, flush=True)
    finally:
        baseband_dsp.process_second, baseband_dsp.twin_second = originals
        if ap is not None:
            ap.close()
        shutil.rmtree(out_dir, ignore_errors=True)
        signal.signal(signal.SIGTERM, sigterm)
    del ap, feeds, outs, staged
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    result = check_host.check(cell, ant_staged, kept,
                              dumps_bad, trig_gap)
    print(f"check: {time.perf_counter() - t:.1f} s", file=sys.stderr,
          flush=True)
    run.masked_share = result.masked_share
    print(f"portbench: window {run.window_s:.3f} s, {run.window_data_s} "
          f"data-seconds of {nant} antennas, lag p95 "
          f"{_pct(run.lag_s, 95):.3f} s, {run.late_seconds} late; set-up "
          f"{run.setup_s:.3f} s; gulps {[k.gulp for k in kept]} of "
          f"antenna {ant} compared, masked share {result.masked_share}; "
          f"gulps {run.attempted} attempted, {run.failed} failed",
          file=sys.stderr, flush=True)
    return run, result


def _pipeline(cls, acfg, out_dir: str, device, ring_seconds: int):
    """The ArrayPipeline with rings of `ring_seconds`; a program whose
    ArrayPipeline takes no ring depth has its rings made again at it."""
    import inspect
    if "ring_seconds" in inspect.signature(cls).parameters:
        return cls(acfg, out_dir=out_dir, device=device,
                   ring_seconds=ring_seconds)
    from vlite_fast_tpu_torch.runtime.ring import RingBuffer
    ap = cls(acfg, out_dir=out_dir, device=device)
    for st in ap.stations:
        name, bufsz = st.ring.name, st.ring.bufsz
        st.ring.close()
        st.ring = RingBuffer(name, bufsz=bufsz, nbufs=ring_seconds,
                             create=True)
    return ap


def _stream_args(ap, arr: dict) -> dict:
    """run_streaming's settings: the coincidence period, and the .fil
    where it takes the choice."""
    import inspect
    kw = {"coincide_every_s": arr["coincide_every_s"]}
    if "write_fil" in inspect.signature(ap.run_streaming).parameters:
        kw["write_fil"] = arr["write_fil"]
    return kw


def _search_seconds(ap) -> dict:
    """The host's seconds of every beam's and the coadd's gulp searches so
    far, by part (SinglePulseSearch.host_seconds), summed."""
    out = collections.Counter()
    for se in [st.search for st in ap.stations] + (
            [ap.coadd.search] if ap.coadd is not None else []):
        out.update(se.host_seconds)
    return dict(out)


def _host_memory() -> str:
    """This process's memory, in GB: what /proc/self/status gives of its
    resident set (VmRSS, its peak VmHWM, the shared pages RssShmem), and
    its peak resident set by getrusage."""
    import resource
    got = {}
    try:
        with open("/proc/self/status") as fp:
            for ln in fp:
                k, _, v = ln.partition(":")
                if k in ("VmRSS", "VmHWM", "RssShmem") and v.split():
                    got[k] = int(v.split()[0]) / 1e6
    except OSError:
        pass
    got["ru_maxrss"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 1e6
    return ", ".join(f"{k} {v:.2f}" for k, v in got.items())


def _pct(v: list, q: float) -> float:
    import numpy as np
    return float(np.percentile(v, q)) if v else float("nan")


class _Feeds:
    """Each station's feed_second and the array's coincidence, wrapped on
    the objects: the calls' times, the gulps each searched, and the kept
    gulps: the burst's (burst_g, which holds the window's first second)
    and one drawn from the seed over the window's others (a reservoir)."""

    def __init__(self, ap, outs, gulp, overlap, rows, span, rng, ant,
                 burst_g):
        self.ap, self.outs = ap, outs
        self.gulp, self.overlap, self.rows, self.span = (gulp, overlap,
                                                         rows, span)
        self.rng, self.ant = rng, ant
        self.n = len(ap.stations)
        self.searched = {}          # (stream, gulp) -> its call's return
        self.gulps = [0] * (self.n + 1)     # stream n: the coadd
        self.ncands = 0
        self.results = {}           # gulp -> {stream: (cands, crossings)}
        self.loop = None
        self.second_s = []
        self.coincide_s = []
        self.kept = self.burst = None
        self.burst_g = burst_g
        self.nkept = 0
        self._round = None
        for i, st in enumerate(ap.stations):
            st.feed_second = self._wrap(i, st, st.feed_second)
        co = ap._coincide_and_dump

        def coincide(*a, **kw):
            t = time.perf_counter()
            out = co(*a, **kw)
            if self.loop is not None:
                self.coincide_s.append(time.perf_counter() - t)
            return out
        ap._coincide_and_dump = coincide

    def window(self, loop) -> None:
        self.loop = loop

    def round_start(self, k: int, t: float) -> None:
        self._round = (k, t)

    def all_searched(self) -> bool:
        return min(self.gulps) >= 1

    def _wrap(self, i, st, fn):
        def fed(sec, buf):
            k = int(round(sec - UNIX0))
            self.outs.current = (i, k)
            cands = fn(sec, buf)
            t = time.perf_counter()
            self.outs.current = None
            self._after(i, st, k, t, cands)
            return cands
        return fed

    def _mine(self, g, cands):
        lo = g * self.gulp
        return [c for c in cands if lo <= c.peak_idx < lo + self.gulp]

    def _after(self, i, st, k, t, cands) -> None:
        n = int(st.metrics.get("vfast_gulps_searched"))
        for g in range(self.gulps[i], n):
            self._searched(i, g, t, self._mine(g, cands), int(
                st.metrics.get("vfast_gulp_crossings")))
        self.gulps[i] = n
        co = self.ap.coadd
        if co is not None:
            new = co.cands[self.ncands:]
            self.ncands = len(co.cands)
            for g in range(self.gulps[self.n], co.gulps):
                self._searched(self.n, g, t, self._mine(g, new), int(
                    co.search.last_gulp_stats["n_crossings"]))
            self.gulps[self.n] = co.gulps
        if i == self.n - 1 and self.loop is not None \
                and self._round is not None:
            self.second_s.append(t - self._round[1])
            self._round = None

    def _searched(self, stream, g, t, cands, crossings) -> None:
        """Gulp g of `stream` was searched by a call that returned at t:
        kept for the check when searched in the window and the burst's or
        drawn among the window's others."""
        if self.loop is None:
            return
        self.searched[(stream, g)] = t
        if stream not in (self.ant, self.n):
            return
        got = self.results.setdefault(g, {})
        got[stream] = (cands, crossings)
        if len(got) < 2:
            return
        del self.results[g]
        if g != self.burst_g:
            self.nkept += 1
            if self.rng.random() * self.nkept >= 1.0:
                return
        first, last = self.span(g)
        start = g * self.gulp
        stop = start + self.gulp + self.overlap
        # the burst's gulp: its armed first second
        sec = first if g == self.burst_g else self.rng.randrange(first,
                                                                 last + 1)
        seconds = dict(self.outs.first)
        seconds[sec] = self.outs.recent[(self.ant, sec)]
        kept = check_host.Kept(
            gulp=g, start=start, ant=self.ant, seconds=seconds,
            rows=[self.outs.rows(a, first, last, start, stop, self.rows)
                  for a in range(self.n)],
            beam_cands=got[self.ant][0], beam_crossings=got[self.ant][1],
            coadd_cands=got[self.n][0], coadd_crossings=got[self.n][1],
            burst=g == self.burst_g)
        if g == self.burst_g:
            self.burst = kept
        else:
            self.kept = kept


def _log_breakdown(ap, parts, co_recs, feeds, loop, run, t_end) -> None:
    """Where a window data-second went, on standard error."""
    import numpy as np
    med = lambda v: 1e3 * float(np.median(v)) if len(v) else float("nan")
    station = ", ".join(f"{p} {med(v):.2f}" for p, v in parts.items())
    if co_recs:
        co = {p: med([r.parts([p])[p] for r in co_recs])
              for p in ("sum", "search")}
        coadd = (f"coadd host ms a data-second (median): sum "
                 f"{co['sum']:.3f}, search {co['search']:.3f}")
    else:
        hs = getattr(ap.coadd, "host_seconds", {})
        nsec = max(len(ap.stations[0].records.seconds), 1)
        coadd = ("coadd host ms a data-second over the observation: "
                 + ", ".join(f"{p} {1e3 * v / nsec:.2f}"
                             for p, v in hs.items()))
    print(f"portbench: a window data-second: {med(run.second_s):.1f} ms "
          f"median of {len(run.second_s)} (p95 "
          f"{1e3 * _pct(run.second_s, 95):.1f}); lag median "
          f"{med(run.lag_s):.1f} ms, max "
          f"{1e3 * max(run.lag_s, default=0):.1f}; host ms a station-second "
          f"(median): {station}; {coadd}; coincidence and dumps ms (median, "
          f"max): {med(feeds.coincide_s):.2f}, "
          f"{1e3 * max(feeds.coincide_s, default=0):.2f}; run_streaming's end "
          f"{t_end - loop.t_end:.3f} s after the window's", file=sys.stderr,
          flush=True)
    slow = [(loop.k0 + j, round(lag, 3), round(wall, 3)) for j, (lag, wall)
            in enumerate(zip(run.lag_s, run.second_s))
            if lag > 0.25 or wall > 0.5]
    print(f"portbench: window data-seconds with a lag over 0.25 s or a wall "
          f"over 0.5 s (second, lag s, wall s): {slow}", file=sys.stderr,
          flush=True)


class _Profiler:
    """torch.profiler over the window."""

    def __init__(self):
        self.prof = self.rng = None   # the profiler and its window range
        self.path = WORK_DIR / "trace_host.json"

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.rng = torch.profiler.record_function("portbench.window")
        self.rng.__enter__()

    def stop(self, sync) -> None:
        sync()
        self.rng.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def analyse(self) -> dict:
        from portbench import trace
        WORK_DIR.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        try:
            return trace.analyse(self.path)
        finally:
            os.remove(self.path)
