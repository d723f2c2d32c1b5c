"""The array driver: one run of a cell whose configuration names
"driver": "array_step" -- the sharded array step on one card, through
its normal path: parallel/sharded_pipeline.build_array_step on a 1x1
parallel/mesh.make_mesh (a one-rank NCCL group on a card, gloo on the
CPU), then gather_step_output, then extract_candidates, each call.

Set-up (setup_s, from the process's start): the process group and the
mesh, the step built at the configuration's "array" settings, one call's
raw voltages of every antenna made on the device in the step's own
(nant, npol, nsec * rate) buffer (the traffic's generator), and the
observation's first call run from zero bandpasses with no history, which
seeds every antenna's bandpass and warms every shape.

The window continues that observation in a closed loop: whole calls on
the same buffer with the bandpasses and the packed tail carried, each
issued as soon as the last call's candidates are extracted, until
`seconds` have elapsed.  It is timed on the host's clock from a
synchronize to the end of its last call's extraction (whose gather waits
for the card).  A call is attempted; it failed where the coadd's
candidates miss the burst: none within 10% of its DM at S/N >= 10 and
within a second of its arrival.

Each call is a span record of the program (utils/spans, layer "call")
where the step takes one (`record`), else nothing is recorded and the
readers of the records read no value; the host range vfast.array_call
holds each call.  What the window produced is checked afterwards
(check_array.py): the outputs of the drawn antenna's drawn second and
injected second are observed where the program makes them, through its
public DSP entry point baseband_dsp.process_second (wrapped before the
step is built; the wrapper holds references to what the call returned
and copies nothing); the call's rows, crossings counts and candidates
are those the normal path returns.

With trace, torch.profiler records the window's second call; the window
then lasts at least until that call is done.
"""

from __future__ import annotations

import inspect
import os
import sys
import time
from dataclasses import dataclass, field

from portbench import check_array, spec

WORK_DIR = spec.ROOT / "build" / "portbench"
FRB_MIN_SNR = 10.0     # a recovered burst: S/N >= 10 within 10% of its DM
PROFILED_CALL = 2      # the window's second call (call 0 is the set-up's)


@dataclass
class Run:
    """Everything a metric reader reads."""

    cell: spec.Cell
    setup_s: float = 0.0
    window_s: float = 0.0
    window_data_s: int = 0      # antenna-seconds the window's calls fed
    window_calls: int = 0
    calls: list = field(default_factory=list)   # their span records
    trace: dict = None
    masked_share: float = None
    memory_peak_bytes: int = 0
    attempted: int = 0
    failed: int = 0


class _Seconds:
    """Wraps process_second; keeps, while on, antenna `ant`'s outputs of
    the call's seconds `secs` (the step runs each antenna's seconds in
    turn, so that is the step's call number ant * nsec + s)."""

    def __init__(self, ant: int, secs: set, nsec: int):
        self.want = {ant * nsec + s: s for s in secs}
        self.on = False
        self.start()

    def start(self) -> None:
        self.i = 0
        self.got = {}

    def wrap(self, fn):
        def recorded(cfg, raw, state, arm_inject=False):
            out, new = fn(cfg, raw, state, arm_inject)
            if self.on:
                s = self.want.get(self.i)
                if s is not None:
                    self.got[s] = dict(
                        packed=out.packed, packed_kur=out.packed_kur,
                        weights=out.weights, bp=new.bp, bp_kur=new.bp_kur)
                self.i += 1
            return out, new
        return recorded


def _array_config(cell: spec.Cell):
    from vlite_fast_tpu_torch.config import (AntennaConfig, ArrayConfig,
                                             PipelineConfig, SearchConfig)
    s = dict(cell.config["search"])
    s["zap_ranges"] = tuple(tuple(r) for r in s["zap_ranges"])
    arr = cell.config["array"]
    return ArrayConfig(
        antennas=tuple(AntennaConfig(i + 1, f"ea{i + 1:02d}")
                       for i in range(arr["nant"])),
        pipeline=PipelineConfig(**cell.config["dsp"]),
        search=SearchConfig(**s),
        mesh_ant=arr["mesh_ant"], mesh_time=arr["mesh_time"])


def _takes_record(fn) -> bool:
    """Whether the program's `fn` keeps a span record (not before the
    array step's call records came)."""
    return "record" in inspect.signature(fn).parameters


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool,
        device: str, t_process: float) -> tuple:
    """(Run, check_array.Result) of one run of `cell` on `device`."""
    import torch
    import torch.distributed as dist
    from vlite_fast_tpu_torch.models import baseband_dsp
    from vlite_fast_tpu_torch.parallel import sharded_pipeline as sp
    from vlite_fast_tpu_torch.parallel.distributed import init_distributed
    from vlite_fast_tpu_torch.parallel.mesh import make_mesh

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    acfg = _array_config(cell)
    cfg, scfg = acfg.pipeline, acfg.search
    arr = cell.config["array"]
    nsec, inject_sec = arr["nsec_per_call"], arr["inject_sec"]
    run = Run(cell=cell)
    rng, ant, sec = check_array.draw(seed, acfg.nant, nsec)
    marks = [("start", t_process), ("imports", time.time())]

    original = baseband_dsp.process_second
    secs = _Seconds(ant, {sec, inject_sec}, nsec)
    init_distributed(device=device)
    try:
        baseband_dsp.process_second = secs.wrap(original)
        mesh = make_mesh(n_ant=arr["mesh_ant"], n_time=arr["mesh_time"])
        step_fn, _, _, info = sp.build_array_step(
            acfg, mesh, nsec_per_call=nsec, inject_sec=inject_sec)
        recorded = _takes_record(step_fn)
        raw = torch.empty((info.m, cfg.npol_in, nsec * cfg.sample_rate),
                          dtype=torch.uint8, device=mesh.device)
        spec.generator(cell.traffic).fill_call(cell.traffic, raw,
                                               cfg.sample_rate, seed)
        sync()
        marks.append(("traffic and step", time.time()))
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        bp = torch.zeros((info.m, cfg.npol_in, cfg.nchan),
                         dtype=torch.float32, device=mesh.device)
        loop = _Loop(sp, step_fn, raw, mesh, info, scfg, recorded,
                     (bp, bp.clone(), None))
        loop.call(0)                # seeds the bandpasses, warms the shapes
        sync()
        marks.append(("first call", time.time()))
        run.setup_s = time.time() - t_process
        print("set-up: " + ", ".join(
            f"{name} {b - a:.3f} s" for (_, a), (name, b)
            in zip(marks, marks[1:])), file=sys.stderr, flush=True)

        prof = _Profiler() if trace else None
        secs.on = True
        t0 = time.perf_counter()
        k = 0
        while True:
            k += 1
            secs.start()
            if prof and k == PROFILED_CALL:
                prof.start()
            prev = loop.full
            rec, per_beam, coadd = loop.call(k)
            if prof and k == PROFILED_CALL:
                prof.stop(sync)
            run.calls.extend([rec] if rec is not None else [])
            run.attempted += 1
            t_frb = k * nsec + inject_sec      # the burst's arrival, s
            dm = cfg.inject_dm
            if not any(abs(c.dm - dm) <= 0.1 * dm and c.snr >= FRB_MIN_SNR
                       and abs(c.peak_idx * cfg.tsamp - t_frb) <= 1.0
                       for c in coadd):
                run.failed += 1
            if rng.random() * k < 1.0:
                full = loop.full
                kept = check_array.Kept(
                    call=k, ant=ant, seconds=dict(secs.got),
                    rows=full.packed_kur,
                    tail=prev.packed_kur[:, info.T - info.halo:],
                    beam_cands=per_beam.get(ant, []),
                    beam_crossings=int(full.beam_topk[0, ant, 0, -1]),
                    coadd_cands=coadd,
                    coadd_crossings=int(full.coadd_topk[0, 0, -1]))
            if time.perf_counter() - t0 >= seconds and (
                    prof is None or prof.done):
                break
        sync()
        run.window_s = time.perf_counter() - t0
        run.window_calls = k
        run.window_data_s = k * info.m * nsec
        if on_card:
            run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
        for rec in run.calls:
            rec.resolve(wait=True)
        if prof:
            run.trace = prof.analyse()
        secs.on = False
        stream = raw[ant].clone()
        del raw, loop, step_fn, bp, prev
    finally:
        baseband_dsp.process_second = original
        if dist.is_initialized():
            dist.destroy_process_group()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    result = check_array.check(cell, stream, [kept])
    print(f"check: {time.perf_counter() - t:.1f} s", file=sys.stderr,
          flush=True)
    run.masked_share = result.masked_share
    dev_s = [r.device_s for r in run.calls if r.device_s]
    staged = [sum(r.stages.values()) for r in run.calls if r.device_s]
    print(f"portbench: window {run.window_s:.3f} s, {run.window_calls} "
          f"calls, {run.window_data_s} antenna-seconds; set-up "
          f"{run.setup_s:.3f} s; call {kept.call} antenna {ant} seconds "
          f"{sorted(kept.seconds)} compared, masked share "
          f"{result.masked_share}; device spans {dev_s} s, their stages "
          f"{staged} s; bursts {run.attempted} attempted, {run.failed} "
          "failed", file=sys.stderr, flush=True)
    return run, result


class _Loop:
    """One call on the normal path: the step, the gather, the
    extraction, under the host range vfast.array_call; the state
    carried.  `full` is the last call's gathered output."""

    def __init__(self, sp, step_fn, raw, mesh, info, scfg, recorded, state):
        self.sp, self.step_fn, self.raw = sp, step_fn, raw
        self.mesh, self.info, self.scfg = mesh, info, scfg
        self.recorded, self.state = recorded, state
        self.full = None

    def call(self, k: int) -> tuple:
        """(the call's record or None, per-beam and coadd candidates)."""
        import torch
        sp, info = self.sp, self.info
        rec, kw = None, {}
        if self.recorded:
            from vlite_fast_tpu_torch.utils import spans
            rec = spans.Record("call", k, self.raw.device.type == "cuda")
            kw = {"record": rec}
        with torch.profiler.record_function("vfast.array_call"):
            out, self.state = self.step_fn(self.raw, *self.state, **kw)
            self.full = sp.gather_step_output(out, self.mesh, **kw)
            del out
            per_beam, coadd, _ = sp.extract_candidates(
                self.full, info, self.scfg, call_base=k * info.T, **kw)
        if rec is not None:
            rec.add("call", rec.start, time.perf_counter(), parent=None)
        return rec, per_beam, coadd


class _Profiler:
    """torch.profiler over one call."""

    def __init__(self):
        self.prof = self.rng = None   # the profiler and its window range
        self.done = False
        self.path = WORK_DIR / "trace_array.json"

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
        self.done = True

    def analyse(self) -> dict:
        from portbench import trace
        WORK_DIR.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        try:
            return trace.analyse(self.path)
        finally:
            os.remove(self.path)
