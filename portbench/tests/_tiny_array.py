"""The array's cell at the CPU's size: _tiny's geometry (1 Msamp/s, nfft
500, 192 channels of a 0.5 MHz band, a 0.1 s bandpass, 2 bits, the burst
injected, here three times as bright, so that a tiny beam finds it) and
SearchConfig.tiny's linear 64-trial grid, 4 antennas on a 1x1 mesh in
2-s calls armed at second 1, on the benchmark's own traffic file (its
call cut to 2 s); and
calls of the array step on it through its normal path, on a one-rank
gloo group."""

from __future__ import annotations

import dataclasses
import json
import time

from portbench import spec

NANT, NSEC, INJECT_SEC = 4, 2, 1


def tiny_array_cell(snr_thresh: float = 6.0) -> spec.Cell:
    from vlite_fast_tpu_torch.config import PipelineConfig, SearchConfig
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    cfg = PipelineConfig.tiny(nbit=2, inject_frb=True, bandwidth_mhz=0.5,
                              bp_tsmooth=0.1, inject_amp=3.0)
    s = dataclasses.asdict(SearchConfig.tiny(snr_thresh=snr_thresh))
    s["zap_ranges"] = [list(r) for r in s["zap_ranges"]]
    name = "array8.coadd"
    return spec.Cell(
        name=name,
        config={"driver": "array_step", "dsp": dataclasses.asdict(cfg),
                "search": s,
                "array": {"nant": NANT, "mesh_ant": 1, "mesh_time": 1,
                          "nsec_per_call": NSEC, "inject_sec": INJECT_SEC}},
        traffic=dict(json.loads((spec.HERE / "traffic" / "coadd.json")
                                .read_text()), seconds=NSEC),
        end_to_end=[m for m in bench["end_to_end"]
                    if spec._reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if spec._reports(m, name)],
        limits=json.loads((spec.HERE / "limits" / f"{name}.json")
                          .read_text()))


def array_calls(cell: spec.Cell, ncalls: int, seed: int,
                record: bool = True) -> dict:
    """`ncalls` calls of the cell's step on its traffic, the first from
    zero bandpasses and no history, the state carried: the staged call
    `raw` (nant, npol, nsec * rate), the step's `info`, and for each call
    its gathered output, the state it left, its record (None without
    `record`; its root span "call" around the three calls, as the array
    driver's) and its per-beam and coadd candidates."""
    import torch
    import torch.distributed as dist
    from portbench.drivers.array_step import _array_config
    from vlite_fast_tpu_torch.parallel import sharded_pipeline as sp
    from vlite_fast_tpu_torch.parallel.distributed import init_distributed
    from vlite_fast_tpu_torch.parallel.mesh import make_mesh
    from vlite_fast_tpu_torch.utils import spans

    acfg = _array_config(cell)
    cfg = acfg.pipeline
    init_distributed(device="cpu")
    try:
        mesh = make_mesh(n_ant=1, n_time=1)
        step_fn, _, _, info = sp.build_array_step(
            acfg, mesh, nsec_per_call=NSEC, inject_sec=INJECT_SEC)
        raw = torch.empty((NANT, cfg.npol_in, NSEC * cfg.sample_rate),
                          dtype=torch.uint8)
        spec.generator(cell.traffic).fill_call(cell.traffic, raw,
                                               cfg.sample_rate, seed)
        bp = torch.zeros((NANT, cfg.npol_in, cfg.nchan))
        state = (bp, bp.clone(), None)
        calls = []
        for k in range(ncalls):
            rec = spans.Record("call", k) if record else None
            out, state = step_fn(raw, *state, record=rec)
            full = sp.gather_step_output(out, mesh, record=rec)
            per_beam, coadd, stats = sp.extract_candidates(
                full, info, acfg.search, call_base=k * info.T, record=rec)
            if rec is not None:
                rec.add("call", rec.start, time.perf_counter(), parent=None)
                rec.resolve()
            calls.append({"full": full, "state": state, "record": rec,
                          "per_beam": per_beam, "coadd": coadd,
                          "stats": stats})
        return {"raw": raw, "info": info, "calls": calls}
    finally:
        dist.destroy_process_group()
