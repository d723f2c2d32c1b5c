"""The array host's cell at the CPU's size: _tiny_array's geometry (1
Msamp/s, nfft 500, 192 channels of a 0.5 MHz band, a 0.1 s bandpass, 2
bits, the burst injected three times as bright) and SearchConfig.tiny's
linear 64-trial grid, 3 antennas with 8-s rings, coincidence every 2
data-seconds, on the benchmark's own traffic file."""

from __future__ import annotations

import dataclasses
import json

from portbench import spec

NANT, RING_S, COINCIDE_S = 3, 8, 2


def tiny_host_cell(snr_thresh: float = 6.0) -> spec.Cell:
    from vlite_fast_tpu_torch.config import PipelineConfig, SearchConfig
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    cfg = PipelineConfig.tiny(nbit=2, inject_frb=True, bandwidth_mhz=0.5,
                              bp_tsmooth=0.1, inject_amp=3.0)
    s = dataclasses.asdict(SearchConfig.tiny(snr_thresh=snr_thresh))
    s["zap_ranges"] = [list(r) for r in s["zap_ranges"]]
    name = "host8.realtime"
    return spec.Cell(
        name=name,
        config={"driver": "array_host", "dsp": dataclasses.asdict(cfg),
                "search": s,
                "array": {"nant": NANT, "ring_seconds": RING_S,
                          "coincide_every_s": COINCIDE_S,
                          "write_fil": False}},
        traffic=json.loads((spec.HERE / "traffic" / "realtime.json")
                           .read_text()),
        end_to_end=[m for m in bench["end_to_end"]
                    if spec._reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if spec._reports(m, name)],
        limits=json.loads((spec.HERE / "limits" / f"{name}.json")
                          .read_text()))
