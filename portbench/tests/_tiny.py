"""A cell at the CPU's size: PipelineConfig.tiny's geometry (1 Msamp/s,
nfft 500, 192 channels of a 0.5 MHz band, a 0.1 s bandpass) at 2 bits
with the burst injected, and
SearchConfig.tiny's linear 64-trial grid, on the benchmark's own traffic
files and metrics."""

from __future__ import annotations

import dataclasses
import json

from portbench import spec


def tiny_cell(traffic: str = "noise", channelizer: str = "matmul",
              limits: str = "station_fft.noise") -> spec.Cell:
    from vlite_fast_tpu_torch.config import PipelineConfig, SearchConfig
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    # a 0.5 MHz band sampled at 1 Msamp/s, so that a dispersed pulse
    # sweeps the band as it would in the real one; a bandpass that forgets
    # in 0.46 s (bp_tsmooth 0.1 s), so that the reference determines it
    # from one second before a gulp of the short windows run here
    cfg = PipelineConfig.tiny(nbit=2, inject_frb=True,
                              channelizer=channelizer, bandwidth_mhz=0.5,
                              bp_tsmooth=0.1)
    s = dataclasses.asdict(SearchConfig.tiny())
    s["zap_ranges"] = [list(r) for r in s["zap_ranges"]]
    return spec.Cell(
        name="tiny", config={"driver": "station",
                             "dsp": dataclasses.asdict(cfg), "search": s},
        traffic=json.loads((spec.HERE / "traffic" / f"{traffic}.json")
                           .read_text()),
        end_to_end=bench["end_to_end"], per_layer=bench["per_layer"],
        limits=json.loads((spec.HERE / "limits" / f"{limits}.json")
                          .read_text()))
