"""The port's headline bench (vlite_fast_tpu_torch/bench.py) on the CPU, at
a tiny geometry: PipelineConfig.tiny at 0.5 MS/s with the FRB injected at
DM 60, SearchConfig.tiny's linear grid and its tolerance grid, 5 s a loop
(~13 s in all on one thread).

Bars: every key of the bench's line is there; every number is finite;
the shares of the card's peaks are None (not measured on the CPU) and the
device is 'cpu'; the FRB is recovered in both loops, and no candidate
below DM 20 comes in an observation's first 0.5 s; the twin agrees with
the armed program to its bar (1.0 where it is the same program, else
0.9999 of 2-bit levels).  The CLI's bench reaches bench.main with its
--device; a card asked for where there is none raises.
"""

import json
import math

import pytest
import torch

from vlite_fast_tpu_torch import bench
from vlite_fast_tpu_torch import cli as tcli
from vlite_fast_tpu_torch.config import PipelineConfig, SearchConfig

torch.set_num_threads(1)

KEYS = ("value", "value_tolgrid", "tolgrid_trials", "dsp_only_rt_factor",
        "dsp_only_rt_factor_gated", "dsp_only_rt_factor_blended",
        "twin_agreement", "twin_byte_parity", "twin_chain_impl",
        "gulp_lin_s", "gulp_tol_s", "gulps_searched", "wall_s", "candidates",
        "best_snr", "frb_dm", "frb_snr", "frb_recovered",
        "cand_latency_wall_s", "cand_latency_data_s", "search_engine",
        "dsp_f32_tflops", "dsp_f32_util_pct", "dsp_hbm_gbps_min",
        "dsp_hbm_util_pct_min", "dedisp_gulp_s", "dedisp_hbm_gbps",
        "dedisp_hbm_util_pct", "dedisp_gadds_per_s", "dedisp_sol_hbm_s",
        "device", "launches", "start_lowdm_candidates")
CFG = PipelineConfig.tiny(inject_frb=True, nbit=2, sample_rate=500_000,
                          inject_dm=60.0, inject_amp=2.0,
                          inject_width_s=8e-3)


@pytest.fixture(scope="module")
def result():
    return bench.run(device="cpu", cfg=CFG, scfg=SearchConfig.tiny(),
                     n_sec=5)


def test_bench_on_the_cpu_gives_every_key(result):
    assert set(KEYS) <= set(result)
    # the line is JSON as main prints it
    assert json.loads(json.dumps(result)) == result
    for k, v in result.items():
        if "_util_pct" in k or k == "peak_device_gib":
            assert v is None, k
        elif isinstance(v, float):
            assert math.isfinite(v), k
    assert result["device"] == "cpu"
    assert result["search_engine"] == "subband"
    assert result["frb_recovered"]
    assert abs(result["frb_dm"] - CFG.inject_dm) <= 0.1 * CFG.inject_dm
    assert result["frb_snr"] >= bench.FRB_MIN_SNR
    # every observation starts from a settled bandpass
    assert result["start_lowdm_candidates"] == 0
    assert result["gulps_searched"] >= 1 and result["candidates"] >= 1
    assert result["tolgrid_trials"] >= 128
    assert result["cand_latency_data_s"] > 0
    assert result["value"] > 0 and result["value_tolgrid"] > 0
    assert result["dedisp_gadds_per_s"] > 0
    # on the CPU every kernel's plain version runs: no launch counted
    assert not any(result["launches"].values())


def test_bench_twin_agreement_meets_its_bar(result):
    bar = 1.0 if result["twin_chain_impl"] == CFG.chain_impl else 0.9999
    assert result["twin_agreement"] >= bar
    assert result["twin_byte_parity"] == (result["twin_agreement"] == 1.0)


def _stub(calls, recovered=True):
    def run(device="cuda", **kw):
        calls.append(device)
        return {"value": 1.0, "frb_recovered": recovered}
    return run


@pytest.mark.parametrize("argv", [["--device", "cpu", "bench"],
                                  ["bench", "--device", "cpu"]])
def test_cli_bench_reaches_bench_main(argv, monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(bench, "run", _stub(calls))
    tcli.main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    assert calls == ["cpu"]
    assert len(out) == 1 and json.loads(out[0])["value"] == 1.0


def test_bench_main_fails_without_the_frb(monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(bench, "run", _stub(calls, recovered=False))
    with pytest.raises(SystemExit) as exc:
        bench.main(["--device", "cpu"])
    assert exc.value.code not in (0, None)
    assert json.loads(capsys.readouterr().out)["frb_recovered"] is False


def test_bench_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        bench.run(device="cuda")


def test_a_card_without_an_index_resolves_to_the_current_one(monkeypatch):
    """StationPipeline(device='cuda') takes a second already on cuda:0 in
    place: its device compares equal to the pipeline's only once 'cuda'
    names the index (before, each such second went to the host and back:
    13.7 ms of a 14.7-ms twin span on an NVIDIA H100 80GB HBM3)."""
    from vlite_fast_tpu_torch import devices
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert devices.resolve("cuda") == torch.device("cuda", 0)
    assert devices.resolve(torch.device("cuda")) == torch.device("cuda:0")
    assert devices.resolve("cuda:1") == torch.device("cuda", 1)
    assert devices.resolve("cpu") == torch.device("cpu")
