"""The port's headline benchmark: measured full-stack antennas per card.

    python -m vlite_fast_tpu_torch.bench [--device cuda]
    python -m vlite_fast_tpu_torch.cli bench

The counterpart of the JAX package's root bench.py.  It times the
integrated per-antenna loop end to end, through the entry point a station
runs, StationPipeline.feed_second: the DSP chain (the twin's chain kernel,
and the armed program's RFI front and EMA kernels for the seconds after
each minute's arm), the drain, the gulp search (the fold kernel on the
packed rows, boxcar S/N, banded top-k) and the host's clustering into
candidates, at the reference geometry (PipelineConfig(inject_frb=True):
NFFT 12500, 320 segments a second, rfi_mode 2, 2-bit, 4096 channels),
with the FRB injected at DM 80 once a minute.

The input seconds are staged on the device first (the host's capture and
ring are measured by the array and entry-point runs, not here).  Every
window is timed on the host's clock after torch.cuda.synchronize() at its
end; no second is synchronized on its own.

`value` is the loop on the linear 1024-trial DM grid (the headline the
JAX package's bench reports, comparable with the reference's);
`value_tolgrid` is the same loop on the shipped tolerance grid
(SearchConfig(): 4864 trials).  The JAX bench derived the second from the
first by substituting gulp times, because a tol-grid compile cost minutes
on the TPU; on the card both loops are cheap, so both are run and
measured.  vs_baseline: 1.0 is one antenna in real time on one device (the
reference needs one GPU an antenna).

`main` prints ONE JSON line on stdout (everything else goes to stderr)
and exits non-zero when the injected FRB is not recovered within 10% of
its DM at S/N >= 10 in both loops, or when the twin's agreement with the
armed program is below its bar (run raises).  No environment variable is
read and nothing falls back to the CPU: device 'cuda' without a card
raises.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from vlite_fast_tpu_torch import constants as C
from vlite_fast_tpu_torch import devices, launches
from vlite_fast_tpu_torch.config import PipelineConfig, SearchConfig

FRB_MIN_SNR = 10.0     # PERF.md §2's bar: within 10% of the DM, S/N >= 10
# an observation's start: its first START_S seconds below the trigger's
# minimum DM, where a cold bandpass's start-up transient would read
START_S = 0.5
START_MAX_DM = C.TRIGGER_MIN_DM
DSP_SECONDS = 10       # seconds in each DSP-only loop
GULP_REPS = 3          # timed calls of each gulp timer (after a warm one)


def _log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(dev: torch.device, fn, reps: int) -> float:
    """Mean wall seconds of fn() over reps calls after one warm call, the
    device synchronized before and at the window's end."""
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) / reps


def device_name(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them; 'cpu'
    on the CPU."""
    if dev.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", f"--id={dev.index or 0}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(dev)}, power limit not read"


def _frb(cands, cfg: PipelineConfig):
    """The strongest candidate within 10% of the injected DM at S/N >=
    FRB_MIN_SNR, or None."""
    near = [c for c in cands
            if abs(c.dm - cfg.inject_dm) <= 0.1 * cfg.inject_dm
            and c.snr >= FRB_MIN_SNR]
    return max(near, key=lambda c: c.snr) if near else None


def start_transient(cands, scfg: SearchConfig) -> list:
    """The candidates of an observation's first START_S seconds below
    START_MAX_DM at or above scfg.snr_thresh: none since the bandpass is
    seeded from the EMA's own length (baseband_dsp.seed_bandpass)."""
    return [c for c in cands if c.peak_time < START_S
            and c.dm < START_MAX_DM and c.snr >= scfg.snr_thresh]


def _levels(packed: torch.Tensor, nbit: int) -> torch.Tensor:
    from vlite_fast_tpu_torch.ops import quantize as q_ops
    return q_ops.unpack_bits(packed, nbit).to(torch.int32)


def _dsp_loop(cfg: PipelineConfig, program, staged: list,
              dev: torch.device) -> tuple:
    """(real-time factor, the last second's outputs) of DSP_SECONDS
    un-armed seconds through `program` after one warm second."""
    from vlite_fast_tpu_torch.models import baseband_dsp as dsp
    out, st = program(cfg, staged[0], dsp.init_state(cfg, dev), False)
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(DSP_SECONDS):
        out, st = program(cfg, staged[i % len(staged)], st, False)
    _sync(dev)
    return DSP_SECONDS / (time.perf_counter() - t0), out


def _observe(cfg: PipelineConfig, scfg: SearchConfig, staged: list,
             n_sec: int, dev: torch.device) -> dict:
    """One pipeline: prewarm, one warm observation of n_sec, then the
    timed observation of n_sec.  The kernel launches of both
    observations (not the prewarm's) are returned with the readings."""
    from vlite_fast_tpu_torch.runtime.control import ObservationDocument
    from vlite_fast_tpu_torch.runtime.pipeline import StationPipeline
    od = ObservationDocument(name="BENCH", start_time=1.7e9)
    with tempfile.TemporaryDirectory(prefix="vfast_bench_") as out_dir:
        pipe = StationPipeline(1, cfg, scfg, out_dir=out_dir,
                               keep_ring=False, write_cands=False,
                               device=dev)
        try:
            pipe.prewarm()
            before = launches.counts()
            # the warm observation takes every first use (CUDA's lazy
            # module loading, the allocator's blocks, cuBLAS handles)
            pipe.begin_observation(od, write_fil=False)
            for s in range(n_sec):
                pipe.feed_second(1.7e9 + s, staged[s % len(staged)])
            pipe.end_observation()
            gulps0 = pipe.metrics.get("vfast_gulps_searched")
            lat_wall = lat_data = None
            feed_times = {}
            pipe.begin_observation(od, write_fil=False)
            gulp_host = dict(pipe.search.host_seconds)
            _sync(dev)
            t0 = time.perf_counter()
            for s in range(n_sec):
                feed_times[s] = time.perf_counter()
                new = pipe.feed_second(1.7e9 + s, staged[s % len(staged)])
                if new and lat_wall is None:
                    best = max(new, key=lambda c: c.snr)
                    pulse_sec = min(int(best.peak_time), s)
                    lat_wall = time.perf_counter() - feed_times[pulse_sec]
                    # (end of the searched window incl. overlap) - pulse
                    # time, as the pipeline records it for the gulp
                    lat_data = pipe.metrics.get("vfast_cand_latency_data_s")
            prod = pipe.end_observation()
            _sync(dev)
            wall = time.perf_counter() - t0
            spans = pipe.feed_seconds
            summed = sum(map(sum, spans.values()))
            _log(f"{scfg.dm_grid_mode} grid: span a second (device "
                 f"timeline) twin median "
                 f"{1e3 * np.median(spans['twin']):.2f} ms, armed "
                 + ", ".join(f"{1e3 * a:.1f}" for a in spans["armed"])
                 + f" ms, all seconds' spans {summed:.3f} s of {wall:.3f}"
                 " s wall; host ms a second (median): "
                 + ", ".join(f"{k} {1e3 * np.median(v):.3f}"
                             for k, v in pipe.host_seconds.items())
                 + "; host ms summed over the loop: "
                 + ", ".join(f"{k} {1e3 * sum(v):.3f}"
                             for k, v in pipe.host_seconds.items())
                 + " (its gulps' search: "
                 + ", ".join(f"{k} {1e3 * (v - gulp_host[k]):.3f}"
                             for k, v in pipe.search.host_seconds.items())
                 + ")")
            return {"wall": wall, "cands": prod.candidates,
                    "gulps": int(pipe.metrics.get("vfast_gulps_searched")
                                 - gulps0),
                    "lat_wall": lat_wall, "lat_data": lat_data,
                    "engine": pipe.search.engine,
                    "launches": launches.since(before)}
        finally:
            pipe.close()


def _engine(cfg: PipelineConfig, scfg: SearchConfig, dev: torch.device):
    """A search engine on the plan geometry StationPipeline gives it."""
    from vlite_fast_tpu_torch.models import search as search_mod
    return search_mod.SinglePulseSearch(
        scfg, cfg.tsamp, cfg.freqs_mhz(), nsub=min(128, cfg.nchanout),
        nbatch=min(scfg.ndm, 128), device=dev)


def _gulp_seconds(cfg: PipelineConfig, scfg: SearchConfig,
                  rng: np.random.Generator, dev: torch.device) -> tuple:
    """(mean seconds of one device gulp: dequantize -> fold kernel ->
    boxcar S/N -> banded top-k -> host decode, on random packed rows;
    the grid's trials)."""
    eng = _engine(cfg, scfg, dev)
    nbytes = cfg.npol_out * cfg.nchanout * cfg.nbit // 8
    full = scfg.gulp_samps + eng.overlap
    pk = torch.from_numpy(rng.integers(0, 256, (full, nbytes),
                                       dtype=np.uint8)).to(dev)
    s = _timed(dev, lambda: eng.search_gulp_device(pk, cfg.nbit), GULP_REPS)
    return s, len(eng.dms)


def run(device="cuda", cfg: PipelineConfig = None,
        scfg: SearchConfig = None, n_sec: int = 40) -> dict:
    """Every measurement of the bench on `device`; returns the result's
    keys.  cfg defaults to the reference geometry with the FRB injected;
    scfg to the linear 1024-trial grid, and the tol-grid loop runs
    dataclasses.replace(scfg, dm_grid_mode='tol') (SearchConfig() at the
    defaults).  n_sec must exceed one gulp and its overlap (~33 s at the
    reference geometry) for the search to run hot."""
    from vlite_fast_tpu_torch.models import baseband_dsp as dsp
    from vlite_fast_tpu_torch.ops import dedisperse_pallas as ddp
    from vlite_fast_tpu_torch.utils import perf
    dev = devices.resolve(device)
    cfg = cfg or PipelineConfig(inject_frb=True)
    scfg = scfg or SearchConfig(dm_grid_mode="linear")
    scfg_tol = dataclasses.replace(scfg, dm_grid_mode="tol")
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t_start = time.perf_counter()

    # --- three seconds of noise staged on the device -------------------
    rng = np.random.default_rng(0)
    staged = [torch.from_numpy(np.clip(
        rng.standard_normal((cfg.npol_in, cfg.sample_rate)) / 0.05914
        + 128.5, 0, 255).astype(np.uint8)).to(dev) for _ in range(3)]

    # --- the DSP programs alone: armed (not armed) and the twin ---------
    # (twin 'xla': process_second's own program, which on a card hands an
    # un-armed second to the twin's chain kernel where that is the twin)
    dsp_rt, out_a = _dsp_loop(dataclasses.replace(cfg, twin_chain_impl="xla"),
                              dsp.process_second, staged, dev)
    _, twin, twin_cfg = dsp.second_program(cfg, -1)
    twin_impl = twin_cfg.chain_impl
    dsp_rt_gated, out_t = _dsp_loop(twin_cfg, twin, staged, dev)
    # both loops ran the same un-armed seconds: the twin must give the
    # armed program's levels (bit for bit where it is the same program;
    # else the chain bar, the JAX package's for its chain variants)
    field = "packed_kur" if cfg.rfi_mode else "packed"
    lev_a = _levels(getattr(out_a, field), cfg.nbit)
    lev_t = _levels(getattr(out_t, field), cfg.nbit)
    twin_agreement = float((lev_a == lev_t).to(torch.float32).mean())
    bar = 1.0 if twin_impl == cfg.chain_impl else 0.9999
    if twin_agreement < bar:
        raise AssertionError(
            f"the armed program and the twin ({twin_impl}) agree on only "
            f"{twin_agreement:.6f} of {cfg.nbit}-bit levels (bar {bar}): "
            "the host gating of StationPipeline.feed_second is unsound")
    del out_a, out_t, lev_a, lev_t
    # the station runs the armed program on the seconds the track reaches
    f_armed = sum(dsp.second_injects(cfg, s * cfg.seg_per_sec)
                  for s in range(C.INJECT_PERIOD_S)) / C.INJECT_PERIOD_S
    dsp_rt_blended = 1.0 / (f_armed / dsp_rt + (1.0 - f_armed) / dsp_rt_gated)
    _log(f"DSP: armed {dsp_rt:.3f}x, twin ({twin_impl}) {dsp_rt_gated:.3f}x, "
         f"blended {dsp_rt_blended:.3f}x; twin agreement "
         f"{twin_agreement:.6f} (bar {bar})")

    # --- the fold kernel alone (f32 entry) on a gulp of the linear grid --
    eng = _engine(cfg, scfg, dev)
    full = scfg.gulp_samps + eng.overlap
    ntime_out = full - eng.plan.max_delay
    fb = torch.from_numpy(rng.standard_normal(
        (full, cfg.nchanout)).astype(np.float32)).to(dev)
    dedisp_s = _timed(dev, lambda: ddp.dedisperse_pallas(fb, eng.plan,
                                                         ntime_out),
                      GULP_REPS)
    dcost = perf.dedisp_fold_cost(eng.plan, cfg.nchanout, ntime_out)
    del fb, eng
    if on_card:
        torch.cuda.empty_cache()
    _log(f"fold kernel (f32 entry), linear grid: {1e3 * dedisp_s:.3f} ms "
         "a gulp")

    # --- the integrated loop on both grids -------------------------------
    obs = {}
    for name, sc in (("linear", scfg), ("tol", scfg_tol)):
        obs[name] = _observe(cfg, sc, staged, n_sec, dev)
        if on_card:
            torch.cuda.empty_cache()
        _log(f"integrated loop, {name} grid: {n_sec} s in "
             f"{obs[name]['wall']:.3f} s, {obs[name]['gulps']} gulps, "
             f"{len(obs[name]['cands'])} candidates")
    del staged
    if on_card:
        torch.cuda.empty_cache()

    # --- one device gulp on each grid, after the pipelines are gone ------
    gulp_lin_s, _ = _gulp_seconds(cfg, scfg, rng, dev)
    gulp_tol_s, tol_trials = _gulp_seconds(cfg, scfg_tol, rng, dev)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30 \
        if on_card else None
    _log(f"gulp: linear {gulp_lin_s:.4f} s, tol grid ({tol_trials} trials) "
         f"{gulp_tol_s:.4f} s; peak device memory "
         + ("not measured (cpu)" if peak_gib is None
            else f"{peak_gib:.2f} GiB")
         + f"; the bench took {time.perf_counter() - t_start:.1f} s")

    lin, tol = obs["linear"], obs["tol"]
    value = n_sec / lin["wall"]
    frb_lin, frb_tol = _frb(lin["cands"], cfg), _frb(tol["cands"], cfg)
    # products the timed programs issue and bytes they move, per
    # data-second, times the data-seconds they ran per wall second
    dft = perf.dft_flops_per_data_second(cfg)
    dsp_tflops = dft["armed_f32_flops"] * dsp_rt / 1e12
    dsp_gbps = perf.chain_hbm_bytes_per_data_second(cfg) * dsp_rt / 1e9
    dedisp_gbps = dcost["hbm_bytes"] / dedisp_s / 1e9
    peak_tflops = perf.PEAK_OPS_PER_S["f32"] / 1e12
    peak_gbps = perf.HBM_BYTES_PER_S / 1e9

    def share(rate: float, peak: float):
        # a share of the H100's peak names a device metric: not measured
        # on the CPU
        return 100 * rate / peak if on_card else None

    return {
        "metric": "measured full-stack antennas per card (StationPipeline:"
                  " DSP + drain + fold-kernel search + candidates, "
                  "injected FRB recovered)",
        "value": value,
        "unit": "antennas per card (x real-time, integrated loop)",
        "vs_baseline": value,
        "value_tolgrid": n_sec / tol["wall"],
        "tolgrid_trials": tol_trials,
        "dsp_only_rt_factor": dsp_rt,
        "dsp_only_rt_factor_gated": dsp_rt_gated,
        "dsp_only_rt_factor_blended": dsp_rt_blended,
        "twin_byte_parity": twin_agreement == 1.0,
        "twin_agreement": twin_agreement,
        "twin_chain_impl": twin_impl,
        "gulp_lin_s": gulp_lin_s,
        "gulp_tol_s": gulp_tol_s,
        "gulps_searched": lin["gulps"],
        "gulps_searched_tolgrid": tol["gulps"],
        "seconds_processed": n_sec,
        "wall_s": lin["wall"],
        "wall_tolgrid_s": tol["wall"],
        "candidates": len(lin["cands"]),
        "best_snr": max((c.snr for c in lin["cands"]), default=0.0),
        "frb_dm": frb_lin.dm if frb_lin else None,
        "frb_snr": frb_lin.snr if frb_lin else None,
        "frb_snr_tolgrid": frb_tol.snr if frb_tol else None,
        "frb_recovered": frb_lin is not None and frb_tol is not None,
        # both loops' candidates of the observation's first START_S s
        # below START_MAX_DM (start_transient)
        "start_lowdm_candidates": len(start_transient(lin["cands"], scfg))
        + len(start_transient(tol["cands"], scfg_tol)),
        "cand_latency_wall_s": lin["lat_wall"],
        "cand_latency_data_s": lin["lat_data"],
        "search_engine": lin["engine"],
        # the armed program's f32 GEMM products (ops/channelize.
        # matmul_rfft, both streams) at its measured rate, against the
        # card's f32 peak: products it issues, so the share cannot pass
        # 100% of the peak the GEMMs run at (tf32 is off)
        "dsp_f32_tflops": dsp_tflops,
        "dsp_f32_util_pct": share(dsp_tflops, peak_tflops),
        # the armed program's materializations (raw in, f32 voltages,
        # spectra and powers written and read, packed out), which its torch
        # passes write: a lower bound of its traffic, so the share cannot
        # pass 100%
        "dsp_hbm_gbps_min": dsp_gbps,
        "dsp_hbm_util_pct_min": share(dsp_gbps, peak_gbps),
        # the fold kernel's reads and writes as it does the work (the
        # filterbank and tables once, its intermediate written and read
        # once, the plane written once): traffic it moves, so the share
        # cannot pass 100%
        "dedisp_gulp_s": dedisp_s,
        "dedisp_hbm_gbps": dedisp_gbps,
        "dedisp_hbm_util_pct": share(dedisp_gbps, peak_gbps),
        "dedisp_gadds_per_s": dcost["adds"] / dedisp_s / 1e9,
        "dedisp_sol_hbm_s": dcost["sol_hbm_s"],
        "peak_device_gib": peak_gib,
        "device": device_name(dev),
        # launches of the integrated loops' observations, by kernel
        "launches": {k: lin["launches"][k] + tol["launches"][k]
                     for k in lin["launches"]},
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="vlite_fast_tpu_torch.bench",
                                description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (default 'cuda'; raises without a card)")
    args = p.parse_args(argv)
    # stdout carries the one result line; whatever else is printed goes
    # to stderr
    with contextlib.redirect_stdout(sys.stderr):
        res = run(device=args.device)
    print(json.dumps(res), flush=True)
    if not res["frb_recovered"]:
        raise SystemExit(
            f"bench: the injected FRB (DM {PipelineConfig().inject_dm:g}) "
            f"was not recovered at S/N >= {FRB_MIN_SNR:g} in both loops")


if __name__ == "__main__":
    main()
