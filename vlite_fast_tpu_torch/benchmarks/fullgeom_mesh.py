"""Production-geometry run of the sharded array step on the card(s).

The port's counterpart of the JAX package's
benchmarks/validate_fullgeom_mesh.py: build_array_step at the real VLITE
geometry (128 MS/s, NFFT 12500, 4096 output channels, 320 segments/s,
DM 2-1000 over a linear 1024-trial grid), 20-second calls with the
chain's FRB injection armed at second 2 of each, the EMA and search
state carried from call to call.  Every beam and the coadd must recover
the burst within `near` DM trials of pipeline.inject_dm, the coadd above
the best beam.  8 antennas where the cards' free memory holds their raw
with a quarter to spare, else 4 (choose_nant).  One rank per card:

    python -m vlite_fast_tpu_torch.benchmarks.fullgeom_mesh [--calls 2]
    torchrun --nproc-per-node N \
        -m vlite_fast_tpu_torch.benchmarks.fullgeom_mesh

A single process makes a one-rank NCCL group (a 1x1 mesh: its
collectives still go through NCCL); under torchrun the mesh is
(N/2, 2) for an even N > 1, else (N, 1).  Each rank makes its antennas'
8-bit Gaussian noise on its card, second by second from a torch seed per
(call, antenna), so any mesh sees the same voltages; the JAX script draws
numpy noise on the host instead.  Rank 0 prints one JSON report with the
JAX script's keys (for the first call) and, under "calls", each call's
wall, antenna-seconds a second, device ms by part (the device stages of
the call's utils/spans record, part_ms) and peak device memory.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch
import torch.distributed as dist

from vlite_fast_tpu_torch.config import (AntennaConfig, ArrayConfig,
                                         PipelineConfig, SearchConfig)

INJECT_SEC = 2


def array_config(nant: int, mesh) -> ArrayConfig:
    """The validation's configuration: every production default, the FRB
    injection on, the linear 1024-trial DM grid."""
    return ArrayConfig(
        antennas=tuple(AntennaConfig(i + 1, f"ea{i + 1:02d}")
                       for i in range(nant)),
        pipeline=dataclasses.replace(PipelineConfig(), inject_frb=True),
        search=dataclasses.replace(SearchConfig(), dm_grid_mode="linear",
                                   ndm=1024),
        mesh_ant=mesh.shape["ant"], mesh_time=mesh.shape["time"])


def choose_nant(mesh, cfg, nsec: int) -> tuple:
    """(nant, free, raw8): 8 antennas, the JAX script's count, where every
    rank's share of their raw (uint8, nsec seconds) fits in its card's
    free memory with a quarter to spare, else 4.  `free` is the least
    free memory over the mesh's ranks and `raw8` the bytes of 8 antennas'
    raw.  Collective over the mesh."""
    free = torch.tensor(torch.cuda.mem_get_info(mesh.device)[0],
                        dtype=torch.int64, device=mesh.device)
    dist.all_reduce(free, op=dist.ReduceOp.MIN, group=mesh.group)
    raw8 = 8 * cfg.npol_in * nsec * cfg.sample_rate
    free = int(free)
    return (8 if free >= 1.25 * raw8 / mesh.size else 4), free, raw8


def noise_second(gen: torch.Generator, npol: int, rate: int,
                 device) -> torch.Tensor:
    """One second of Gaussian 8-bit noise at the production quantizer
    operating point, made on the device."""
    sec = torch.randn((npol, rate), generator=gen, device=device)
    return (sec / 0.05914 + 128.5).clamp_(0, 255).to(torch.uint8)


def _gen(device, seed: int, call: int, ant: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        seed * 1_000_003 + (call + 1) * 10_007 + ant)


def fill_noise(raw: torch.Tensor, mesh, cfg, call: int, seed: int) -> None:
    """raw (m, npol, nsec * rate) uint8 <- this rank's antennas' noise
    for `call`, second by second from a torch seed per (call, antenna)."""
    m, npol, nsamp = raw.shape
    rate = cfg.sample_rate
    for i in range(m):
        gen = _gen(raw.device, seed, call, mesh.d * m + i)
        for s in range(nsamp // rate):
            raw[i, :, s * rate:(s + 1) * rate] = noise_second(
                gen, npol, rate, raw.device)


def initial_state(mesh, cfg, info, seed: int) -> tuple:
    """(bp, bp_kur, tail) at the first call: each of this rank's antennas
    observed for the ceil(halo / rows a second) seconds before it (noise
    of call -1 through process_second, injection off), leaving its
    bandpasses and its last `halo` packed rows, so that the first call
    continues an observation as every later call does.

    The other start is an observation's first call: zero bandpasses and
    no history (the step's make_inputs, tail None), whose search starts
    at the stream's first row.  The JAX script gives its first call
    `halo` rows of uniformly random bytes instead, which its search reads
    before sample 0; at 2 bits their mean (~0.36, against the data's
    ~-0.04) fills every DM band's top-k with crossings, and the burst is
    lost."""
    from vlite_fast_tpu_torch.models import baseband_dsp as dsp
    dev = mesh.device
    nsec = -(-info.halo // (cfg.seg_per_sec * cfg.out_samps_per_seg))
    bp = torch.empty((info.m, cfg.npol_in, cfg.nchan), device=dev)
    bp_kur = torch.empty_like(bp)
    tails = []
    for i in range(info.m):
        gen = _gen(dev, seed, -1, mesh.d * info.m + i)
        st = dsp.init_state(cfg, dev)
        packed = []
        for _ in range(nsec):
            o, st = dsp.process_second(
                cfg, noise_second(gen, cfg.npol_in, cfg.sample_rate, dev),
                st)
            packed.append(o.packed_kur if cfg.rfi_mode else o.packed)
        tails.append(torch.cat(packed)[-info.halo:])
        bp[i], bp_kur[i] = st.bp, st.bp_kur
    return bp, bp_kur, torch.stack(tails)


# a step's parts by the device stages of its call record
# (parallel/sharded_pipeline): the DSP is process_second's stages, the
# coadd's sum (in the beam loop), all_reduce and scale are
# "coadd_allreduce"
PARTS = {"dsp": ("front", "wola", "dft", "detect", "ema", "pack"),
         "reshard": ("reshard",),
         "beam_search": ("dedisperse", "boxcar", "topk"),
         "coadd_allreduce": ("coadd",),
         "coadd_search": ("coadd_search",)}


def part_ms(record) -> dict:
    """Device ms of each part of a step (PARTS) from its call record,
    read after a synchronize."""
    record.resolve(wait=True)
    return {part: 1e3 * sum(record.stages.get(s, 0.0) for s in stages)
            for part, stages in PARTS.items()}


def judge(per_beam: dict, coadd: list, info, dm_true: float,
          near: int = 4) -> dict:
    """The burst in every beam and in the coadd within `near` DM trials
    of dm_true, and the coadd's S/N above every beam's: the JAX script's
    report fields (beams, coadd, pass)."""
    dm_step = info.dms[1] - info.dms[0]
    beams, ok, best_single = {}, True, 0.0
    for beam in range(info.nant):
        cands = per_beam.get(beam, [])
        hit = [c for c in cands if abs(c.dm - dm_true) <= near * dm_step]
        if not hit:
            ok = False
            beams[str(beam)] = {"recovered": False, "n_cands": len(cands)}
            continue
        b = max(hit, key=lambda c: c.snr)
        best_single = max(best_single, b.snr)
        beams[str(beam)] = {"recovered": True, "snr": float(b.snr),
                            "dm": float(b.dm), "peak_idx": int(b.peak_idx),
                            "n_cands": len(cands)}
    hit = [c for c in coadd if abs(c.dm - dm_true) <= near * dm_step]
    if hit:
        b = max(hit, key=lambda c: c.snr)
        co = {"recovered": True, "snr": float(b.snr), "dm": float(b.dm),
              "peak_idx": int(b.peak_idx),
              "gain_vs_best_beam": float(b.snr) / max(best_single, 1e-9)}
        ok = ok and b.snr > best_single
    else:
        ok = False
        co = {"recovered": False, "n_cands": len(coadd)}
    return {"beams": beams, "coadd": co, "pass": ok}


def main(argv=None) -> int:
    from vlite_fast_tpu_torch.parallel.distributed import init_distributed
    from vlite_fast_tpu_torch.parallel.mesh import make_mesh
    from vlite_fast_tpu_torch.parallel.sharded_pipeline import (
        build_array_step, extract_candidates, gather_step_output)
    from vlite_fast_tpu_torch.utils import spans

    ap = argparse.ArgumentParser(
        prog="vlite_fast_tpu_torch.benchmarks.fullgeom_mesh")
    ap.add_argument("--nsec", type=int, default=20,
                    help="seconds per call (the chunk must hold the "
                         "DM-1000 halo)")
    ap.add_argument("--calls", type=int, default=1)
    args = ap.parse_args(argv)

    topo = init_distributed(device="cuda")
    world = topo["process_count"]
    n_time = 2 if world % 2 == 0 and world > 1 else 1
    mesh = make_mesh(n_ant=world // n_time, n_time=n_time)
    nant, _, _ = choose_nant(mesh, array_config(8, mesh).pipeline,
                             args.nsec)
    acfg = array_config(nant, mesh)
    cfg, scfg = acfg.pipeline, acfg.search
    step_fn, _, _, info = build_array_step(acfg, mesh,
                                           nsec_per_call=args.nsec,
                                           inject_sec=INJECT_SEC)
    raw = torch.empty((info.m, cfg.npol_in, args.nsec * cfg.sample_rate),
                      dtype=torch.uint8, device=mesh.device)
    state = initial_state(mesh, cfg, info, seed=0)
    calls = []
    for k in range(args.calls):
        fill_noise(raw, mesh, cfg, k, seed=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rec = spans.Record("call", k, on_card=True)
        t0 = time.perf_counter()
        out, state = step_fn(raw, *state, record=rec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        full = gather_step_output(out, mesh)
        per_beam, coadd, stats = extract_candidates(full, info, scfg,
                                                    call_base=k * info.T)
        calls.append({"step_seconds": wall,
                      "ant_sec_per_s": nant * args.nsec / wall,
                      "device_ms": part_ms(rec),
                      "peak_device_gib":
                          torch.cuda.max_memory_allocated() / 2 ** 30,
                      "topk_stats": stats,
                      "weights_mean": float(full.weights_mean.mean()),
                      **judge(per_beam, coadd, info, cfg.inject_dm)})
    first = calls[0]
    report = {
        "geometry": {
            "sample_rate": cfg.sample_rate, "nfft": cfg.nfft,
            "nchanout": cfg.nchanout, "seg_per_sec": cfg.seg_per_sec,
            "nbit": cfg.nbit, "rfi_mode": cfg.rfi_mode,
            "ndm": len(info.dms),
            "dm_range": [float(info.dms[0]), float(info.dms[-1])],
            "halo": info.halo, "T": info.T, "chunk": info.c,
            "nsec_per_call": args.nsec, "nant": nant,
            "mesh": dict(mesh.shape), "engine": scfg.engine},
        "inject": {"dm": cfg.inject_dm, "amp": cfg.inject_amp,
                   "width_s": cfg.inject_width_s, "sec": INJECT_SEC},
        "step_seconds": first["step_seconds"],
        "topk_stats": first["topk_stats"], "beams": first["beams"],
        "coadd": first["coadd"], "weights_mean": first["weights_mean"],
        "pass": all(c["pass"] for c in calls),
        "device": {"kind": torch.cuda.get_device_name(mesh.device),
                   "ranks": world},
        "calls": calls}
    if mesh.d == 0:
        print(json.dumps(report, indent=1), flush=True)
    dist.destroy_process_group()
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
