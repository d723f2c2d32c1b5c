"""The multi-rank dry run: one full-array step, armed, on an (ant, time)
mesh of n ranks, with the injected burst recovered in every beam and in
the coadd.

The port's counterpart of the JAX package's
__graft_entry__.dryrun_multichip.  Run it on n local ranks (gloo on the
CPU, or NCCL with one card a rank):

    python -m vlite_fast_tpu_torch.parallel.dryrun N [--device cpu]

or call dryrun_multichip(n) on every rank of a process group of at least
n ranks.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional

import numpy as np


def _require(ok: bool, what) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int) -> Optional[dict]:
    """One full-array step over an n_devices (ant, time) mesh of the
    process group's first n_devices ranks: per-antenna DSP (antennas
    sharded over all ranks, sequential EMA), all_to_all reshard, per-beam
    and coadd (all_reduce over 'ant') top-k searches with overlap halos
    over 'time', the candidate plane decoded on the host.

    The step runs ARMED: the chain's FRB injection fires at second 1 on
    every antenna (the reference's signal test,
    src/process_baseband.cu:1098-1102), and the dry run requires the
    burst at the injected DM in EVERY beam and in the coadd.  Collective:
    every rank of the group calls it.  Returns the summary on the mesh's
    ranks (printed by its first), None on the others."""
    from vlite_fast_tpu_torch.config import (AntennaConfig, ArrayConfig,
                                             PipelineConfig, SearchConfig)
    from vlite_fast_tpu_torch.parallel.mesh import make_mesh
    from vlite_fast_tpu_torch.parallel.sharded_pipeline import (
        build_array_step, extract_candidates, gather_step_output)

    n_time = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    n_ant_mesh = n_devices // n_time
    mesh = make_mesh(n_ant=n_ant_mesh, n_time=n_time, world=n_devices)
    if mesh.d is None:
        return None
    dm_true, nsec = 300.0, 4
    cfg = dataclasses.replace(
        PipelineConfig.tiny(freq_top_mhz=320.5, bandwidth_mhz=0.5),
        inject_frb=True, inject_dm=dm_true, inject_amp=1.3)
    scfg = SearchConfig(dm_min=0.0, dm_max=600.0, ndm=64,
                        gulp_samps=512, boxcar_max=16, zap_ranges=(),
                        snr_thresh=6.0, engine="subband",
                        dm_grid_mode="linear")
    acfg = ArrayConfig(
        antennas=tuple(AntennaConfig(i + 1, f"ea{i + 1:02d}")
                       for i in range(n_devices)),
        pipeline=cfg, search=scfg,
        mesh_ant=n_ant_mesh, mesh_time=n_time)

    step_fn, make_inputs, plan, info = build_array_step(
        acfg, mesh, nsec_per_call=nsec, inject_sec=1)
    out, _ = step_fn(*make_inputs(seed=0))
    full = gather_step_output(out, mesh)
    per_beam, coadd_cands, _ = extract_candidates(full, info, acfg.search)

    dm_step = info.dms[1] - info.dms[0]
    for beam in range(acfg.nant):
        cands = per_beam.get(beam, [])
        _require(cands, f"beam {beam}: injected burst not recovered")
        best = max(cands, key=lambda c: c.snr)
        _require(abs(best.dm - dm_true) <= 4 * dm_step, (beam, best))
    _require(coadd_cands, "injected burst not recovered in the coadd")
    best_co = max(coadd_cands, key=lambda c: c.snr)
    _require(abs(best_co.dm - dm_true) <= 4 * dm_step, best_co)

    summary = {"mesh": dict(mesh.shape),
               "packed_shape": list(full.packed_kur.shape),
               "beams_with_cands": len(per_beam),
               "n_beams": acfg.nant,
               "coadd_cands": len(coadd_cands),
               "coadd_best_dm": round(float(best_co.dm), 1),
               "coadd_best_snr": round(float(best_co.snr), 1),
               "weights_mean": round(
                   float(np.asarray(full.weights_mean).mean()), 4)}
    if mesh.d == 0:
        print("dryrun_multichip ok:", json.dumps(summary), flush=True)
    return summary


def main(argv=None) -> None:
    from vlite_fast_tpu_torch.parallel.distributed import spawn
    p = argparse.ArgumentParser(prog="vlite_fast_tpu_torch.parallel.dryrun")
    p.add_argument("n", type=int, help="ranks (one device each)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (NCCL, rank r on cuda:r) or 'cpu' (gloo)")
    p.add_argument("--timeout", type=float, default=600.0)
    args = p.parse_args(argv)
    spawn(dryrun_multichip, args.n, args.n, device=args.device,
          timeout=args.timeout)


if __name__ == "__main__":
    main()
