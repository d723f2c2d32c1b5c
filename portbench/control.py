"""The control of the comparison: the reference in the program's place,
computed one precision step below the configuration's float32 (the DFT
in TF32, the kurtosis moments and the search in bfloat16: reference/),
read by the same numbers against the float64 reference.

    python3 -m portbench.control --workload <cell> --seeds <n,n,...>

For each seed it makes the cell's traffic, takes a gulp drawn from the
seed among the observation's first ten and the gulp that holds the
burst of a data-minute drawn from the seed, and prints one JSON line of
the numbers (check.NUMBERS) per seed.  The control has to fail one of
them at the cell's limits; the benchmark's own runs never run it.
Needs a card unless --device cpu.
"""

from __future__ import annotations

import argparse
import json
import random
import sys

from portbench import check, spec
from portbench.reference import dsp as ref_dsp
from portbench.reference import search as ref_search


def gulps(cell: spec.Cell, seed: int, rows: int, overlap: int) -> list:
    """[(start, stop)] of the two gulps a seed's control reads."""
    rng = random.Random(seed)
    gulp = cell.config["search"]["gulp_samps"]
    idx = {rng.randrange(1, 11)}
    if cell.config["dsp"]["inject_frb"]:
        idx.add(rng.randrange(1, 4) * 60 * rows // gulp)
    return [(i * gulp, i * gulp + gulp + overlap) for i in sorted(idx)]


def control_numbers(cell: spec.Cell, seed: int, device: str) -> dict:
    dsp = cell.config["dsp"]
    g = ref_dsp.Geometry.from_settings(dsp)
    plan = ref_search.make_plan(cell.config["search"], g, "cpu")
    staged = spec.generator(cell.traffic).staged_seconds(
        cell.traffic, dsp, seed, device)
    tally = check.Tally()
    for start, stop in gulps(cell, seed, g.rows, plan.max_delay):
        ref = check.reference_seconds(cell, staged, start, stop, g.rows)
        ctl = check.reference_seconds(cell, staged, start, stop, g.rows,
                                      low=True)
        for k, o in ctl.items():
            tally.second(o.levels, o.levels_kur, o.weights, o.bp, o.bp_kur,
                         ref[k])
        # the control's search, judged as the program's is: from its own
        # rows
        lev = check.gulp_rows({k: o.levels_kur for k, o in ctl.items()},
                              start, stop, g.rows)
        ctl_res = check.search(cell, lev, start, low=True)
        tally.gulp(ctl_res.cands, check.search(cell, lev, start),
                   ctl_res.n_crossings)
        del ref, ctl, lev, ctl_res
    vals = tally.values()
    print(f"control: crossings' relative gap {tally.cross!r}, widest "
          f"bandpass difference {tally.bp!r}", file=sys.stderr, flush=True)
    return vals


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.control",
                                description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        vals = control_numbers(cell, seed, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": vals, "limits": cell.limits}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
