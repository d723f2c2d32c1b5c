"""The control of the array host's comparison: the reference in the
program's place, computed one precision step below float32
(reference/dsp's and reference/search's `low`, the coadd summed in
bfloat16), read by check_host's numbers against the float64 reference.

    python3 -m portbench.control_host --workload host8.realtime \
        --seeds <n,n,...>

For each seed it makes each antenna's staged seconds in turn (the
traffic's generator), draws the antenna as a run with that seed draws it
(check_host.draw), and takes the two gulps a run keeps: the burst's
(the gulp holding the window's first second, drivers/array_host
.WINDOW_K0) with that second, and one beside it (the window's others),
with a second drawn in it; it works out with the control: that
antenna's seconds and the
observation's first (DSP numbers, against the float64 reference's);
every antenna's rows of each gulp; that beam's search and the coadd's
search of those rows (search numbers, against the float64 reference's
search of the same rows).  One JSON line of the numbers
(check_array.NUMBERS) per seed.  The control has to fail one of them at
the cell's limits; the benchmark's own runs never run it.  Needs a card
unless --device cpu.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import check as station_check
from portbench import check_array, check_host, spec
from portbench.drivers import array_host
from portbench.reference import dsp as ref_dsp
from portbench.reference import host as ref_host
from portbench.reference import search as ref_search


def control_numbers(cell: spec.Cell, seed: int, device: str) -> dict:
    g = ref_dsp.Geometry.from_settings(cell.config["dsp"])
    s = cell.config["search"]
    nant = cell.config["array"]["nant"]
    rng, ant = check_host.draw(seed, nant)
    plan = ref_search.make_plan(s, g, device)
    gen = spec.generator(cell.traffic)
    staged = [gen.staged_seconds(cell.traffic, cell.config["dsp"], seed,
                                 device, antenna=a) for a in range(nant)]
    tally, co_tally = station_check.Tally(), station_check.Tally()
    burst = array_host.WINDOW_K0 * g.rows // s["gulp_samps"]
    for gulp in (burst, rng.choice((burst - 1, burst + 1))):
        t = time.perf_counter()
        start, stop = ref_host.gulp_span(s, plan, gulp)
        first, last = start // g.rows, (stop - 1) // g.rows
        sec = first if gulp == burst else rng.randrange(first, last + 1)
        lev = []
        for a in range(nant):
            ctl = ref_host.antenna_seconds(g, staged[a], first, last,
                                           low=True)
            if a == ant:
                for k in sorted({0, sec}):
                    o = ctl[k] if k in ctl else ref_host.antenna_seconds(
                        g, staged[a], k, k, low=True)[k]
                    ref = ref_host.antenna_seconds(g, staged[a], k, k)[k]
                    tally.second(o.levels, o.levels_kur, o.weights, o.bp,
                                 o.bp_kur, ref, k)
            rows = torch.cat([ctl[k].levels_kur
                              for k in range(first, last + 1)])
            lev.append(rows[start - first * g.rows:stop - first * g.rows])
            del ctl, rows
        # the searches judged as the program's are: from the control's rows
        ctl_res = ref_host.search_beam(lev[ant], plan, s, start, low=True)
        tally.gulp(ctl_res.cands,
                   ref_host.search_beam(lev[ant], plan, s, start),
                   ctl_res.n_crossings)
        del ctl_res
        ctl_res = ref_host.search_coadd(lev, plan, s, start, low=True)
        co_tally.gulp(ctl_res.cands,
                      ref_host.search_coadd(lev, plan, s, start),
                      ctl_res.n_crossings)
        del ctl_res, lev
        print(f"control: seed {seed} gulp {gulp} antenna {ant} second "
              f"{sec}: the DSP of {nant} x {last + 1 - first} seconds and "
              f"the searches in {time.perf_counter() - t:.1f} s; crossings' "
              f"relative gaps {tally.cross!r} (beam), {co_tally.cross!r} "
              f"(coadd), S/N gaps {tally.snr_gap!r}, {co_tally.snr_gap!r}; "
              f"widest bandpass difference {tally.bp!r}", file=sys.stderr,
              flush=True)
    return check_array.numbers(tally, co_tally)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.control_host",
                                description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    for seed in (int(x) for x in args.seeds.split(",")):
        vals = control_numbers(cell, seed, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": vals, "limits": cell.limits}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
