"""The control of the array's comparison: the reference in the program's
place, computed one precision step below float32 (reference/dsp's and
reference/search's `low`, the coadd summed in bfloat16), read by
check_array's numbers against the float64 reference.

    python3 -m portbench.control_array --workload array8.coadd \
        --seeds <n,n,...>

For each seed it makes each antenna's staged call in turn (its
generator's antenna_call), draws the
antenna and the second as a run with that seed draws them
(check_array.draw) and a call among the window's first three, and works
out with the control: that antenna's drawn and injected seconds of the
call (DSP numbers, against the float64 reference's); every antenna's
rows over the call's search span, the previous call's last `halo` rows
and the call's; that beam's search and the coadd's search of those rows
(search numbers, against the float64 reference's search of the same
rows).  One JSON line of the numbers (check_array.NUMBERS) per seed.  The
control has to fail one of them at the cell's limits; the benchmark's
own runs never run it.  Needs a card unless --device cpu.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import check as station_check
from portbench import check_array, spec
from portbench.reference import coadd as ref_coadd
from portbench.reference import search as ref_search


def control_numbers(cell: spec.Cell, seed: int, device: str) -> dict:
    g, s, nsec, inject_sec = check_array.settings(cell)
    nant = cell.config["array"]["nant"]
    rng, ant, sec = check_array.draw(seed, nant, nsec)
    call = rng.randrange(1, 4)
    plan = ref_search.make_plan(s, g, device)
    T = nsec * g.rows
    start, stop = call * T - plan.max_delay, call * T + T   # the span
    gen = spec.generator(cell.traffic)
    t = time.perf_counter()
    tally, co_tally = station_check.Tally(), station_check.Tally()
    first, last = start // g.rows, (stop - 1) // g.rows
    lev = []
    for a in range(nant):
        stream = gen.antenna_call(cell.traffic, cell.config["dsp"], seed, a,
                                  device)
        ctl = ref_coadd.antenna_seconds(g, stream, nsec, inject_sec, first,
                                        last, low=True)
        if a == ant:
            for s_ in sorted({sec, inject_sec}):
                k = call * nsec + s_
                ref = ref_coadd.antenna_seconds(g, stream, nsec, inject_sec,
                                                k, k)[k]
                o = ctl[k]
                tally.second(o.levels, o.levels_kur, o.weights, o.bp,
                             o.bp_kur, ref, k)
        rows = torch.cat([ctl[k].levels_kur for k in range(first, last + 1)])
        lev.append(rows[start - first * g.rows:stop - first * g.rows])
        del ctl, rows, stream
    print(f"control: seed {seed} call {call} antenna {ant}: the DSP of "
          f"{nant} x {last + 1 - first} seconds in "
          f"{time.perf_counter() - t:.1f} s", file=sys.stderr, flush=True)
    # the searches judged as the program's are: from the control's rows
    ctl_res = ref_search.search(lev[ant], plan, s, start, low=True)
    tally.gulp(ctl_res.cands, ref_search.search(lev[ant], plan, s, start),
               ctl_res.n_crossings)
    del ctl_res
    ctl_res = ref_coadd.search_fb(ref_coadd.coadd(lev, low=True), plan, s,
                                  start, low=True)
    co_tally.gulp(ctl_res.cands,
                  ref_coadd.search_fb(ref_coadd.coadd(lev), plan, s, start),
                  ctl_res.n_crossings)
    print(f"control: crossings' relative gaps {tally.cross!r} (beam), "
          f"{co_tally.cross!r} (coadd); widest bandpass difference "
          f"{tally.bp!r}; {time.perf_counter() - t:.1f} s",
          file=sys.stderr, flush=True)
    return check_array.numbers(tally, co_tally)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.control_array",
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
