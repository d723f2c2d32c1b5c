"""The work of one call of the array step, counted from a configuration's
shapes (portbench/work/counts.py, whose peaks and counting rules hold):
the least time the card could take for it, whatever implements it.

A call (`call_work`) of nant antennas and nsec seconds:
  - nant x nsec seconds of the armed program (counts.second_work at the
    share `masked` of frames the reference found masked), the burst's
    track counted in the arming second of each antenna;
  - nant + 1 searches (each beam and the coadd) of a c-sample output over
    a c + halo span (counts.gulp_work at a gulp of c = nsec x rows a
    second, with the array's quota of crossings).
The coadd's sum (nant adds a filterbank element) is not counted; the
search's input is counted as packed rows, the least it could be.
"""

from __future__ import annotations

from portbench.reference import coadd as ref_coadd
from portbench.reference import dsp as ref_dsp
from portbench.work import counts


def call_work(config: dict, masked: float) -> dict:
    """The least time of one call of the configuration's array step."""
    dsp, search, arr = config["dsp"], config["search"], config["array"]
    nant, nsec = arr["nant"], arr["nsec_per_call"]
    g = ref_dsp.Geometry.from_settings(dsp)
    armed = counts.second_work(dsp, True, masked)
    plain = counts.second_work(dsp, False, masked)
    gulp = counts.gulp_work(dsp, dict(search, gulp_samps=nsec * g.rows,
                                      topk=ref_coadd.topk(search)))
    part = lambda key: (nant * (armed[key] + (nsec - 1) * plain[key])
                        + (nant + 1) * gulp[key])
    return counts.bound(part("ops"), part("bytes"))
