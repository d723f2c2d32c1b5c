"""A beam's search on the card in the array step: the device stages
dedisperse (the rows' unpack with it), boxcar and topk of a call's record
over its counter "beams", the median over the window's calls, in ms."""

from portbench.metrics import _calls


def read(run):
    v = _calls.median(run, lambda r: _calls.stages_s(r, _calls.BEAM_STAGES)
                      / r.counters["beams"])
    return None if v is None else 1e3 * v
