"""The coadd on the card a call: the device stages "coadd" (the beams'
sum, the all_reduce and the scale) and "coadd_search" of a call's
record, the median over the window's calls, in ms."""

from portbench.metrics import _calls


def read(run):
    v = _calls.median(run, lambda r: _calls.stages_s(r,
                                                     _calls.COADD_STAGES))
    return None if v is None else 1e3 * v
