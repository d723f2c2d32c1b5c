"""Rows handed to the host's clustering (cluster_hits) a call, beams and
coadd: the counter "cluster_rows" of a call's record, the median over
the window's calls."""

from portbench.metrics import _calls


def read(run):
    return _calls.median(run, lambda r: r.counters["cluster_rows"])
