"""Data-seconds queued on the card ahead of a gulp: the median over the
window's gulps of the counter "ahead_s" taken at each gulp's dispatch
(the seconds fed whose device work had not completed, the one being fed
included)."""

import numpy as np

from portbench.metrics import _spans


def read(run):
    w = _spans.window(run)
    v = [g.counters["ahead_s"] for g in w[1]
         if "ahead_s" in g.counters] if w else []
    return float(np.median(v)) if v else None
