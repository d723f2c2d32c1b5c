"""Rows handed to the host's clustering (cluster_hits) a gulp: the mean
over the window's gulps of the counter "cluster_rows"."""

import numpy as np

from portbench.metrics import _spans


def read(run):
    w = _spans.window(run)
    v = [g.counters["cluster_rows"] for g in w[1]
         if "cluster_rows" in g.counters] if w else []
    return float(np.mean(v)) if v else None
