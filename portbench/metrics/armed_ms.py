"""The armed program's span a data-second: the median over the window's
armed seconds of StationPipeline.feed_seconds["armed"] (CUDA events); an
armed second whose call also searches a gulp carries the gulp's device
time in its span."""

import numpy as np


def read(run):
    return 1e3 * float(np.median(run.armed_spans)) if run.armed_spans \
        else None
