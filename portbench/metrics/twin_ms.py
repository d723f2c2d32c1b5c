"""The twin program's span a data-second: the median over the window's
twin seconds of StationPipeline.feed_seconds["twin"] (CUDA events on the
device's timeline).  The median, since the one twin second in twelve
whose call also searches a gulp carries the gulp's device time in its
span."""

import numpy as np


def read(run):
    return 1e3 * float(np.median(run.twin_spans)) if run.twin_spans \
        else None
