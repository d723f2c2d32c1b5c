"""The median, over the window's data-seconds, of the host wall of one
data-second across all antennas: from the hand-over of its first
antenna's second to the return of its last antenna's feed_second call
(drivers/array_host).  Under 1000 ms the host keeps the wire's rate."""

import numpy as np


def read(run):
    v = run.second_s
    return 1e3 * float(np.median(v)) if v else None
