"""The 95th percentile, over the window's data-seconds, of the lag of
each data-second's hand-over behind the wire time it was due
(drivers/array_host): 0 while the host keeps up."""

import numpy as np


def read(run):
    v = run.lag_s
    return float(np.percentile(v, 95)) if v else None
