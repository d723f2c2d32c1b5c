"""The median, over the window's station-seconds, of the host span that
wrote the second into its station's voltage ring (the "ring" spans of
the station's second records, utils/spans; drivers/array_host)."""

import numpy as np


def read(run):
    v = run.ring_s
    return 1e3 * float(np.median(v)) if v else None
