"""The median, over the window's data-seconds, of the host span of the
coadd's sum (the "sum" span of CoaddSearcher's "coadd" records,
utils/spans; drivers/array_host); none where the coadd keeps no records."""

import numpy as np


def read(run):
    v = run.coadd_sum_s
    return 1e3 * float(np.median(v)) if v else None
