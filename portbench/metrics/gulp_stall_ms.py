"""The card idle because of the host after each gulp: the mean over the
window's gulps of the "stall" span, from the return of the gulp's fetch
(the card's queue then empty) to the next dispatch of a program or a
gulp."""

import numpy as np

from portbench.metrics import _spans


def read(run):
    w = _spans.window(run)
    v = [_spans.span_s(g, "stall") for g in w[1]] if w else []
    v = [x for x in v if x is not None]
    return 1e3 * float(np.mean(v)) if v else None
