"""The 95th percentile over the window's gulps of the crossings' fetch
(each gulp record's "wait" span, utils/spans): the card's queue ahead
of the gulp and the gulp's own device time."""

import numpy as np

from portbench.metrics import _spans


def read(run):
    w = _spans.window(run)
    v = [_spans.span_s(g, "wait") for g in w[1]] if w else []
    v = [x for x in v if x is not None]
    return 1e3 * float(np.percentile(v, 95)) if v else None
