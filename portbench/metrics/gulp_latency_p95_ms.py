"""The 95th percentile, over every gulp searched in the window, of the
host wall from the start of the feed_second call that handed over the
gulp's last data-second to the return of the call that searched it (the
call in which vfast_gulps_searched rose): the pipeline's own share of
candidate latency, queue wait for the card included."""

import numpy as np


def read(run):
    lat = run.gulp_latency_s
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
