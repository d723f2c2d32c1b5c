"""The gulp's dedispersion on the card, the packed rows' unpack with it.
CUDA events around the stages of search._device_gulp, read in the gulp's
record: the median over the window's gulps of the device stage
"dedisperse", in ms."""

from portbench.metrics import _spans


def read(run):
    w = _spans.window(run)
    return _spans.stage_median_ms(w[1], "dedisperse") if w else None
