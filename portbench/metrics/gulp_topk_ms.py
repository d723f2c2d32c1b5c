"""The gulp's banded top-k on the card.  CUDA events around the stages of
search._device_gulp, read in the gulp's record: the median over the
window's gulps of the device stage "topk", in ms."""

from portbench.metrics import _spans


def read(run):
    w = _spans.window(run)
    return _spans.stage_median_ms(w[1], "topk") if w else None
