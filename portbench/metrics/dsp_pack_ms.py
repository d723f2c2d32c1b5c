"""The scrunches and sel_and_dig (trim, quantize, pack) on the card.  CUDA
events around the stages of baseband_dsp.process_second, read in the
second's record: the median over the window's process_second calls of
the device stage "pack", both streams, in ms."""

from portbench.metrics import _spans


def read(run):
    w = _spans.window(run)
    return _spans.stage_median_ms(w[0], "pack") if w else None
