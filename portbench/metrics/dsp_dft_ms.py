"""The CT DFT on the card (its GEMMs and twiddles).  CUDA events around the
stages of baseband_dsp.process_second, read in the second's record: the
median over the window's process_second calls of the device stage "dft",
both streams, in ms."""

from portbench.metrics import _spans


def read(run):
    w = _spans.window(run)
    return _spans.stage_median_ms(w[0], "dft") if w else None
