"""The array's DSP on the card an antenna-second: process_second's
device stages (front, wola, dft, detect, ema, pack; CUDA events) of a
call's record over its counter "antenna_seconds", the median over the
window's calls, in ms."""

from portbench.metrics import _calls


def read(run):
    v = _calls.median(run, lambda r: _calls.stages_s(r, _calls.DSP_STAGES)
                      / r.counters["antenna_seconds"])
    return None if v is None else 1e3 * v
