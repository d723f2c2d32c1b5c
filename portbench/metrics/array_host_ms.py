"""The host's work on a call's crossings, while the card idles: the
spans "decode" and "cluster" (extract_candidates) of a call's record, the
median over the window's calls, in ms."""

from portbench.metrics import _calls


def read(run):
    v = _calls.median(run, lambda r: sum(r.parts(("decode", "cluster"))
                                         .values()))
    return None if v is None else 1e3 * v
