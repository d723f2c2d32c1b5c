"""Antennas a card keeps in real time: the data-seconds fed in the
window over the window's wall, to its closing synchronize (host clock).
One antenna in real time is 1.0."""


def read(run):
    return run.window_data_s / run.window_s if run.window_s > 0 else None
