"""The share of the profiled sub-window in which no operation ran on the
device (the union of the device operations' intervals, torch.profiler)."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
