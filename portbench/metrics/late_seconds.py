"""The window's data-seconds handed over more than a second after the
wire time they were due (drivers/array_host): 0 while the host keeps
up."""


def read(run):
    return float(run.late_seconds) if run.lag_s else None
