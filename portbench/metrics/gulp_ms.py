"""Device time a gulp: the device operations launched under the
vfast.gulp_search range in the profiled sub-window, over its gulps."""

from portbench.metrics import _trace


def read(run):
    return _trace.per_instance_ms(run, "vfast.gulp_search")
