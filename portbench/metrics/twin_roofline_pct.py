"""The twin program's share of its roofline: the least time of an
un-armed second (portbench/work/counts.second_work, at the share of
frames the reference found masked) over the device time of the
operations launched under vfast.twin_second, a second."""

from portbench.metrics import _trace
from portbench.work import counts


def read(run):
    ms = _trace.per_instance_ms(run, "vfast.twin_second")
    if not ms or run.masked_share is None:
        return None
    least = counts.second_work(run.cell.config["dsp"], False,
                               run.masked_share)["seconds"]
    return 100.0 * least / (ms / 1e3)
