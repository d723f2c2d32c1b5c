"""The array step's share of its roofline: the least time of a call
(portbench/work/array_counts.call_work, at the share of frames the
reference found masked) over the device time of the operations launched
under vfast.array_call, a call."""

from portbench.metrics import _trace
from portbench.work import array_counts


def read(run):
    ms = _trace.per_instance_ms(run, "vfast.array_call")
    if not ms or run.masked_share is None:
        return None
    least = array_counts.call_work(run.cell.config,
                                   run.masked_share)["seconds"]
    return 100.0 * least / (ms / 1e3)
