"""The gulp search's share of its roofline: the least time of a full gulp
(portbench/work/counts.gulp_work) over the device time of the operations
launched under vfast.gulp_search, a gulp."""

from portbench.metrics import _trace
from portbench.work import counts


def read(run):
    ms = _trace.per_instance_ms(run, "vfast.gulp_search")
    if not ms:
        return None
    cfg = run.cell.config
    least = counts.gulp_work(cfg["dsp"], cfg["search"])["seconds"]
    return 100.0 * least / (ms / 1e3)
