"""What the readers of the program's span records share: the records of
the window, from vlite_fast_tpu_torch.utils.spans.last_observation()
(the observation drivers/station.py ran, published by its
end_observation).

The window is the last run.window_data_s data-seconds fed; its gulps are
those searched in the feed_second call of one of those seconds (as
drivers/station.py counts the window's gulps), never those of
end_observation."""

import importlib

import numpy as np

MODULE = "vlite_fast_tpu_torch.utils.spans"


def window(run):
    """(second records, gulp records) of the window; None where the
    program keeps no span records (a checkout without MODULE, as before
    the recorder came) or the window is empty.  An import of MODULE that
    fails inside it raises."""
    try:
        spans = importlib.import_module(MODULE)
    except ModuleNotFoundError as e:
        if e.name != MODULE:
            raise
        return None
    obs = spans.last_observation()
    if obs is None or not obs.seconds or run.window_data_s <= 0:
        return None
    lo = obs.seconds[-1].id + 1 - run.window_data_s
    return ([r for r in obs.seconds if r.id >= lo],
            [g for g in obs.gulps
             if g.counters.get("searched_in", -1) >= lo])


def span_s(rec, name: str):
    """Seconds of the record's span `name`; None without one."""
    s = [x.end - x.start for x in rec.spans if x.name == name]
    return sum(s) if s else None


def stage_median_ms(records, stage: str):
    """The median over `records` holding device stage `stage` of its ms."""
    v = [r.stages[stage] for r in records if stage in r.stages]
    return 1e3 * float(np.median(v)) if v else None
