"""The share of the array's antenna-seconds that process_second handed
to a fused launch (the chain kernel of the configuration's twin, or the
pfb WOLA kernel), because the injected track cannot reach them: a call
record's counter "fused_seconds" over its counter "antenna_seconds", the
median over the window's calls.  No value where no call record has the
counter (a program that hands no second off, or keeps no call records)."""

from portbench.metrics import _calls


def read(run):
    if not any("fused_seconds" in r.counters
               for r in getattr(run, "calls", ())):
        return None
    return _calls.median(run, lambda r: r.counters.get("fused_seconds", 0)
                         / r.counters["antenna_seconds"])
