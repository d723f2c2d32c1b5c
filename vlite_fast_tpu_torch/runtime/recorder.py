"""Manual/periodic trigger issuing (the recorder.py role,
ref src/recorder.py:31-60): exercise the dump path without real events,
either as a one-shot burst of N seconds or a steady 1 s-per-interval drip.

The port's copy of vlite_fast_tpu/runtime/recorder.py, on the port's
Trigger.
"""

from __future__ import annotations

import time
from typing import Callable, Iterator, Optional

from vlite_fast_tpu_torch.runtime.trigger import Trigger


def burst_triggers(t0: float, seconds: float, sn: float = 0.0,
                   meta: str = "recorder burst") -> Trigger:
    """One trigger covering [t0, t0+seconds] (recorder 'burst' mode)."""
    return Trigger(t0=t0, t1=t0 + seconds, sn=sn, dm=0.0, width=0.0,
                   peak_time=t0, meta=meta)


def periodic_triggers(start: float, interval: float = 1.0,
                      duration: float = 1.0,
                      count: Optional[int] = None) -> Iterator[Trigger]:
    """Generator of triggers of `duration` seconds every `interval`
    seconds of data time (recorder '1 s/s' mode)."""
    n = 0
    t = start
    while count is None or n < count:
        yield Trigger(t0=t, t1=t + duration, sn=0.0, dm=0.0, width=0.0,
                      peak_time=t, meta=f"recorder periodic {n}")
        t += interval
        n += 1


def run_recorder(send: Callable[[Trigger], None], interval: float = 1.0,
                 duration: float = 1.0, count: int = 10,
                 realtime: bool = False) -> int:
    """Issue `count` periodic triggers through `send` (e.g. a dumper's
    dump method or a CommandBus publisher)."""
    sent = 0
    for trig in periodic_triggers(time.time(), interval, duration, count):
        send(trig)
        sent += 1
        if realtime:
            time.sleep(interval)
    return sent
