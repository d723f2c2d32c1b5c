"""Reading a torch.profiler trace (Chrome JSON) of the profiled
sub-window.

Device operations (kernels, copies, sets) are attributed to the host's
`vfast.*` range in which they were launched: each operation's correlation
id leads to its launch call on the host (the CUDA runtime or driver call
with the same id), and the range on the host's timeline that holds that
call is its range, whatever the kernel's name.  The window is the
`portbench.window` range, which ends with a synchronize.

analyse() returns:
  window_s      the window's length
  busy_s        the union of the device operations' intervals in it
  by_range      {range name: (device seconds, instances of the range)}
  unattributed  device seconds with no launch in a vfast range
  device_ops    the 10 device operations that took most time, by name
  idle_gaps     the 10 longest gaps with no device operation, each named
                by the vfast range the host was in at its start
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "portbench.window"
RANGE_PREFIX = "vfast."


def analyse(path) -> dict:
    with open(path) as fp:
        events = json.load(fp)["traceEvents"]
    xs = [e for e in events if e.get("ph") == "X"]
    win = next(e for e in xs if e.get("cat") == "user_annotation"
               and e["name"] == WINDOW)
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]) for e in xs
                    if e.get("cat") == "user_annotation"
                    and e["name"].startswith(RANGE_PREFIX))
    starts = [r[0] for r in ranges]

    def range_at(ts: float):
        """The vfast range (they do not nest) the host was in at ts."""
        i = bisect.bisect_right(starts, ts) - 1
        return ranges[i][2] if i >= 0 and ts <= ranges[i][1] else None

    launch = {}
    for e in xs:
        if e.get("cat") in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch[corr] = float(e["ts"])
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    by_range = defaultdict(float)
    unattributed = 0.0
    per_name = defaultdict(float)
    spans = []
    for e in dev:
        a, d = float(e["ts"]), float(e["dur"])
        lo, hi = max(a, w0), min(a + d, w1)
        if hi <= lo:
            continue
        spans.append((lo, hi))
        per_name[e["name"]] += (hi - lo) / 1e6
        corr = (e.get("args") or {}).get("correlation")
        name = range_at(launch[corr]) if corr in launch else None
        if name is None:
            unattributed += d / 1e6
        else:
            by_range[name] += d / 1e6
    merged = []
    for lo, hi in sorted(spans):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    busy = sum(hi - lo for lo, hi in merged)
    gaps, prev = [], w0
    for lo, hi in merged:
        if lo > prev:
            gaps.append((prev, lo))
        prev = hi
    if prev < w1:
        gaps.append((prev, w1))
    counts = defaultdict(int)
    for a, b, name in ranges:
        if w0 <= a <= w1:
            counts[name] += 1
    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy / 1e6,
        "by_range": {n: (by_range.get(n, 0.0), counts[n])
                     for n in set(counts) | set(by_range)},
        "unattributed": unattributed,
        "device_ops": [[n[:160], s] for n, s in sorted(
            per_name.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[range_at(a) or "outside vfast ranges", (b - a) / 1e6]
                      for a, b in gaps[:10]],
    }
