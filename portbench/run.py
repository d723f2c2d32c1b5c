"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout with BENCHMARK.json.  Prints, as the last
line of standard output, one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics with --trace 0, its
per-layer metrics with --trace 1), `device`, with --trace 1 `breakdown`,
and last `compared`, each number of the comparison beside its limit
(also the last lines of standard error).  Everything else goes to
standard error.

Exits non-zero and prints no result without a CUDA card (or with fewer
than the cell asks for), and when the process has loaded jax, jaxlib,
flax or the JAX package vlite_fast_tpu.  The program's kernel builds and
every compiler cache stay in build/ inside the checkout.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

from portbench import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "vlite_fast_tpu")
CACHE = spec.ROOT / "build" / "portbench" / "cache"


def process_start() -> float:
    """The process's start, unix time (from /proc; now where unreadable)."""
    try:
        with open("/proc/self/stat") as fp:
            ticks = int(fp.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as fp:
            boot = next(int(line.split()[1]) for line in fp
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def card_name() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "power limit not read"


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def execute(cell: spec.Cell, seed: int, seconds: float, trace: bool,
            device: str, t_process: float) -> dict:
    """One run; returns the result line's object (None when a forbidden
    module was loaded)."""
    import torch
    with contextlib.redirect_stdout(sys.stderr):
        run, res = spec.driver(cell).run(cell, seed, seconds, trace,
                                         device, t_process)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = spec.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    on_card = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips if on_card else 1,
           "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": res.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": dev}
    if trace and run.trace:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
        log(f"trace: by range {run.trace['by_range']}, unattributed "
            f"{run.trace['unattributed']:.6f} s")
    out["compared"] = res.compared()
    bad = forbidden_modules()
    if bad:
        log(f"the process loaded {', '.join(bad)}: no result")
        return None
    return out


def emit(out: dict) -> None:
    print(json.dumps(out), flush=True)
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)


def main(argv=None) -> int:
    t_process = process_start()
    p = argparse.ArgumentParser(prog="portbench.run",
                                description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    cell = spec.load_cell(args.workload)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        log(f"needs {cell.chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"{args.workload} seed {args.seed}: torch and the card ready "
        f"{time.time() - t_process:.3f} s after the process's start")
    out = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                  t_process)
    if out is None:
        return 3
    log(f"on {card_name()}")
    emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
