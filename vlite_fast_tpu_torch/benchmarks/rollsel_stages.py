"""Time the roll+select dedispersion and the fold kernel on the card, in
several checkouts of this repository and in variants of this one.

    python -m vlite_fast_tpu_torch.benchmarks.rollsel_stages \\
        [--tree LABEL=DIR ...] [--variant rows16x3] [--rounds 2]

Trees: this checkout ('this'), each --tree (another checkout, unpacked
at DIR, for example by `git archive`), and each --variant (a copy of this
checkout's package under build/rollsel_stages/<name>, with the text edits
of VARIANTS applied to its csrc/dedisperse.cu).  Each tree runs in a
process of its own, in turn, and each round after the first runs them in
the reverse order (a b c, c b a, ...).  A process builds the tree's
kernels from its sources and, on the production gulp (PipelineConfig(),
SearchConfig(): 27225 x 4096 f32 from default_rng(11), 4864 tolerance
trials, nsub 128, nbatch 128) and on the JAX package's
benchmarks/bench_ddp_fold_tpu.py linear 1024-trial gulp:
  - runs dedisperse_pallas_rollsel and checks it bit-equal to
    dedisperse_rollsel_plain;
  - times it (CUDA events, mean of 5 calls after a warm one) and each of
    its two kernels (torch.profiler over 3 calls, device time by kernel
    name: C1 'rollsel_stage1', C2 'rollsel_stage2');
  - times the fold's entries dedisperse_pallas (f32) and
    dedisperse_pallas_packed (2-bit rows from default_rng(12)) the same
    way, and takes sha-256 digests of their planes, which must be equal
    in every tree;
and prints one JSON line.  Then each tree's ptxas report on its
dedispersion kernels, and the card's name and power limit.  Needs an
NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "rollsel_stages"
# name -> [(text in csrc/dedisperse.cu, replacement)]
_RING2 = ("constexpr int kRsRing = 3;", "constexpr int kRsRing = 2;")
_VEC4 = ("constexpr bool kRsVec16 = true;", "constexpr bool kRsVec16 = false;")
_C1_SCALAR = ("stage1_body<false, W, true, true>",
              "stage1_body<false, W, true, false>")
VARIANTS = {
    # C2 at 16 samples x 3 trials a thread (24 trials a block)
    "rows16x3": [("constexpr int kRsRows = 8, kRsTrials = 5;",
                  "constexpr int kRsRows = 16, kRsTrials = 3;")],
    "ring2": [_RING2],                  # two staged groups, not three
    "vec4": [_VEC4],                    # C2 staged by 4-byte copies
    "c1_scalar": [_C1_SCALAR],          # C1 staged by 4-byte loads
    # both stages as first shared with the fold
    "first_pass": [_RING2, _VEC4, _C1_SCALAR],
}
REPS = 5


def _sha256(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def _profile(fn, words) -> dict:
    """Device ms per call of the kernels whose name holds each word."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(words, 0.0)
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "device_time_total", None)
            us = e.cuda_time_total if us is None else us
            for w in words:
                if w in e.key:
                    out[w] += us / 1e3 / 3
    return out


def _events_ms(fn) -> float:
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def worker() -> dict:
    """One tree's measurements (its package first on sys.path)."""
    import dataclasses

    import numpy as np
    import torch

    from vlite_fast_tpu_torch import PipelineConfig, SearchConfig
    from vlite_fast_tpu_torch import constants as C
    from vlite_fast_tpu_torch.models import search
    from vlite_fast_tpu_torch.ops import dedisperse as dd
    from vlite_fast_tpu_torch.ops import dedisperse_pallas as ddp
    dev = torch.device("cuda", 0)
    cfg, scfg = PipelineConfig(), SearchConfig()
    eng = search.SinglePulseSearch(scfg, cfg.tsamp, cfg.freqs_mhz(),
                                   nsub=128, nbatch=128, device=dev)
    plan = eng.plan
    full = scfg.gulp_samps + eng.overlap
    ntime_out = full - plan.max_delay
    fb = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (full, cfg.nchanout)).astype(np.float32)).to(dev)
    packed = torch.from_numpy(np.random.default_rng(12).integers(
        0, 256, (full, cfg.nchanout // 4), dtype=np.uint8)).to(dev)
    lin = dataclasses.replace(scfg, dm_grid_mode="linear", ndm=1024)
    freqs = C.channel_freqs_mhz()[C.CHANMIN:C.CHANMAX + 1]
    lplan = dd.make_plan(dd.dm_grid(lin.dm_min, lin.dm_max, lin.ndm), freqs,
                         cfg.tsamp, nsub=128, nbatch=128,
                         zap_ranges=lin.zap_ranges, device=dev)
    lfb = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (lin.gulp_samps + lplan.max_delay, C.NCHANOUT)).astype(
            np.float32)).to(dev)
    res = {}
    stages = ("rollsel_stage1", "rollsel_stage2")
    for tag, x, p, n in (("", fb, plan, ntime_out),
                         ("linear_", lfb, lplan, lin.gulp_samps)):
        call = lambda: ddp.dedisperse_pallas_rollsel(x, p, n)
        res[f"{tag}bit_equal"] = torch.equal(
            call(), ddp.dedisperse_rollsel_plain(x, p, n))
        res[f"{tag}rollsel_ms"] = _events_ms(call)
        prof = _profile(call, stages)
        res[f"{tag}c1_ms"], res[f"{tag}c2_ms"] = (prof[w] for w in stages)
        fold = lambda: ddp.dedisperse_pallas(x, p, n)
        res[f"{tag}fold_f32_ms"] = _events_ms(fold)
        res[f"{tag}fold_f32_sha256"] = _sha256(fold())
    fold = lambda: ddp.dedisperse_pallas_packed(packed, 2, cfg.nchanout,
                                                plan, ntime_out)
    res["fold_packed_ms"] = _events_ms(fold)
    res["fold_packed_stages_ms"] = _profile(fold, ("stage1_kernel",
                                                   "stage2_kernel"))
    res["fold_packed_sha256"] = _sha256(fold())
    return res


def _variant_root(name: str) -> Path:
    root = OUT / name
    pkg = root / "vlite_fast_tpu_torch"
    if pkg.exists():
        shutil.rmtree(pkg)
    shutil.copytree(ROOT / "vlite_fast_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = pkg / "csrc" / "dedisperse.cu"
    text = src.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} not found once")
        text = text.replace(old, new)
    src.write_text(text)
    return root


def _run(label: str, root: Path) -> dict:
    res = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--worker"],
        cwd=root, env={**os.environ, "PYTHONPATH": str(root)},
        capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"{label}: worker failed\n{res.stderr[-4000:]}")
    out = {"tree": label, **json.loads(res.stdout.strip().splitlines()[-1])}
    print(json.dumps(out), flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--tree", action="append", default=[],
                    help="LABEL=DIR: another checkout of this repository")
    ap.add_argument("--variant", action="append", default=[],
                    choices=sorted(VARIANTS))
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker()), flush=True)
        return
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("rollsel_stages: needs an NVIDIA GPU")
    trees = {"this": ROOT}
    for spec in args.tree:
        label, _, path = spec.partition("=")
        trees[label] = Path(path).resolve()
    for name in args.variant:
        trees[name] = _variant_root(name)
    order = list(trees)
    runs = []
    for r in range(args.rounds):
        for label in (order if r % 2 == 0 else order[::-1]):
            runs.append(_run(label, trees[label]))
    bad = [r["tree"] for r in runs if not (r["bit_equal"]
                                           and r["linear_bit_equal"])]
    digests = {(r["fold_f32_sha256"], r["linear_fold_f32_sha256"],
                r["fold_packed_sha256"]) for r in runs}
    from vlite_fast_tpu_torch import _build
    for label, root in trees.items():
        for log in sorted((root / "build" / "vlite_fast_tpu_torch").glob(
                "libdedisperse*.log")):
            print(f"ptxas {label} {log.name}: "
                  + json.dumps(_build.ptxas_report(log)), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    if bad:
        raise SystemExit(f"rollsel_stages: not bit-equal to the plain "
                         f"version in {bad}")
    if len(digests) != 1:
        raise SystemExit("rollsel_stages: the fold's planes differ between "
                         "trees")


if __name__ == "__main__":
    main()
