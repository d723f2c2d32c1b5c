"""Time the chain's EMA launch alone on the card, and variants of it.

    python -m vlite_fast_tpu_torch.ema_probe

The launch is csrc/chain.cuh's launch_ema (bandpass_kernel, then
ema_kernel; seed_kernel first where a segment is longer than the bandpass
walk's chunk), called through csrc/chain.cu's vf_chain_ema on
production-size power planes (PipelineConfig(): 2 pols x 10240 spectra x
6251 channels, f32) with blocks of weight 0, of weight between 0 and 1
(flagged in part: the kurtosis plane) and of weight 1, in rfi_mode 0 (the
plain stream), 1 (the weighted stream) and 2 (both).  Each variant is
chain.cu built from a copy of csrc/ under build/ema_probe/<name>/ with
text edits applied to chain.cuh.  A variant marked exact must give the
shipped launch's bytes and bandpass bit for bit (the same arithmetic in
the same order), or the probe fails; the others are diagnostics (a phase
removed).  Per variant and rfi_mode it prints the launch's device time
(CUDA events, mean of 5 after a warm call) and each kernel's (profiler),
and the card's name and power limit.  Needs an NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import ctypes
import dataclasses
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from vlite_fast_tpu_torch import _build
from vlite_fast_tpu_torch.config import PipelineConfig
from vlite_fast_tpu_torch.ops import megakernel as mk

OUT = _build.BUILD_DIR.parent / "ema_probe"


def chain_ema(lib, power, power_kur, partial, weights, bp, cfg):
    """The chain's EMA launch alone (vf_chain_ema of `lib`, a build of
    csrc/chain.cu) on given power planes, f32 (npol, nblk, nchan) each
    (stream 1 reads power_kur where `partial`, u8 (nblk) or None, flags
    the block; everywhere without it); weights f32 (npol, nblk); bp f32
    (2, npol, nchan).  Returns (packed, packed_kur, bp_new) as the chain
    kernels do."""
    dev = power.device
    nrows = cfg.seg_per_sec * cfg.out_samps_per_seg
    packed = torch.zeros((nrows, cfg.nchanout // 4), dtype=torch.uint8,
                         device=dev)
    packed_kur = torch.zeros_like(packed)
    dagcnt = torch.zeros((cfg.seg_per_sec,), dtype=torch.int32, device=dev)
    dag_frac = torch.empty((cfg.seg_per_sec,), dtype=torch.float32,
                           device=dev)
    bp_out = bp.clone()
    ivals, fvals = mk._chain_params(cfg, 0)
    ip = (ctypes.c_longlong * len(ivals))(*ivals)
    fp = (ctypes.c_float * len(fvals))(*fvals)
    fn = lib.vf_chain_ema
    fn.argtypes = [ctypes.c_void_p] * 14
    fn.restype = ctypes.c_int
    seeds = mk._ema_seeds(power.shape[0], cfg.seg_per_sec, cfg.nchan, dev)
    rc = fn(ctypes.cast(ip, ctypes.c_void_p), ctypes.cast(fp, ctypes.c_void_p),
            *(mk._ptr(t) for t in (power, power_kur, partial, weights, bp,
                                   dagcnt, seeds, packed, packed_kur,
                                   dag_frac, bp_out)),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(rc, "vf_chain_ema", lib)
    return packed, packed_kur, bp_out


# name -> (exact, [(text in chain.cuh, replacement)])
VARIANTS = {
    "shipped": (True, []),
    # the seeds from seed_kernel even where a segment fits the walk's chunk
    "seed_kernel": (True, [("const bool fused = P.ffts <= kBpChunk;",
                            "const bool fused = false;"),
                           ("  if (P.ffts > kBpChunk) {", "  if (true) {")]),
    # the bandpass walk's ring one chunk deeper; its blocks half as wide
    "bp_stages4": (True, [("constexpr int kBpStages = 3;",
                           "constexpr int kBpStages = 4;")]),
    "bp_threads32": (True, [("constexpr int kBpThreads = 64;",
                             "constexpr int kBpThreads = 32;")]),
    # diagnostics: the bandpass walk's loads without its recurrence; a
    # multiply in place of the divide by a weight below 1
    "bp_loads_only": (False, [
        ("ema_step<s>(P, xs[u * kBpThreads], (good >> u) & 1, bp);",
         "bp = __fadd_rn(bp, xs[u * kBpThreads]);")]),
    "no_weight_div": (False, [("(w == 1.0f ? v : __fdiv_rn(v, w))",
                               "(w == 1.0f ? v : __fmul_rn(v, w))"),
                              ("__fdiv_rn(xs[u * kBpThreads], ws[u])",
                               "__fmul_rn(xs[u * kBpThreads], ws[u])")]),
}


def build_variant(name: str) -> Path:
    _, edits = VARIANTS[name]
    d = OUT / name
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(_build.CSRC, d)
    src = (d / "chain.cuh").read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"variant {name}: {old!r} not in chain.cuh")
        src = src.replace(old, new)
    (d / "chain.cuh").write_text(src)
    lib = d / "libchain.so"
    cmd = [_build.nvcc_path(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(lib),
           str(d / "chain.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    (d / "nvcc.log").write_text(res.stdout + res.stderr)
    if res.returncode:
        raise RuntimeError(f"variant {name}: nvcc failed:\n{res.stderr}")
    return lib


def registers(name: str) -> str:
    """ptxas's register count per kernel of a variant's build."""
    out, kernel = [], None
    for line in (OUT / name / "nvcc.log").read_text().splitlines():
        if "Compiling entry function" in line:
            kernel = next((k for k in ("seed_kernel", "bandpass_kernel",
                                       "ema_kernel") if k in line), None)
        elif kernel and "Used" in line and "registers" in line:
            used = line.split("Used")[1].split(",")[0].strip()
            out.append(f"{kernel} {used}")
            kernel = None
    return ", ".join(out)


def planes(cfg: PipelineConfig, dev):
    """Seeded production-size planes: chi-square-like power (uniform 0.5
    .. 1.5), every 7th block flagged in part (weight 0.8, the kurtosis
    plane), every 23rd flagged whole (weight 0)."""
    g = torch.Generator(device=dev).manual_seed(1)
    nblk = cfg.seg_per_sec * cfg.ffts_per_seg
    shape = (cfg.npol_in, nblk, cfg.nchan)
    plain = torch.rand(shape, device=dev, generator=g) + 0.5
    kur = torch.rand(shape, device=dev, generator=g) + 0.5
    w = torch.ones((cfg.npol_in, nblk), device=dev)
    w[:, ::7] = 0.8
    w[:, ::23] = 0.0
    partial = ((w[0] > 0) & (w[0] < 1)).to(torch.uint8)
    bp = torch.zeros((2, cfg.npol_in, cfg.nchan), device=dev)
    return plain, kur, partial, w, bp


def kernel_ms(fn) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            found = re.findall(r"(\w+_kernel)\(", e.key)
            name = found[0] if found else e.key[:40]
            out[name] = out.get(name, 0.0) + e.device_time_total / 1e3
    return out


def event_ms(fn, reps: int = 5) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ema_probe: needs an NVIDIA GPU")
    names = list(VARIANTS)     # "shipped" first: the reference
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"device: {smi}; torch {torch.__version__}", flush=True)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        libs = dict(zip(names, pool.map(build_variant, names)))
    dev = torch.device("cuda")
    base = PipelineConfig()
    data = planes(base, dev)
    ref = {}
    for name in names:
        exact = VARIANTS[name][0]
        lib = ctypes.CDLL(str(libs[name]))
        print(f"{name}: {registers(name)}", flush=True)
        for rfi in (0, 1, 2):
            cfg = dataclasses.replace(base, rfi_mode=rfi)
            call = lambda: chain_ema(lib, *data, cfg)
            out = call()
            torch.cuda.synchronize()
            if name == "shipped":
                ref[rfi] = out
                same = "reference"
            else:
                same = all(torch.equal(a, b) for a, b in zip(out, ref[rfi]))
                if exact and not same:
                    raise SystemExit(f"ema_probe: {name} rfi_mode {rfi} "
                                     "differs from the shipped launch")
                same = "bit-equal" if same else "differs (diagnostic)"
            ms = event_ms(call)
            ks = ", ".join(f"{k} {v:.3f}" for k, v in
                           sorted(kernel_ms(call).items(), key=lambda kv:
                                  -kv[1]) if v > 0.01)
            print(f"{name:14s} rfi_mode {rfi}: {ms:.3f} ms per launch "
                  f"({ks} ms); {same}", flush=True)
    print(f"device: {smi}")


if __name__ == "__main__":
    main()
