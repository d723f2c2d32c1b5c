"""Where the time goes on the card: a torch.profiler trace of the main path.

    python -m vlite_fast_tpu_torch.trace [--twin auto|same|xla|megakernel|
                                          megakernel2|megakernel3|
                                          megakernel3f|megakernel4]

At the production geometry (PipelineConfig(inject_frb=True,
twin_chain_impl=TWIN), SearchConfig()) it first traces, in the fresh
process with the kernels built and loaded, the first call of the armed
second and of the gulp ("cold": every first-use cost of the process falls
there; the host's operations by their own CPU time are listed too), then
one window each after a warm-up call:
  twin   one injection-free second through the twin program that TWIN
         resolves to (baseband_dsp.twin_program; 'auto', the default,
         is the v2 chain kernel);
  armed  one armed second through process_second (injection on): the
         RFI front kernel, the torch.matmul channelize and injection,
         both EMA kernels, the scrunches and the pack;
  gulp   one production gulp search from packed bytes on the device
         (dequantize, dedispersion kernel, boxcar S/N, banded top-k).
For each window it prints the wall time, the summed device time of the
kernels and the device busy share (device time / wall), then the kernels
by device time; then the peak device memory of the armed second and of
the whole run.
Needs one NVIDIA GPU; data from seeded numpy generators.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from vlite_fast_tpu_torch import _build
from vlite_fast_tpu_torch.config import PipelineConfig, SearchConfig
from vlite_fast_tpu_torch.models import baseband_dsp as dsp
from vlite_fast_tpu_torch.models import search as search_mod


def _device_us(evt) -> float:
    """Device time (us) of a key_averages() row."""
    if hasattr(evt, "device_time_total"):
        return float(evt.device_time_total)
    return float(evt.cuda_time_total)


def traced(name: str, fn, top: int = 8, warm: bool = True) -> None:
    """Print fn's wall, device time and busy share, and its kernels by
    device time; warm=False: trace the first call, and list the host's
    operations by their own CPU time besides."""
    if warm:
        fn()                               # warm-up (allocator, cuBLAS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the kernels' own rows (the CPU ops that launched them carry the same
    # time again)
    rows = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    dev = sum(r[1] for r in rows) / 1e6
    print(f"[{name}] wall {wall * 1e3:.1f} ms, device {dev * 1e3:.1f} ms, "
          f"busy {100 * dev / wall:.1f}%", flush=True)
    for key, us, n in sorted(rows, key=lambda r: -r[1])[:top]:
        print(f"[{name}]   {us / 1e3:9.2f} ms  x{n:<6d} {key[:90]}")
    if not warm:
        host = [(e.key, e.self_cpu_time_total, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CPU]
        for key, us, n in sorted(host, key=lambda r: -r[1])[:top]:
            print(f"[{name}]   host {us / 1e3:9.2f} ms  x{n:<6d} {key[:80]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--twin", default="auto",
                    help="twin_chain_impl of the traced twin second")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("trace: needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    cfg = PipelineConfig(inject_frb=True, twin_chain_impl=args.twin)
    scfg = SearchConfig()
    rng = np.random.default_rng(0)
    raw = torch.from_numpy(np.clip(
        rng.standard_normal((cfg.npol_in, cfg.sample_rate)) / 0.05914
        + 128.5, 0, 255).astype(np.uint8)).to(dev)
    twin, twin_cfg = dsp.twin_program(cfg), dsp.twin_config(cfg)
    print(f"twin_chain_impl {args.twin!r}: {twin.__name__} with chain_impl "
          f"{twin_cfg.chain_impl!r}", flush=True)
    _build.load_all()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.synchronize()           # the profiler's own first use
    state = dsp.init_state(cfg, dev)
    eng = search_mod.SinglePulseSearch(scfg, cfg.tsamp, cfg.freqs_mhz(),
                                       device=dev)
    full = scfg.gulp_samps + eng.overlap
    gulp = lambda: eng.search_gulp_device(packed, cfg.nbit, 0,
                                          scfg.gulp_samps)
    traced("armed, cold", lambda: dsp.process_second(cfg, raw, state, True),
           warm=False)
    out, state = twin(twin_cfg, raw, state)
    packed = out.packed_kur.repeat(full // out.packed_kur.shape[0] + 1,
                                   1)[:full].contiguous()
    traced("gulp, cold", gulp, warm=False)

    traced("twin", lambda: twin(twin_cfg, raw, state))
    torch.cuda.reset_peak_memory_stats(dev)
    traced("armed", lambda: dsp.process_second(cfg, raw, state, True),
           top=16)
    armed_peak = torch.cuda.max_memory_allocated(dev) / 2**30

    traced("gulp", gulp)
    print(f"peak device memory: armed second {armed_peak:.2f} GiB, run "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)


if __name__ == "__main__":
    main()
