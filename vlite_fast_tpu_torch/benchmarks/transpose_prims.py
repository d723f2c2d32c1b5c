"""Transpose-primitive timings on the card: the port of the JAX package's
benchmarks/bench_transpose_prims_tpu.py.

    python -m vlite_fast_tpu_torch.benchmarks.transpose_prims [iters]

(a) times the relayout kernel (ops/megakernel.pallas_pretranspose,
csrc/pretranspose.cu) on one production second of uniform bytes, u8 and
bf16 tiles (the TPU script's mxu/xlu variants are a TPU implementation
choice: the port has one route per dtype).  (b) times tile_bench: each of
REPS = 320 grid steps sums NB = 128 (128, 128) f32 tiles of a (16384, 128)
input, each tile left as it is ('none'), transposed ('xlu') or transposed
by a bf16 identity product with f32 accumulation ('mxu'), in the CUDA
kernel csrc/tile_bench.cu (one block per grid step, see its header).
Inputs come from numpy default_rng(7) in the TPU script's order (the
second's bytes, then one standard-normal input per mode); times are
device times from CUDA events, printed as the TPU script prints them.
Needs one NVIDIA GPU.

tile_sum is the kernel's wrapper: a CPU tensor goes to tile_sum_plain
(the same adds in the same order), a CUDA tensor launches the kernel or
raises; LAUNCHES counts its launches.
"""

from __future__ import annotations

import ctypes
import sys
import time
import numpy as np
import torch

from vlite_fast_tpu_torch import _build, devices
from vlite_fast_tpu_torch.config import PipelineConfig
from vlite_fast_tpu_torch.ops import megakernel as mk

LANE = 128
NB = 128             # tiles per grid step
REPS = 320           # grid steps, as seg_per_sec
IMPLS = ("none", "xlu", "mxu")
LAUNCHES = 0


def tile_sum_plain(x: torch.Tensor, impl: str) -> torch.Tensor:
    """The (128, 128) sum of the (128, 128) tiles of x (nb * 128, 128)
    f32, in tile order, each tile as it is ('none'), transposed ('xlu'),
    or rounded to bf16 and transposed ('mxu': the identity product's
    value, exact in f32)."""
    if impl not in IMPLS:
        raise ValueError(f"tile_sum: impl {impl!r} not in {IMPLS}")
    acc = torch.zeros((LANE, LANE), dtype=torch.float32, device=x.device)
    for b in range(x.shape[0] // LANE):
        xb = x[b * LANE:(b + 1) * LANE]
        if impl == "mxu":
            xb = xb.to(torch.bfloat16).to(torch.float32)
        acc = acc + (xb if impl == "none" else xb.t())
    return acc


def tile_sum(x: torch.Tensor, impl: str, reps: int = REPS) -> torch.Tensor:
    """tile_sum_plain(x, impl), on a CUDA tensor by csrc/tile_bench.cu with
    `reps` blocks, each computing (and writing) the whole sum."""
    global LAUNCHES
    if impl not in IMPLS:
        raise ValueError(f"tile_sum: impl {impl!r} not in {IMPLS}")
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != LANE \
            or x.shape[0] % LANE or not x.shape[0] or not x.is_contiguous():
        raise ValueError("tile_sum: x must be contiguous f32 (nb * 128, 128)")
    if reps < 1:
        raise ValueError("tile_sum: reps must be >= 1")
    if x.device.type == "cpu":
        return tile_sum_plain(x, impl)
    if x.device.type != "cuda":
        raise ValueError(f"tile_sum: unsupported device {x.device}")
    out = torch.empty((LANE, LANE), dtype=torch.float32, device=x.device)
    lib = _build.load("tile_bench")
    fn = lib.vf_tile_bench
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, i, i, p, p]
    fn.restype = ctypes.c_int
    _build.check(fn(p(x.data_ptr()), x.shape[0] // LANE, IMPLS.index(impl),
                    reps, p(out.data_ptr()),
                    p(torch.cuda.current_stream(x.device).cuda_stream)),
                 "vf_tile_bench", lib)
    LAUNCHES += 1
    return out


def _device_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call over iters calls (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def tile_bench(impl: str, device="cuda", iters: int = 10,
               rng: np.random.Generator = None) -> tuple:
    """The TPU script's tile_bench(impl): draws the (NB * 128, 128) input
    from rng, runs tile_sum once, then times `iters` calls and prints the
    script's line.  Returns (input, sum, device ms per call).  On the CPU
    the plain version runs once and no time is taken (ms None)."""
    device = devices.resolve(device)
    rng = np.random.default_rng(7) if rng is None else rng
    x = torch.from_numpy(rng.standard_normal((NB * LANE, LANE)).astype(
        np.float32)).to(device)
    y = tile_sum(x, impl)
    if device.type != "cuda":
        print(f"tile-transpose[{impl}]: plain version on the CPU, not timed",
              flush=True)
        return x, y, None
    torch.cuda.synchronize()
    ms = _device_ms(lambda: tile_sum(x, impl), iters)
    per_tile_ns = ms * 1e-3 / (REPS * NB) * 1e9
    print(f"tile-transpose[{impl}]: {ms:.2f} ms for {REPS}x{NB} tiles = "
          f"{per_tile_ns:.0f} ns/tile", flush=True)
    return x, y, ms


def pretranspose_bench(raw: torch.Tensor, cfg: PipelineConfig,
                       iters: int) -> None:
    """(a): the relayout kernel per data-second, u8 and bf16 tiles."""
    for name, dtype in (("u8", torch.uint8), ("bf16", torch.bfloat16)):
        args = (raw, cfg.nfft, cfg.npol_in, cfg.seg_per_sec, dtype)
        t0 = time.perf_counter()
        mk.pallas_pretranspose(*args)
        torch.cuda.synchronize()
        print(f"pretranspose[{name}]: build+run "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        ms = _device_ms(lambda: mk.pallas_pretranspose(*args), iters)
        print(f"pretranspose[{name}]: {ms:.2f} ms/data-s", flush=True)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    iters = int(argv[0]) if argv else 10
    if not torch.cuda.is_available():
        raise SystemExit("transpose_prims: needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    print("device", torch.cuda.get_device_name(dev), flush=True)
    cfg = PipelineConfig()
    rng = np.random.default_rng(7)
    raw = torch.from_numpy(rng.integers(1, 256, (cfg.npol_in,
                                                 cfg.sample_rate),
                                        np.uint8)).to(dev)
    pretranspose_bench(raw, cfg, iters)
    del raw
    for impl in IMPLS:
        tile_bench(impl, dev, iters, rng)


if __name__ == "__main__":
    main()
