"""Every CUDA kernel wrapper's launch count, read and reset in one place.

Each wrapper adds one to its count where it launches its kernel (the
wrappers' modules hold the counters: ops/megakernel, ops/dedisperse_pallas,
ops/rfi_pallas, ops/pallas_kernels, ops/boxcar_topk,
benchmarks/transpose_prims).  A
process that runs a path (a station daemon, `cli process`) reports the
counts its path added, by kernel.
"""

from __future__ import annotations


def counts() -> dict:
    """Launches so far in this process, by kernel."""
    from vlite_fast_tpu_torch.benchmarks import transpose_prims as tp
    from vlite_fast_tpu_torch.ops import boxcar_topk as bt
    from vlite_fast_tpu_torch.ops import dedisperse_pallas as ddp
    from vlite_fast_tpu_torch.ops import megakernel as mk
    from vlite_fast_tpu_torch.ops import pallas_kernels as pk
    from vlite_fast_tpu_torch.ops import rfi_pallas
    return {**mk.LAUNCHES, **bt.LAUNCHES, "dedisperse_pallas": ddp.LAUNCHES,
            "dedisperse_pallas_packed": ddp.PACKED_LAUNCHES,
            "dedisperse_pallas_rollsel": ddp.ROLLSEL_LAUNCHES,
            "rfi_front": rfi_pallas.LAUNCHES, **pk.LAUNCHES,
            "tile_bench": tp.LAUNCHES}


def zero() -> None:
    """Set every count to 0."""
    from vlite_fast_tpu_torch.benchmarks import transpose_prims as tp
    from vlite_fast_tpu_torch.ops import boxcar_topk as bt
    from vlite_fast_tpu_torch.ops import dedisperse_pallas as ddp
    from vlite_fast_tpu_torch.ops import megakernel as mk
    from vlite_fast_tpu_torch.ops import pallas_kernels as pk
    from vlite_fast_tpu_torch.ops import rfi_pallas
    ddp.LAUNCHES = ddp.PACKED_LAUNCHES = ddp.ROLLSEL_LAUNCHES = 0
    rfi_pallas.LAUNCHES = tp.LAUNCHES = 0
    for c in (mk.LAUNCHES, pk.LAUNCHES, bt.LAUNCHES):
        c.update(dict.fromkeys(c, 0))


def since(before: dict) -> dict:
    """The launches since `before` (an earlier counts()), by kernel."""
    return {k: v - before.get(k, 0) for k, v in counts().items()}
