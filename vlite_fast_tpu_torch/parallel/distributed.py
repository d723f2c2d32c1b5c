"""Process-group initialization and host-level sharding helpers.

Port of vlite_fast_tpu/parallel/distributed.py on torch.distributed.  The
reference scales across 12 hosts by running independent process chains
plus MPI for the coadd (SURVEY.md section 2d).  Here every rank runs the
same program on one device (cuda:LOCAL_RANK, or the CPU when the caller
asks for it), torch.distributed wires the ranks into one process group
(NCCL on CUDA, gloo on the CPU), data-plane collectives ride NVLink or
the network, and each rank feeds only its own antennas.  There is no
global tensor in torch: `local_shard` hands a rank its rows of a host
array, where the JAX package assembles a globally-sharded array.

`spawn` starts a process group of fresh local processes that rendezvous
through a FileStore (the CPU tests, and `parallel/dryrun`'s entry point);
torchrun does the same across cards (`benchmarks/fullgeom_mesh`).
"""

from __future__ import annotations

import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from vlite_fast_tpu_torch import devices


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     local_rank: Optional[int] = None,
                     device="cuda") -> dict:
    """Initialize the default process group from the arguments or
    torchrun's environment (MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK
    / LOCAL_RANK; init_method 'env://' then).  device 'cuda' takes NCCL
    and cuda:LOCAL_RANK as this rank's device (raising without a card),
    'cpu' takes gloo.  A single process with no rendezvous given still
    gets a one-rank group (on an in-process HashStore), so the mesh code
    runs unchanged.  Returns the topology, with the JAX
    package's keys and this rank's `device`."""
    dev = devices.resolve(device)
    world = int(world_size if world_size is not None
                else os.environ.get("WORLD_SIZE", "1"))
    rank = int(rank if rank is not None else os.environ.get("RANK", "0"))
    local = int(local_rank if local_rank is not None
                else os.environ.get("LOCAL_RANK", rank))
    if dev.type == "cuda":
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        kw = {"device_id": dev} if dev.type == "cuda" else {}
        if init_method is None and "MASTER_ADDR" in os.environ:
            init_method = "env://"
        if init_method is None and world == 1:
            kw["store"] = dist.HashStore()
        elif init_method is None:
            raise ValueError("init_distributed: no rendezvous for "
                             f"{world} ranks (MASTER_ADDR or init_method)")
        else:
            kw["init_method"] = init_method
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                world_size=world, rank=rank, **kw)
    return {"process_index": dist.get_rank(),
            "process_count": dist.get_world_size(),
            "local_devices": 1,
            "global_devices": dist.get_world_size(),
            "device": dev}


def rank_device() -> torch.device:
    """This rank's device: its CUDA device under NCCL, else the CPU."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def local_antenna_slice(nant: int) -> slice:
    """Which antennas this rank captures/feeds: the contiguous block
    matching its position in the group (its rows of a P(('ant','time'))
    leading axis)."""
    count = dist.get_world_size() if dist.is_initialized() else 1
    index = dist.get_rank() if dist.is_initialized() else 0
    per = -(-nant // count)
    lo = index * per
    return slice(lo, min(lo + per, nant))


def local_shard(a: np.ndarray, mesh, device=None) -> torch.Tensor:
    """This rank's rows of a host array whose leading axis is sharded
    over the whole mesh (P(('ant','time'))): rank d holds rows
    [d*m, (d+1)*m), m = len(a) // mesh.size, as a tensor on the mesh's
    device."""
    m = a.shape[0] // mesh.size
    rows = np.ascontiguousarray(a[mesh.d * m:(mesh.d + 1) * m])
    return torch.from_numpy(rows).to(device or mesh.device)


def _rank_main(fn, rank: int, world: int, store: str, device: str,
               args: tuple, results) -> None:
    try:
        if device == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        init_distributed("file://" + store, world, rank, rank, device)
        # pickled here, by value: torch's queue reducers would pass a
        # tensor's storage by a file descriptor this process serves only
        # while it lives
        results.put((rank, True, pickle.dumps(fn(*args))))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, *args, device: str = "cpu",
          timeout: float = 300.0) -> list:
    """fn(*args) on `world` fresh processes forming one process group
    (rank r on cuda:r under NCCL, or the CPU under gloo), rendezvous
    through a FileStore in a temporary directory.  Returns the ranks'
    return values in rank order.  fn must be importable by name (a
    module-level function); its return value is pickled back.  Raises
    on the first rank that fails, on a rank that dies, and after
    `timeout` seconds, and kills every rank still running."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="vfast_spawn_") as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world, os.path.join(tmp, "store"),
                                   device, args, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        got = {}
        deadline = time.monotonic() + timeout
        try:
            while len(got) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"spawn: {world - len(got)} of "
                                       f"{world} ranks still running after "
                                       f"{timeout} s")
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(f"spawn: rank(s) {dead} exited "
                                           "without a result")
                    continue
                if not ok:
                    raise RuntimeError(f"spawn: rank {rank} failed:\n{value}")
                got[rank] = pickle.loads(value)
        finally:
            for p in procs:
                p.join(timeout=5.0)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [got[r] for r in range(world)]
