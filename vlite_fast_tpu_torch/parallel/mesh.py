"""Process-group mesh for the (ant, time) decomposition.

Port of vlite_fast_tpu/parallel/mesh.py on torch.distributed.  The
reference scales by pure antenna data-parallelism across 12 hosts plus an
MPI reduce for the coadd (SURVEY.md section 2d).  The mesh maps:

  'ant'  — antennas sharded over ranks; the cross-antenna coadd is an
           all_reduce over this axis (replaces agdadacoadd's MPI reduce).
  'time' — time-blocks of the search/offline stages sharded over ranks
           with overlap-save halos exchanged between neighbors (replaces
           the reference's gulp overlap inside heimdall).

The ranks lie row-major, as the JAX package's reshape(n_ant, n_time) of
its devices: mesh position d = a * n_time + t is world rank d, and a
leading axis sharded P(('ant','time')) puts rows [d*m, (d+1)*m) on it.
One rank is one device.  A mesh holds one process group per line of
each axis; every rank of the default group takes part in creating every
group, in the same order, members or not, as torch.distributed requires.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from vlite_fast_tpu_torch.parallel.distributed import rank_device

AXES = ("ant", "time")


@dataclass(frozen=True, eq=False)
class Mesh:
    """An (ant, time) layout of the first n_ant * n_time world ranks."""

    shape: dict                 # {"ant": n_ant, "time": n_time}
    d: Optional[int]            # this rank's mesh position; None outside
    device: torch.device        # this rank's device
    group: object = None        # the whole mesh's group (None outside)
    groups: dict = None         # axis -> the group of this rank's line
    lines: dict = None          # axis -> world ranks of this rank's line

    @property
    def size(self) -> int:
        return self.shape["ant"] * self.shape["time"]

    def index(self, axis: str) -> int:
        """This rank's index along `axis`."""
        a, t = divmod(self.d, self.shape["time"])
        return a if axis == "ant" else t


def make_mesh(n_ant: int = 0, n_time: int = 0,
              world: Optional[int] = None) -> Mesh:
    """Build an (ant, time) mesh over the first n_ant * n_time of `world`
    ranks (default: the whole process group).  With no sizes, every rank
    goes on the 'ant' axis (the dominant parallelism at array scale).
    The rank's device follows the group's backend (rank_device).
    Collective: every rank of the default group calls it alike."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group "
                           "(parallel.distributed.init_distributed)")
    size = dist.get_world_size()
    n = size if world is None else world
    if n > size:
        raise ValueError(f"world {n} > {size} ranks in the process group")
    if n_ant == 0 and n_time == 0:
        n_ant, n_time = n, 1
    elif n_ant == 0:
        n_ant = n // n_time
    elif n_time == 0:
        n_time = n // n_ant
    if n_ant * n_time > n:
        raise ValueError(f"mesh {n_ant}x{n_time} > {n} devices")
    me = dist.get_rank()
    d = me if me < n_ant * n_time else None
    line_ranks = {
        "time": [[a * n_time + t for t in range(n_time)]
                 for a in range(n_ant)],
        "ant": [[a * n_time + t for a in range(n_ant)]
                for t in range(n_time)]}
    group = dist.new_group(list(range(n_ant * n_time)))
    groups, lines = {}, {}
    for axis in AXES:
        for ranks in line_ranks[axis]:
            g = dist.new_group(ranks)
            if me in ranks:
                groups[axis], lines[axis] = g, tuple(ranks)
    return Mesh(shape={"ant": n_ant, "time": n_time}, d=d,
                device=rank_device(),
                group=group if d is not None else None,
                groups=groups, lines=lines)
