"""Overlap-save halo exchange between time-shard neighbors.

Port of vlite_fast_tpu/parallel/halo.py on torch.distributed.  This is
the system's sequence parallelism (SURVEY.md section 5): operations whose
receptive field is the DM smearing time (incoherent dedispersion over a
gulp, coherent chirp convolution) need `halo` samples of lookahead beyond
a shard's own time block.  On the mesh this is a point-to-point exchange
with the neighbors along an axis, the equivalent of genbase's overlap
copy (ref src/genbase.cu:371-390) and heimdall's gulp overlap.

The JAX package's ppermute wraps around the axis and then zeroes what the
stream's end received; so does `ppermute` here, so that every rank posts
the same send and receive and none waits on a missing partner.  On an
axis of size 1 the exchange is the identity, a local copy.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def ppermute(x: torch.Tensor, mesh, axis: str, shift: int) -> torch.Tensor:
    """The block of the rank `shift` places before this one along `axis`
    (wrapping around), this rank's own block going `shift` places on."""
    n = mesh.shape[axis]
    if n == 1:
        return x.clone()
    i, ranks, group = mesh.index(axis), mesh.lines[axis], mesh.groups[axis]
    send = x.contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, ranks[(i + shift) % n], group),
           dist.P2POp(dist.irecv, recv, ranks[(i - shift) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def halo_from_next(x: torch.Tensor, halo: int, mesh, axis: str = "time",
                   dim: int = 0) -> torch.Tensor:
    """Append the first `halo` entries (along `dim`, time) of the *next*
    shard along `axis` to this shard's block.  The last shard (no
    successor) receives zeros, matching the zero-padded tail of a finite
    observation."""
    recv = ppermute(x.narrow(dim, 0, halo), mesh, axis, -1)
    if mesh.index(axis) == mesh.shape[axis] - 1:
        recv.zero_()
    return torch.cat([x, recv], dim=dim)


def halo_from_prev(x: torch.Tensor, halo: int, mesh, axis: str = "time",
                   dim: int = 0) -> torch.Tensor:
    """Prepend the last `halo` entries of the *previous* shard (for
    operations with backward-looking context, e.g. coherent dedispersion
    whose smearing extends earlier in time); the first shard receives
    zeros."""
    recv = ppermute(x.narrow(dim, x.shape[dim] - halo, halo), mesh, axis, 1)
    if mesh.index(axis) == 0:
        recv.zero_()
    return torch.cat([recv, x], dim=dim)
