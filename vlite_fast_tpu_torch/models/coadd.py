"""Multi-antenna incoherent coadd (the agdadacoadd role).

Port of vlite_fast_tpu/models/coadd.py on torch tensors: the
single-host coadd, and coadd_psum, the mesh collective (an all_reduce
over the mesh's antenna axis, parallel/mesh) replacing the reference's
MPI reduce (ref scripts/start_coadd:19-57).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def coadd(fb_stack: torch.Tensor,
          weights: torch.Tensor | None = None) -> torch.Tensor:
    """(nant, ntime, nchan) normalized filterbanks -> (ntime, nchan).

    The sum scaled by 1/sqrt(nant), so unit-variance inputs stay
    unit-variance and the S/N of a common signal grows as sqrt(nant);
    with weights, the weighted sum over the root of the squared weights'
    sum."""
    nant = fb_stack.shape[0]
    if weights is None:
        # the JAX package's float32(1 / sqrt(float32(nant)))
        scale = np.float32(1.0) / np.sqrt(np.float32(nant))
        return fb_stack.sum(dim=0) * float(scale)
    w = weights.reshape(nant, 1, 1).to(fb_stack.dtype)
    wsum = (w ** 2).sum()
    return (fb_stack * w).sum(dim=0) * torch.rsqrt(wsum.clamp(min=1e-12))


def coadd_psum(fb_local: torch.Tensor, mesh, axis_name: str,
               nant_total: int) -> torch.Tensor:
    """Sum this rank's antennas, then all-reduce over the mesh axis
    `axis_name` (the collective replacing the reference's MPI reduce).
    Collective over that axis; every rank of a line gets the sum."""
    total = fb_local.sum(dim=0)
    dist.all_reduce(total, group=mesh.groups[axis_name])
    # the JAX package's float32(1 / sqrt(float32(nant_total)))
    return total * float(np.float32(1.0) / np.sqrt(np.float32(nant_total)))
