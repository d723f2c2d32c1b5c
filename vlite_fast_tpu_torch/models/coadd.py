"""Multi-antenna incoherent coadd (the agdadacoadd role).

Port of vlite_fast_tpu/models/coadd.py's single-host coadd on torch
tensors.  The mesh collective beside it there (coadd_psum, a psum over
the antenna axis) waits for the port's parallel/ package.
"""

from __future__ import annotations

import numpy as np
import torch


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
