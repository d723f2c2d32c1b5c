"""Two-stage subband dedispersion: hand-written CUDA kernel + plain version.

Replaces the TPU kernel vlite_fast_tpu/ops/dedisperse_pallas.py:
dedisperse_pallas (Pallas bodies _stage1_fold_kernel, _stage2_fold_kernel).
The CUDA source is csrc/dedisperse.cu (C entries vf_dedisp_stage1 and
vf_dedisp_stage2).  On the card it is bound by its shifted reads (~14G
in stage 1, ~9.6G in stage 2 per production gulp); the simple design
orders the grid so that blocks running together share their inputs in
L2.  The TPU kernel's lane-major overlapped fold and VMEM tiling are TPU
layout: here the kernel reads a channel-major copy of the zapped
filterbank, one thread per output sample.  The source header has the
details.

Dispatch: a CPU tensor goes to the plain version, ops/dedisperse.dedisperse
(the gather engine); a CUDA tensor launches the kernel or raises.
LAUNCHES counts kernel launches (one per call: the stage-1 and stage-2
launches of one gulp).
"""

from __future__ import annotations

import ctypes

import torch

from vlite_fast_tpu_torch import _build
from vlite_fast_tpu_torch.ops import dedisperse as dd

LAUNCHES = 0


def dedisperse_pallas(fb: torch.Tensor, plan: dd.DedispPlan,
                      ntime_out: int) -> torch.Tensor:
    """fb: (ntime, nchan) f32, ntime >= ntime_out + plan.max_delay ->
    (ndm, ntime_out) f32 DM-time plane (zapped channels excluded)."""
    global LAUNCHES
    if fb.device.type == "cpu":
        return dd.dedisperse(fb, plan, ntime_out)
    if fb.device.type != "cuda":
        raise ValueError(f"dedisperse_pallas: unsupported device {fb.device}")
    ntime, nchan = fb.shape
    nsub = plan.nsub
    nbatch = plan.rel_delays.shape[0]
    ndm = plan.sub_delays.shape[0]
    if fb.dtype != torch.float32:
        raise ValueError("fb must be float32")
    if nchan % nsub or tuple(plan.rel_delays.shape) != (nbatch, nchan):
        raise ValueError("plan does not match the filterbank's channels")
    if ntime < ntime_out + plan.max_delay:
        raise ValueError(f"fb has {ntime} samples; needs ntime_out + "
                         f"max_delay = {ntime_out + plan.max_delay}")
    tables = (plan.rel_delays, plan.sub_delays, plan.batch_of_dm)
    if any(t.dtype != torch.int32 or t.device != fb.device
           or not t.is_contiguous() for t in tables):
        raise ValueError("plan tables must be contiguous int32 on "
                         f"{fb.device}")
    lib = _build.load("dedisperse")
    s1, s2 = lib.vf_dedisp_stage1, lib.vf_dedisp_stage2
    i, p = ctypes.c_int, ctypes.c_void_p
    s1.argtypes = [p, i, i, i, p, i, i, p, p]
    s2.argtypes = [p, i, i, p, p, i, i, p, p]
    s1.restype = s2.restype = ctypes.c_int
    # zap, then channel-major so neighbouring threads read neighbouring t
    fbT = (fb * plan.chan_weights[None, :]).t().contiguous()
    t1_len = ntime_out + plan.max_sub_delay
    y = torch.empty((nbatch, nsub, t1_len), dtype=torch.float32,
                    device=fb.device)
    out = torch.empty((ndm, ntime_out), dtype=torch.float32,
                      device=fb.device)
    stream = p(torch.cuda.current_stream(fb.device).cuda_stream)
    ptr = lambda t: p(t.data_ptr())
    _build.check(s1(ptr(fbT), ntime, nchan, nsub, ptr(plan.rel_delays),
                    nbatch, t1_len, ptr(y), stream), "vf_dedisp_stage1", lib)
    _build.check(s2(ptr(y), nsub, t1_len, ptr(plan.sub_delays),
                    ptr(plan.batch_of_dm), ndm, ntime_out, ptr(out), stream),
                 "vf_dedisp_stage2", lib)
    LAUNCHES += 1
    return out
