"""The armed program's RFI front: CUDA kernel + plain version.

Replaces the TPU kernel vlite_fast_tpu/ops/rfi_pallas.py:rfi_front (body
_front_kernel): u8 convert, kurtosis window statistics, D'Agostino gates
and mask in one pass over a whole second.  The CUDA source is
csrc/rfi_front.cu, one block per FFT block on the statistics of
csrc/front.cuh (shared with the chain kernel's front); it is bound by
memory, 256 MB read and 1 GB written per production second.  The source
header has the details.

Dispatch: a CPU tensor goes to the plain version (convert, then
ops/kurtosis.rfi_excise); a CUDA tensor launches the kernel or raises.
LAUNCHES counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from vlite_fast_tpu import constants as C
from vlite_fast_tpu_torch import _build
from vlite_fast_tpu_torch.ops import kurtosis as kur_ops
from vlite_fast_tpu_torch.ops import unpack as unpack_ops

LAUNCHES = 0


def rfi_front_plain(u: torch.Tensor, nkurto: int, nfft: int,
                    dag_thresh: float = C.DAG_THRESH,
                    dag_fb_thresh: float = C.DAG_FB_THRESH):
    """The plain version: the port's torch kurtosis stage."""
    res = kur_ops.rfi_excise(unpack_ops.convert_uint8(u), nkurto, nfft,
                             dag_thresh=dag_thresh,
                             dag_fb_thresh=dag_fb_thresh)
    return res.masked, res.weights, res.dag


def rfi_front(u: torch.Tensor, nkurto: int, nfft: int,
              dag_thresh: float = C.DAG_THRESH,
              dag_fb_thresh: float = C.DAG_FB_THRESH):
    """(npol, nsamp) uint8 -> (masked f32 (npol, nsamp), weights f32
    (npol, nsamp // nfft), dag f32 (nsamp // nkurto,)): the voltages with
    flagged windows zeroed, the kept fraction of each FFT block, and the
    pol-combined fine-window TS."""
    global LAUNCHES
    if u.device.type == "cpu":
        return rfi_front_plain(u, nkurto, nfft, dag_thresh, dag_fb_thresh)
    if u.device.type != "cuda":
        raise ValueError(f"rfi_front: unsupported device {u.device}")
    npol, nsamp = u.shape
    if u.dtype != torch.uint8 or not u.is_contiguous():
        raise ValueError("rfi_front: u must be contiguous uint8")
    if nfft % nkurto or nsamp % nfft or nsamp == 0:
        raise ValueError(f"rfi_front: nsamp {nsamp} must be a positive "
                         f"multiple of nfft {nfft}, nfft of nkurto {nkurto}")
    dev = u.device
    masked = torch.empty((npol, nsamp), dtype=torch.float32, device=dev)
    weights = torch.empty((npol, nsamp // nfft), dtype=torch.float32,
                          device=dev)
    dag = torch.empty((nsamp // nkurto,), dtype=torch.float32, device=dev)
    lib = _build.load("rfi_front")
    fn = lib.vf_rfi_front
    fn.argtypes = [ctypes.c_void_p] * 7
    fn.restype = ctypes.c_int
    ip = (ctypes.c_longlong * 4)(npol, nsamp, nfft, nkurto)
    fvals = [dag_thresh, dag_fb_thresh, C.DAG_INF,
             *kur_ops.dag_consts(nkurto), *kur_ops.dag_consts(nfft)]
    fp = (ctypes.c_float * len(fvals))(*fvals)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    rc = fn(ctypes.cast(ip, ctypes.c_void_p), ctypes.cast(fp, ctypes.c_void_p),
            ptr(u), ptr(masked), ptr(weights), ptr(dag),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(rc, "vf_rfi_front", lib)
    LAUNCHES += 1
    return masked, weights, dag
