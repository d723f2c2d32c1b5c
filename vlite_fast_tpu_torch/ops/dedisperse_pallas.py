"""Two-stage subband dedispersion: hand-written CUDA kernels + plain versions.

Replaces the two TPU kernels of vlite_fast_tpu/ops/dedisperse_pallas.py.

dedisperse_pallas (Pallas bodies _stage1_fold_kernel, _stage2_fold_kernel,
with the zap, relayout and refold around them), on the main path, is
csrc/dedisperse.cu (C entries vf_dedisp_stage1 and vf_dedisp_stage2),
through two entries: dedisperse_pallas takes an f32 filterbank, and
dedisperse_pallas_packed the gulp's packed 2-bit rows, which stage 1
unpacks and zaps while it stages them (the gulp never holds an f32
filterbank).  Stage 1 stages a subband's channels for a time tile in
shared memory once and serves every DM batch from there; stage 2 stages
each subband's span of a batch's stage-1 rows and serves every trial of
the batch from there.  They are bound by shared-memory loads (~24 G per
production gulp, one per add); the source header has the details.

Dispatch: a CPU tensor goes to the plain version, ops/dedisperse.dedisperse
(the gather engine; packed: dequantize, then the gather engine); a CUDA
tensor launches the kernel or raises.  LAUNCHES counts kernel launches
(one per call: the stage-1 and stage-2 launches of one gulp), and
PACKED_LAUNCHES those of them made through the packed entry.

dedisperse_pallas_rollsel (bodies _stage1_kernel, _stage2_kernel), the
roll+select engine that the JAX package keeps for an A/B
(benchmarks/bench_ddp_fold_tpu.py): the same function in its own order
of sums, on the same two stages of csrc/dedisperse.cu (C entries
vf_rollsel_stage1 and vf_rollsel_stage2): C1 reads zeros past the
filterbank's end, and C2 sums each chunk of subbands from zero before it
adds the chunk sums.  Its plain version, dedisperse_rollsel_plain, makes
the same adds in the same order, so the two are bit-equal.
ROLLSEL_LAUNCHES counts its calls the same way.
"""

from __future__ import annotations

import ctypes

import torch

from vlite_fast_tpu_torch import _build
from vlite_fast_tpu_torch.ops import dedisperse as dd
from vlite_fast_tpu_torch.ops import quantize as q_ops

LAUNCHES = 0
PACKED_LAUNCHES = 0

# the dequantize LUT of 2-bit levels, as the f32 values it yields
_LUT2 = (ctypes.c_float * 4)(*torch.tensor(q_ops._LEVEL2_CENTROIDS,
                                           dtype=torch.float32).tolist())


def _check_plan(what: str, plan: dd.DedispPlan, nchan: int, ntime: int,
                ntime_out: int, dev) -> None:
    nbatch = plan.rel_delays.shape[0]
    if nchan % plan.nsub or tuple(plan.rel_delays.shape) != (nbatch, nchan):
        raise ValueError(f"{what}: plan does not match the filterbank's "
                         "channels")
    if ntime < ntime_out + plan.max_delay:
        raise ValueError(f"{what}: {ntime} samples; needs ntime_out + "
                         f"max_delay = {ntime_out + plan.max_delay}")
    if plan.sub_spread < 0:
        raise ValueError(f"{what}: the plan's batches are not d // (ndm // "
                         "nbatch) (make_plan's are)")
    if plan.rel_delays_min < 0:
        raise ValueError(f"{what}: negative in-subband delays (make_plan's "
                         "are >= 0 where the first channel of a subband is "
                         "its highest frequency)")
    tables = (plan.rel_delays, plan.sub_delays, plan.chan_weights)
    if any(t.device != dev or not t.is_contiguous() for t in tables) \
            or plan.rel_delays.dtype != torch.int32 \
            or plan.sub_delays.dtype != torch.int32 \
            or plan.chan_weights.dtype != torch.float32:
        raise ValueError(f"{what}: plan tables must be contiguous on {dev}")


def _launch(what: str, src: torch.Tensor, packed: bool, nchan: int,
            plan: dd.DedispPlan, ntime_out: int) -> torch.Tensor:
    """Stage 1 from src (f32 rows or packed 2-bit rows), then stage 2."""
    global LAUNCHES
    src = src.contiguous()
    ntime = src.shape[0]
    _check_plan(what, plan, nchan, ntime, ntime_out, src.device)
    nsub = plan.nsub
    nbatch, ndm = plan.rel_delays.shape[0], plan.sub_delays.shape[0]
    lib = _build.load("dedisperse")
    s1, s2 = lib.vf_dedisp_stage1, lib.vf_dedisp_stage2
    i, p = ctypes.c_int, ctypes.c_void_p
    s1.argtypes = [p, i, ctypes.c_longlong, i, i, i, p, p, p, i, i, i, p, p]
    s2.argtypes = [p, i, i, p, i, i, i, i, p, p]
    s1.restype = s2.restype = ctypes.c_int
    t1_len = ntime_out + plan.max_sub_delay
    y = torch.empty((nbatch, nsub, t1_len), dtype=torch.float32,
                    device=src.device)
    out = torch.empty((ndm, ntime_out), dtype=torch.float32,
                      device=src.device)
    stream = p(torch.cuda.current_stream(src.device).cuda_stream)
    ptr = lambda t: p(t.data_ptr())
    _build.check(s1(ptr(src), int(packed), src.shape[1], ntime, nchan, nsub,
                    ptr(plan.chan_weights), ctypes.cast(_LUT2, p),
                    ptr(plan.rel_delays), nbatch, int(plan.rel_delays_max),
                    t1_len, ptr(y), stream), "vf_dedisp_stage1", lib)
    _build.check(s2(ptr(y), nsub, t1_len, ptr(plan.sub_delays), nbatch,
                    ndm // nbatch, plan.sub_spread, ntime_out, ptr(out),
                    stream), "vf_dedisp_stage2", lib)
    LAUNCHES += 1
    return out


def dedisperse_pallas(fb: torch.Tensor, plan: dd.DedispPlan,
                      ntime_out: int) -> torch.Tensor:
    """fb: (ntime, nchan) f32, ntime >= ntime_out + plan.max_delay ->
    (ndm, ntime_out) f32 DM-time plane (zapped channels excluded)."""
    if fb.device.type == "cpu":
        return dd.dedisperse(fb, plan, ntime_out)
    if fb.device.type != "cuda":
        raise ValueError(f"dedisperse_pallas: unsupported device {fb.device}")
    if fb.dtype != torch.float32:
        raise ValueError("dedisperse_pallas: fb must be float32")
    if fb.dim() != 2:
        raise ValueError("dedisperse_pallas: fb must be (ntime, nchan)")
    return _launch("dedisperse_pallas", fb, False, fb.shape[1], plan,
                   ntime_out)


def dedisperse_packed_plain(packed: torch.Tensor, nbit: int, nchan: int,
                            plan: dd.DedispPlan,
                            ntime_out: int) -> torch.Tensor:
    """The plain version of dedisperse_pallas_packed: dequantize the rows,
    keep the first nchan channels, then the gather engine."""
    fb = q_ops.dequantize(packed, nbit)
    return dd.dedisperse(fb.reshape(fb.shape[0], -1)[:, :nchan], plan,
                         ntime_out)


def dedisperse_pallas_packed(packed: torch.Tensor, nbit: int, nchan: int,
                             plan: dd.DedispPlan,
                             ntime_out: int) -> torch.Tensor:
    """packed: (ntime, nbytes) u8 quantized rows (ops/quantize: channels
    fastest, LSB first), ntime >= ntime_out + plan.max_delay -> the
    (ndm, ntime_out) f32 DM-time plane of their first nchan channels,
    dequantized and zapped: dedisperse_pallas(dequantize(packed)[:, :nchan])
    without the f32 filterbank.  2-bit rows go to the kernel as they are;
    other widths are dequantized first."""
    global PACKED_LAUNCHES
    if packed.device.type == "cpu":
        return dedisperse_packed_plain(packed, nbit, nchan, plan, ntime_out)
    if packed.device.type != "cuda":
        raise ValueError(f"dedisperse_pallas_packed: unsupported device "
                         f"{packed.device}")
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise ValueError("dedisperse_pallas_packed: packed must be (ntime, "
                         "nbytes) uint8")
    if nbit != 2:
        fb = q_ops.dequantize(packed, nbit)
        return dedisperse_pallas(fb.reshape(fb.shape[0], -1)[:, :nchan],
                                 plan, ntime_out)
    if packed.shape[1] * 4 < nchan:
        raise ValueError(f"dedisperse_pallas_packed: {packed.shape[1]} bytes "
                         f"per row hold fewer than {nchan} channels")
    out = _launch("dedisperse_pallas_packed", packed, True, nchan, plan,
                  ntime_out)
    PACKED_LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# The roll+select engine: the same function in the TPU kernel's order of sums
# ---------------------------------------------------------------------------

ROLLSEL_LAUNCHES = 0


def _sub_chunk(nsub: int, sub_chunk: int) -> int:
    """The largest divisor of nsub that is <= sub_chunk (the TPU kernel's
    stage-2 subband chunk)."""
    sc = max(1, min(sub_chunk, nsub))
    while nsub % sc:
        sc -= 1
    return sc


def dedisperse_rollsel_plain(fb: torch.Tensor, plan: dd.DedispPlan,
                             ntime_out: int, sub_chunk: int = 16
                             ) -> torch.Tensor:
    """The plain version of dedisperse_pallas_rollsel, with its adds in its
    order: the zapped filterbank, zero past ntime; stage 1 sums a
    subband's channels in order from zero; stage 2 sums each chunk of sc
    subbands in order from zero and adds the chunk sums in order.  Trial
    d reads batch d // (ndm // nbatch).  fb (ntime, nchan) f32 ->
    (ndm, ntime_out) f32."""
    ntime, nchan = fb.shape
    nsub = plan.nsub
    w = nchan // nsub
    nbatch, ndm = plan.rel_delays.shape[0], plan.sub_delays.shape[0]
    dev = fb.device
    t1_len = ntime_out + plan.max_sub_delay
    fbz = fb * plan.chan_weights[None, :]
    need = t1_len + plan.rel_delays_max
    if need > ntime:
        fbz = torch.cat([fbz, torch.zeros((need - ntime, nchan),
                                          dtype=fbz.dtype, device=dev)])
    fzt = fbz.t()                                   # (nchan, >= need) view
    rel = plan.rel_delays.to(torch.int64)
    t1 = torch.arange(t1_len, device=dev)
    y = torch.empty((nbatch, nsub, t1_len), dtype=torch.float32, device=dev)
    for b in range(nbatch):
        acc = torch.zeros((nsub, t1_len), dtype=torch.float32, device=dev)
        for c in range(w):
            chans = torch.arange(nsub, device=dev) * w + c
            idx = t1[None, :] + rel[b, chans][:, None]
            acc = acc + torch.gather(fzt[chans], 1, idx)
        y[b] = acc
    per_batch = ndm // nbatch
    sc = _sub_chunk(nsub, sub_chunk)
    yf = y.reshape(-1)
    sub_d = plan.sub_delays.to(torch.int64)
    base = (torch.arange(ndm, device=dev)[:, None] // per_batch * nsub
            * t1_len + torch.arange(ntime_out, device=dev)[None, :])
    out = torch.zeros((ndm, ntime_out), dtype=torch.float32, device=dev)
    for s0 in range(0, nsub, sc):
        acc = torch.zeros_like(out)
        for s in range(s0, s0 + sc):
            acc = acc + yf[base + (s * t1_len + sub_d[:, s:s + 1])]
        out = out + acc
    return out


def dedisperse_pallas_rollsel(fb: torch.Tensor, plan: dd.DedispPlan,
                              ntime_out: int,
                              sub_chunk: int = 16) -> torch.Tensor:
    """fb: (ntime, nchan) f32, ntime >= ntime_out + plan.max_delay ->
    (ndm, ntime_out) f32 DM-time plane (zapped channels excluded): the
    roll+select engine's function and order of sums (bit-equal to
    dedisperse_rollsel_plain).  The plan's batches must be uniform (trial
    d in batch d // (ndm // nbatch)), as make_plan makes them."""
    global ROLLSEL_LAUNCHES
    if fb.device.type == "cpu":
        return dedisperse_rollsel_plain(fb, plan, ntime_out, sub_chunk)
    if fb.device.type != "cuda":
        raise ValueError(f"dedisperse_pallas_rollsel: unsupported device "
                         f"{fb.device}")
    ntime, nchan = fb.shape
    nsub = plan.nsub
    nbatch, ndm = plan.rel_delays.shape[0], plan.sub_delays.shape[0]
    if fb.dtype != torch.float32 or not fb.is_contiguous():
        raise ValueError("fb must be contiguous float32")
    if nchan % nsub or tuple(plan.rel_delays.shape) != (nbatch, nchan) \
            or ndm % nbatch:
        raise ValueError("plan does not match the filterbank's channels, "
                         "or its batches are not uniform")
    if ntime < ntime_out + plan.max_delay:
        raise ValueError(f"fb has {ntime} samples; needs ntime_out + "
                         f"max_delay = {ntime_out + plan.max_delay}")
    tables = (plan.rel_delays, plan.sub_delays, plan.chan_weights)
    if any(t.device != fb.device or not t.is_contiguous() for t in tables) \
            or plan.rel_delays.dtype != torch.int32 \
            or plan.sub_delays.dtype != torch.int32 \
            or plan.chan_weights.dtype != torch.float32:
        raise ValueError(f"plan tables must be contiguous on {fb.device}")
    if int(plan.rel_delays.min()) < 0:
        raise ValueError("dedisperse_pallas_rollsel: negative in-subband "
                         "delays (make_plan's are >= 0)")
    if plan.sub_spread < 0:
        raise ValueError("dedisperse_pallas_rollsel: the plan has no "
                         "sub_spread (make_plan's plans have)")
    per_batch = ndm // nbatch
    want = torch.arange(ndm, dtype=torch.int32, device=fb.device) // per_batch
    if not torch.equal(plan.batch_of_dm, want):
        raise ValueError("dedisperse_pallas_rollsel: plan.batch_of_dm is not "
                         "d // (ndm // nbatch)")
    out = _rollsel_stage2(_rollsel_stage1(fb, plan, ntime_out), plan,
                          ntime_out, sub_chunk)
    ROLLSEL_LAUNCHES += 1
    return out


def _rollsel_lib():
    lib = _build.load("dedisperse")
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.vf_rollsel_stage1.argtypes = [p, i, i, p, p, i, i, i, i, p, p]
    lib.vf_rollsel_stage2.argtypes = [p, i, i, p, i, i, i, i, i, p, p]
    lib.vf_rollsel_stage1.restype = ctypes.c_int
    lib.vf_rollsel_stage2.restype = ctypes.c_int
    return lib


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _rollsel_stage1(fb: torch.Tensor, plan: dd.DedispPlan,
                    ntime_out: int) -> torch.Tensor:
    """C1 alone on what dedisperse_pallas_rollsel has checked: the
    (nbatch, nsub, t1_len) stage-1 rows."""
    lib = _rollsel_lib()
    (ntime, nchan), nbatch = fb.shape, plan.rel_delays.shape[0]
    t1_len = ntime_out + plan.max_sub_delay
    y = torch.empty((nbatch, plan.nsub, t1_len), dtype=torch.float32,
                    device=fb.device)
    _build.check(lib.vf_rollsel_stage1(
        _ptr(fb), ntime, nchan, _ptr(plan.chan_weights),
        _ptr(plan.rel_delays), nbatch, plan.nsub, int(plan.rel_delays_max),
        t1_len, _ptr(y), _stream(fb)), "vf_rollsel_stage1", lib)
    return y


def _rollsel_stage2(y: torch.Tensor, plan: dd.DedispPlan, ntime_out: int,
                    sub_chunk: int) -> torch.Tensor:
    """C2 alone on C1's rows: the (ndm, ntime_out) plane."""
    lib = _rollsel_lib()
    nbatch, nsub, t1_len = y.shape
    ndm = plan.sub_delays.shape[0]
    out = torch.empty((ndm, ntime_out), dtype=torch.float32,
                      device=y.device)
    _build.check(lib.vf_rollsel_stage2(
        _ptr(y), nsub, t1_len, _ptr(plan.sub_delays), nbatch, ndm // nbatch,
        plan.sub_spread, _sub_chunk(nsub, sub_chunk), ntime_out, _ptr(out),
        _stream(y)), "vf_rollsel_stage2", lib)
    return out
