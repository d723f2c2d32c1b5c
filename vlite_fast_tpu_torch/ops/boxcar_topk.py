"""The gulp's boxcar S/N and banded top-k as two CUDA launches, no S/N cube.

csrc/boxcar_topk.cu (C entries vf_boxcar_stats and vf_topk_select)
computes on a CUDA tensor what models/search.pack_topk_banded(
ops/dedisperse.boxcar_snr(dmt, ...)) computes, in float32, without
writing the (nw, ndm, ntime) cube: pass 1 ("boxcar") each DM row's mean,
noise and S/N, the crossings counted and binned by DM band; pass 2
("topk") each band's exact top kb from those bins, sorted.  The source
header has the design.  It replaces no TPU kernel (the JAX package leaves
both to XLA).

models/search.boxcar_topk is the one caller: a CPU tensor takes the torch
composition there, a CUDA tensor these launches or an error.  LAUNCHES
counts each pass's launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from vlite_fast_tpu_torch import _build

LAUNCHES = {"boxcar_snr_stats": 0, "topk_banded_select": 0}

MAX_WIDTHS = 10                   # csrc kMaxW: widths 1 .. 512
NOISE_SUBSAMPLE = 8192            # ops/dedisperse.boxcar_snr's default
NEG_INF_BITS = int(np.float32(-np.inf).view(np.int32))   # an empty slot


def width_scales(widths) -> list:
    """Each width's f32 1/sqrt(w), as ops/dedisperse.boxcar_snr takes it."""
    return [torch.rsqrt(torch.tensor(float(w))).item() for w in widths]


def _lib() -> ctypes.CDLL:
    lib = _build.load("boxcar_topk")
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.vf_boxcar_topk_workspace.argtypes = [p]
    lib.vf_boxcar_topk_workspace.restype = ll
    lib.vf_boxcar_stats.argtypes = [p, p, p, p, p]
    lib.vf_topk_select.argtypes = [p, p, p, p, p, p]
    lib.vf_boxcar_stats.restype = lib.vf_topk_select.restype = ctypes.c_int
    return lib


class Launch:
    """One gulp's two passes over dmt: its arguments, workspace and output.
    `boxcar()` then `topk()` on the current stream; `out` is the packed
    (2, nbands*kb + 1) int32 crossings once `topk()` has run."""

    def __init__(self, dmt: torch.Tensor, nchan_eff: float, widths: tuple,
                 nbands: int, kb: int, thresh: float, noise: str,
                 skip: int):
        ndm, nt = dmt.shape
        nw = len(widths)
        if tuple(widths) != tuple(1 << i for i in range(nw)) \
                or not 1 <= nw <= MAX_WIDTHS:
            raise ValueError(f"boxcar_topk: widths {widths} are not 1, 2, "
                             f"4, ... up to {1 << (MAX_WIDTHS - 1)}")
        if not thresh >= 0.0:
            raise ValueError(f"boxcar_topk: thresh {thresh} < 0 (the "
                             f"kernels bin crossings as positive floats)")
        if noise not in ("measured", "expected"):
            raise ValueError(f"boxcar_topk: noise {noise!r}")
        ntf = skip + nt
        if nw * (ndm // nbands) * ntf >= 2 ** 31:
            raise ValueError("boxcar_topk: a band's flat index passes int32")
        sigma = 0.0 if noise == "measured" else \
            float(np.sqrt(np.float32(nchan_eff)))
        step = max(1, nt // NOISE_SUBSAMPLE)
        self.dmt = dmt
        self.ip = (ctypes.c_longlong * 8)(ndm, nt, skip, ntf, nw, step,
                                          nbands, kb)
        self.fp = (ctypes.c_float * (2 + nw))(sigma, thresh,
                                              *width_scales(widths))
        self.lib = _lib()
        nbytes = self.lib.vf_boxcar_topk_workspace(self.ip)
        self.ws = torch.empty(nbytes, dtype=torch.uint8, device=dmt.device)
        self.out = torch.empty((2, nbands * kb + 1), dtype=torch.int32,
                               device=dmt.device)
        self.stream = ctypes.c_void_p(
            torch.cuda.current_stream(dmt.device).cuda_stream)

    def _ptr(self, t: torch.Tensor) -> ctypes.c_void_p:
        return ctypes.c_void_p(t.data_ptr())

    def boxcar(self) -> None:
        """Pass 1: each row's mean, noise and S/N; the crossings binned."""
        _build.check(self.lib.vf_boxcar_stats(
            self._ptr(self.dmt), self.ip, self.fp, self._ptr(self.ws),
            self.stream), "vf_boxcar_stats", self.lib)
        LAUNCHES["boxcar_snr_stats"] += 1

    def topk(self) -> None:
        """Pass 2: each band's top kb crossings into `out`."""
        _build.check(self.lib.vf_topk_select(
            self._ptr(self.dmt), self.ip, self.fp, self._ptr(self.ws),
            self._ptr(self.out), self.stream), "vf_topk_select", self.lib)
        LAUNCHES["topk_banded_select"] += 1
