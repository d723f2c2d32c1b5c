"""The work of the algorithm, counted from a configuration's shapes: the
least time the card could take for a twin second, an armed second and a
gulp, whatever implements them.

Peaks are one NVIDIA H100 SXM's (NVIDIA's data sheet, dense, at its
700 W power limit): 3.35 TB/s of HBM and 67 TFLOP/s in float32 outside
the tensor cores.  Every operation is counted against the float32 peak,
which counts a multiply-add as two: an add alone counted as one is
therefore counted at twice the rate the card adds, so a share of these
bounds is if anything low, never high.  Bytes are each input read once
and each output written once.

A second (`second_work`):
  - a real FFT of every frame, 2.5 nfft log2 nfft operations (the radix-2
    count, which no transform of these sizes beats); in rfi_mode 2 the
    kurtosis stream needs a transform of its own only in the frames its
    mask changed (`masked`, the share of frames whose weight is below 1:
    the data decide it);
  - with channelizer 'pfb', the WOLA: a multiply-add per tap per sample,
    for the same frames as the transform;
  - detection, the bandpass EMA and the normalization: 8 operations per
    spectrum element (|X|^2 3, EMA 3, normalize 2);
  - with the RFI front, its moments and mask: 5 operations per sample of
    each pol (square, square, two adds, the mask's multiply);
  - armed: the burst's track multiplies the spectrum elements of both
    streams inside the track (at most width + 1 spectra a channel).
  Bytes: the raw second in; both streams' rows, the block weights and
  both streams' bandpasses out.  The scrunches and the 2-bit pack touch
  only the reduced rows and are not counted.
The FFT's operations bound every configuration here (bytes: ~0.08 ms a
production second; operations ~0.3 ms).

A gulp (`gulp_work`), from the search plan's shapes:
  - the subband dedispersion's adds: stage 1 one add per retained
    (unzapped) channel per stage-1 batch per intermediate sample
    (ntime_out + max_sub_delay); stage 2 one add per subband per trial per
    output sample;
  - the boxcar S/N: the mean (1 add), the running sum (1 add) and, per
    width, a difference and a scale (2), per DM-time element;
  - the banded top-k: one compare per S/N element.
  Bytes: the packed rows in once, the crossings (two int32 per slot and
  the count) out.  Operations bound it (~0.4 ms against ~0.01 ms of bytes
  at production).
"""

from __future__ import annotations

import math

from portbench.reference import dsp as ref_dsp
from portbench.reference import search as ref_search

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound(ops: float, nbytes: float) -> dict:
    t_ops, t_bytes = ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return {"ops": ops, "bytes": nbytes, "seconds": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def second_work(dsp: dict, armed: bool, masked: float) -> dict:
    """The least time of one data-second of the configuration's chain, of
    which the share `masked` of frames had a window masked."""
    g = ref_dsp.Geometry.from_settings(dsp)
    nstreams = 2 if g.rfi_mode == 2 else 1
    frames = g.npol * g.spectra
    transformed = frames * (1 + (masked if nstreams == 2 else 0.0))
    ops = transformed * 2.5 * g.nfft * math.log2(g.nfft)
    if g.channelizer == "pfb":
        ops += transformed * g.nfft * 2 * g.ntap
    ops += nstreams * frames * g.nchan * 8
    if g.rfi_mode > 0:
        ops += 5 * g.npol * g.rate
    if armed and g.inject:
        width = g.inject_width_s * g.spectra + 1
        ops += nstreams * g.npol * g.nchan * width * 2
    row_bytes = g.nchanout * g.nbit // 8
    nbytes = (g.npol * g.rate + nstreams * g.rows * row_bytes
              + 4 * frames + nstreams * 4 * g.npol * g.nchan)
    return bound(ops, nbytes)


def gulp_work(dsp: dict, search: dict) -> dict:
    """The least time of one full gulp of the configuration's search."""
    g = ref_dsp.Geometry.from_settings(dsp)
    plan = ref_search.make_plan(search, g, "cpu")
    ntime_out = search["gulp_samps"]
    ndm = len(plan.dms)
    nbatch = plan.rel.shape[0]
    nw = len(ref_search.widths(search))
    adds = (nbatch * plan.nchan_eff * (ntime_out + plan.max_sub_delay)
            + ndm * plan.nsub * ntime_out)
    cells = ndm * ntime_out
    ops = adds + cells * (2 + 2 * nw) + nw * cells
    k = search["topk"] or min(16 * search["max_candidates"], 20000)
    row_bytes = g.nchanout * g.nbit // 8
    nbytes = (ntime_out + plan.max_delay) * row_bytes + 8 * (k + 1)
    return bound(ops, nbytes)
