"""Candidate-centred filterbank cutouts and matched smoothing.

The Candidate.get_block / tophat methods of the reference
(src/candidate.py:26-47): extract the time window around a candidate with
width + DM-sweep padding for plots and refinement, and smooth at the
candidate's boxcar width.

The port's own copy of the JAX package's
vlite_fast_tpu/analysis/cutout.py, kept whole so that the port imports
nothing of that package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from vlite_fast_tpu_torch import constants as C
from vlite_fast_tpu_torch.ops.dedisperse import Candidate


def candidate_block(fb: np.ndarray, cand: Candidate, tsamp: float,
                    freqs_mhz: np.ndarray, wmult: int = 1,
                    include_dm: bool = True) -> Tuple[int, np.ndarray]:
    """(start_sample, block) around the candidate
    (ref src/candidate.py:26-40).

    The window spans [i0 - width*wmult - dm_width, i1 + width*wmult +
    dm_width] clipped to the filterbank."""
    width = cand.i1 - cand.i0
    if include_dm:
        f0, f1 = float(np.max(freqs_mhz)), float(np.min(freqs_mhz))
        dm_delay = C.DM_CONST_S * cand.dm * abs(f1 ** -2.0 - f0 ** -2.0)
        dm_width = int(dm_delay / tsamp)
    else:
        dm_width = 0
    start = max(0, cand.i0 - width * wmult - dm_width)
    stop = min(fb.shape[0], cand.i1 + width * wmult + dm_width)
    return start, fb[start:stop]


def tophat(block: np.ndarray, tfilt: int) -> np.ndarray:
    """Boxcar smoothing at width 2**tfilt along the time axis
    (ref src/candidate.py:42-47)."""
    w = 1 << tfilt
    kernel = np.full(w, 1.0 / w, np.float32)
    if block.ndim == 1:
        return np.convolve(block, kernel, mode="same")
    out = np.empty_like(block, dtype=np.float32)
    for ch in range(block.shape[1]):
        out[:, ch] = np.convolve(block[:, ch], kernel, mode="same")
    return out


def dedispersed_profile(block: np.ndarray, dm: float, tsamp: float,
                        freqs_mhz: np.ndarray) -> np.ndarray:
    """Channel-aligned sum at the candidate's DM (quick-look profile)."""
    from vlite_fast_tpu_torch.ops import dedisperse as dd
    delays = dd.delay_table(np.array([dm]), np.asarray(freqs_mhz), tsamp)[0]
    ntime_out = block.shape[0] - int(delays.max())
    if ntime_out <= 0:
        return block.sum(axis=1)
    return dd.dedisperse_reference(block.astype(np.float32),
                                   delays[None, :], ntime_out)[0]
