"""Filterbank waterfall products (the make_plots/coarse_waterfall role,
ref src/make_plots.py:17-160, src/coarse_waterfall.py): downsample a
filterbank to a displayable time-frequency image and optionally render a
PNG per observation for the monitoring page.

Port of vlite_fast_tpu/analysis/waterfall.py.  The JAX package draws its
PNGs with matplotlib; the port writes them itself with numpy and zlib
(`write_png`): each panel an image through a fixed colormap table
(`COLORMAP`, viridis-like), clipped at the same percentiles, the panels
stacked top to bottom, with no axes, labels or title.  A waterfall PNG is
wf.shape[0] pixels wide (time) and wf.shape[1] high (channels, the first
at the top).
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np

from vlite_fast_tpu_torch.utils import sigproc

# viridis at nine evenly spaced points, interpolated to 256 RGB entries
_ANCHORS = np.array([[68, 1, 84], [71, 44, 122], [59, 81, 139],
                     [44, 113, 142], [33, 144, 141], [39, 173, 129],
                     [92, 200, 99], [170, 220, 50], [253, 231, 37]],
                    np.float64)
COLORMAP = np.stack([np.interp(np.linspace(0, 8, 256), np.arange(9),
                               _ANCHORS[:, k]) for k in range(3)],
                    axis=1).round().astype(np.uint8)
PROFILE_ROWS = 64      # height of a line-plot panel (render_candidate_png)


def downsample(data: np.ndarray, max_time: int = 2048,
               max_chan: int = 512) -> np.ndarray:
    """Block-average (ntime, nchan) to at most (max_time, max_chan)."""
    nt, nc = data.shape
    ft = max(1, nt // max_time)
    fc = max(1, nc // max_chan)
    nt2, nc2 = nt - nt % ft, nc - nc % fc
    d = data[:nt2, :nc2].reshape(nt2 // ft, ft, nc2 // fc, fc)
    return d.mean(axis=(1, 3))


def waterfall_from_fil(path: str, max_time: int = 2048,
                       max_chan: int = 512) -> Tuple[np.ndarray, dict]:
    hdr, data = sigproc.read_filterbank(path)
    wf = downsample(data, max_time, max_chan)
    meta = {"tsamp": hdr.tsamp * (data.shape[0] // wf.shape[0]),
            "fch1": hdr.fch1,
            "foff": hdr.foff * (data.shape[1] // wf.shape[1]),
            "source": hdr.source_name}
    return wf, meta


def watch_and_render(fil_dir: str, out_dir: Optional[str] = None,
                     poll_s: float = 5.0, max_iterations: int = 0,
                     stop_flag=None) -> int:
    """Watch a directory for new .fil files and publish waterfall PNGs
    (the src/make_plots.py watch loop, ref make_plots.py:108-160).

    max_iterations=0 runs until stop_flag (a threading.Event) is set.
    Returns the number of PNGs rendered."""
    import os
    import time as _t
    out_dir = out_dir or fil_dir
    os.makedirs(out_dir, exist_ok=True)
    seen = set()
    rendered = 0
    it = 0
    while True:
        for f in sorted(os.listdir(fil_dir)):
            if not f.endswith(".fil") or f in seen:
                continue
            path = os.path.join(fil_dir, f)
            try:
                wf, meta = waterfall_from_fil(path)
                render_png(wf, meta,
                           os.path.join(out_dir,
                                        f.replace(".fil", ".png")))
                rendered += 1
            except Exception:
                pass   # partial/in-progress file; retry next poll
            else:
                seen.add(f)
        it += 1
        if max_iterations and it >= max_iterations:
            break
        if stop_flag is not None and stop_flag.is_set():
            break
        if max_iterations == 0 and stop_flag is None:
            break   # single pass when no loop control is given
        _t.sleep(poll_s)
    return rendered


def write_png(rgb: np.ndarray, out_path: str) -> str:
    """(height, width, 3) uint8 -> an 8-bit RGB PNG (zlib-deflated rows,
    filter type 0), written beside out_path and renamed onto it, so that
    a reader of a watched directory never sees half a file."""
    import os
    h, w, _ = rgb.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(rgb, np.uint8).reshape(h, -1)],
                          axis=1)
    part = out_path + ".part"
    with open(part, "wb") as fp:
        fp.write(b"\x89PNG\r\n\x1a\n")
        fp.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        fp.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        fp.write(chunk(b"IEND", b""))
    os.replace(part, out_path)
    return out_path


def _image(data: np.ndarray, vmin_pct: float, vmax_pct: float) -> np.ndarray:
    """(ntime, nchan) -> (nchan, ntime, 3) colours, clipped at the
    percentiles (imshow of data.T, origin upper)."""
    lo, hi = np.percentile(data, [vmin_pct, vmax_pct])
    scaled = (np.asarray(data, np.float64).T - lo) / max(hi - lo, 1e-30)
    return COLORMAP[np.clip(scaled * 255.0, 0, 255).astype(np.uint8)]


def _profile_image(prof: np.ndarray, width: int,
                   rows: int = PROFILE_ROWS) -> np.ndarray:
    """A line plot of prof as a (rows, width, 3) image, width >=
    len(prof): column i lit from sample i-1's height to sample i's."""
    prof = np.asarray(prof, np.float64)
    span = max(prof.max() - prof.min(), 1e-30)
    y = ((prof.max() - prof) / span * (rows - 1)).round().astype(int)
    prev = np.concatenate([y[:1], y[:-1]])
    r = np.arange(rows)[:, None]
    lit = (r >= np.minimum(prev, y)[None]) & (r <= np.maximum(prev, y)[None])
    img = np.zeros((rows, width, 3), np.uint8)
    img[:, :prof.size][lit] = COLORMAP[-1]
    return img


def render_candidate_png(fb: np.ndarray, cand, tsamp: float,
                         freqs_mhz: np.ndarray, out_path: str) -> str:
    """Diagnostic image for one candidate: the dispersed waterfall cutout,
    the matched-width smoothed version, and the dedispersed profile, one
    panel above the other (the candidate plots make_plots publishes for
    triggers).  Each is block.shape[0] pixels wide (the profile, shorter
    by the DM sweep, from the left); the cutouts are one row a channel,
    the profile PROFILE_ROWS high."""
    from vlite_fast_tpu_torch.analysis import cutout as co

    _, blk = co.candidate_block(fb, cand, tsamp, freqs_mhz, wmult=3)
    sm = co.tophat(blk, cand.tfilt)
    prof = co.dedispersed_profile(blk, cand.dm, tsamp, freqs_mhz)
    panels = [_image(blk, 5, 95), _image(sm, 5, 95),
              _profile_image(prof, blk.shape[0])]
    return write_png(np.concatenate(panels, axis=0), out_path)


def render_png(wf: np.ndarray, meta: dict, out_path: str,
               vmin_pct: float = 5, vmax_pct: float = 95) -> str:
    """Render a waterfall PNG: wf.T through COLORMAP, clipped at the
    percentiles (meta, the axes' extent in the JAX package's plot, is not
    drawn)."""
    return write_png(_image(wf, vmin_pct, vmax_pct), out_path)
