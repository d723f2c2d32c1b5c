"""TDOA event localization from per-baseline delays.

The loc_step2/loc_step3 role of the reference (analysis/loc_step2.py:19+,
loc_step3.py:25-320): measure per-baseline arrival-time differences of a
dedispersed pulse, then chi^2-fit a sky direction on a grid with zoom.
The reference grids on healpix; here a plain (az, el) plane-wave grid with
iterative zoom — no healpy dependency — which is equivalent for the
single-source TDOA problem.

The port's own copy of the JAX package's
vlite_fast_tpu/analysis/localization.py, kept whole so that the port imports
nothing of that package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

C_LIGHT = 299_792_458.0


def direction_unit(az: np.ndarray, el: np.ndarray) -> np.ndarray:
    """(az, el) radians -> unit vector(s), ENU convention."""
    az, el = np.broadcast_arrays(az, el)
    return np.stack([np.cos(el) * np.sin(az),
                     np.cos(el) * np.cos(az),
                     np.sin(el)], axis=-1)


def expected_delays(positions: np.ndarray, pairs: Sequence[Tuple[int, int]],
                    s_hat: np.ndarray) -> np.ndarray:
    """Plane-wave arrival-time differences t_i - t_j for each baseline
    (i, j).  A wavefront from direction s_hat reaches antenna r at
    t(r) = t0 - r.s_hat/c (antennas closer to the source receive
    EARLIER), so tau_ij = (r_j - r_i) . s_hat / c — matching what
    analysis.baseband.baseline_delay(a=i, b=j) measures.  The opposite
    sign converges the TDOA fit on the MIRRORED azimuth (az_true + pi;
    verified numerically on a physically-encoded plane wave).
    s_hat may be (..., 3)."""
    d = np.stack([positions[j] - positions[i] for i, j in pairs])  # (nb, 3)
    return np.einsum("bk,...k->...b", d, s_hat) / C_LIGHT


@dataclass
class TDOAFit:
    az: float
    el: float
    chi2: float
    chi2_map: np.ndarray
    az_grid: np.ndarray
    el_grid: np.ndarray


def fit_tdoa(positions: np.ndarray, pairs: Sequence[Tuple[int, int]],
             delays: np.ndarray, sigma: float = 100e-9,
             clock_offsets: Optional[np.ndarray] = None,
             n_grid: int = 64, n_zoom: int = 3) -> TDOAFit:
    """Grid + zoom chi^2 fit of the arrival direction
    (ref analysis/loc_step3.py:25-320 healpix grid + zoom, including the
    per-antenna clock-delay correction).

    positions: (nant, 3) meters; delays: (nbaseline,) seconds for `pairs`;
    clock_offsets: optional (nant,) seconds subtracted as
    tau_ij -> tau_ij - (c_i - c_j).
    """
    delays = np.asarray(delays, np.float64)
    if clock_offsets is not None:
        corr = np.array([clock_offsets[i] - clock_offsets[j]
                         for i, j in pairs])
        delays = delays - corr
    az_lo, az_hi = 0.0, 2 * np.pi
    el_lo, el_hi = 0.0, np.pi / 2
    best = (0.0, 0.0, np.inf)
    chi2_map = None
    azg = elg = None
    for _ in range(n_zoom):
        azg = np.linspace(az_lo, az_hi, n_grid)
        elg = np.linspace(el_lo, el_hi, n_grid)
        AZ, EL = np.meshgrid(azg, elg, indexing="ij")
        s = direction_unit(AZ, EL)                       # (n, n, 3)
        model = expected_delays(positions, pairs, s)     # (n, n, nb)
        chi2_map = (((model - delays) / sigma) ** 2).sum(axis=-1)
        k = np.unravel_index(np.argmin(chi2_map), chi2_map.shape)
        best = (float(AZ[k]), float(EL[k]), float(chi2_map[k]))
        daz = (az_hi - az_lo) / n_grid * 4
        dele = (el_hi - el_lo) / n_grid * 4
        az_lo, az_hi = best[0] - daz, best[0] + daz
        el_lo, el_hi = max(0.0, best[1] - dele), min(np.pi / 2,
                                                     best[1] + dele)
    return TDOAFit(az=best[0], el=best[1], chi2=best[2],
                   chi2_map=chi2_map, az_grid=azg, el_grid=elg)


# ---------------------------------------------------------------------------
# Celestial-frame localization (the loc_step3 end product: WHERE ON THE SKY)
# ---------------------------------------------------------------------------
# Ref analysis/loc_step3.py:25-32 (VLA center), :36-53 (antprop positions),
# :99-146 (correlator clock delays), :260-324 (ITRS->ICRS projection,
# healpix all-sky grid + 200x200 zoom chi^2).  astropy/healpy are not
# available here, so the frame chain is implemented directly:
# ITRS -> (Earth rotation, GMST) -> equinox-of-date -> (IAU-1976
# precession) -> ~ICRS.  Nutation (~17") and polar motion (~0.3") are
# neglected — arcsecond-level, far below the TDOA resolution of VLITE
# baselines (c/(B * delay precision) ~ arcminutes).

#: Geocentric ITRS position of the VLA array center [m]
#: (ref src/def.h VLA_CENTER_*, analysis/loc_step3.py:25-32).
VLA_CENTER_ITRS = np.array([-1601185.4, -5041977.5, 3554875.9])


def antprop_positions_itrs(doc) -> dict:
    """AntPropDocument (runtime/vla_xml.parse_antprop_document) ->
    {antenna_number: geocentric ITRS xyz [m]}.

    The antprop X/Y/Z are relative to the VLA center; the reference adds
    the center back before projecting (loc_step3.py:93-96)."""
    return {num: VLA_CENTER_ITRS + np.array([a.X, a.Y, a.Z])
            for num, a in doc.antennas.items()}


def parse_correlator_delays(path_or_text: str) -> dict:
    """Parse a 'vliteantennas.in' correlator-delay table ->
    {antenna_number: delay_seconds} (ref loc_step3.py:98-146; line format
    '0 10 vlite-difx7 p1p2 5021.000000 E08 5021.000000 1' = vlite input 0
    is ea10 with 5021 ns delay)."""
    # a single-line argument is a file path (spaces and all — a one-line
    # delay table is useless, and a mistyped path must raise, not parse
    # as empty text); inline table text always has newlines
    if "\n" in path_or_text:
        text = path_or_text
    else:
        with open(path_or_text) as fh:
            text = fh.read()
    delays = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        toks = line.split()
        try:
            ant = int(toks[1])
            delays[ant] = float(toks[4]) * 1e-9
        except (IndexError, ValueError):
            continue
    return delays


def gmst_rad(unix_t: float, ut1_utc: float = 0.0) -> float:
    """Greenwich mean sidereal time [rad] (IAU 1982 polynomial), from a
    unix timestamp; ut1_utc from the antprop EOP block when available."""
    jd_ut1 = (unix_t + ut1_utc) / 86400.0 + 2440587.5
    t = (jd_ut1 - 2451545.0) / 36525.0
    gmst_s = (67310.54841 + (876600.0 * 3600 + 8640184.812866) * t
              + 0.093104 * t * t - 6.2e-6 * t ** 3)
    return (gmst_s % 86400.0) / 86400.0 * 2 * np.pi


def _precession_matrix(unix_t: float) -> np.ndarray:
    """IAU-1976 (Lieske) precession: r_mean_of_date = P @ r_J2000."""
    t = ((unix_t / 86400.0 + 2440587.5) - 2451545.0) / 36525.0
    arcsec = np.pi / (180 * 3600)
    zeta = (2306.2181 * t + 0.30188 * t * t + 0.017998 * t ** 3) * arcsec
    z = (2306.2181 * t + 1.09468 * t * t + 0.018203 * t ** 3) * arcsec
    theta = (2004.3109 * t - 0.42665 * t * t - 0.041833 * t ** 3) * arcsec

    def rz(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])

    def ry(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])

    return rz(-z) @ ry(theta) @ rz(-zeta)


def itrs_to_icrs_matrix(unix_t: float, ut1_utc: float = 0.0) -> np.ndarray:
    """Rotation taking geocentric ITRS vectors to the ~ICRS (J2000
    equatorial) frame at time t: undo Earth rotation (GMST about z), then
    undo precession.  r_icrs = M @ r_itrs."""
    g = gmst_rad(unix_t, ut1_utc)
    c, s = np.cos(g), np.sin(g)
    # equinox-of-date = Rz(-gmst) @ itrs (ITRS x-axis is the Greenwich
    # meridian, which sits gmst radians EAST of the equinox)
    rz_back = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    return _precession_matrix(unix_t).T @ rz_back


def radec_unit(ra: np.ndarray, dec: np.ndarray) -> np.ndarray:
    """(ra, dec) radians -> ICRS unit vector(s), shape (..., 3)."""
    ra, dec = np.broadcast_arrays(ra, dec)
    return np.stack([np.cos(dec) * np.cos(ra),
                     np.cos(dec) * np.sin(ra),
                     np.sin(dec)], axis=-1)


def _fibonacci_sky(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """n quasi-uniform (ra, dec) points [rad] (the healpix all-sky grid
    role, loc_step3.py:287-295, without healpy)."""
    i = np.arange(n) + 0.5
    dec = np.arcsin(1 - 2 * i / n)
    ra = (i * np.pi * (3 - np.sqrt(5.0))) % (2 * np.pi)
    return ra, dec


@dataclass
class SkyFit:
    ra_deg: float
    dec_deg: float
    chi2: float
    chi2_map: np.ndarray        # final zoom map
    ra_grid_deg: np.ndarray
    dec_grid_deg: np.ndarray
    err_arcmin: float           # delta(chi2)=1 contour radius estimate


def fit_sky(positions_itrs: np.ndarray, pairs: Sequence[Tuple[int, int]],
            delays: np.ndarray, t0: float, sigma: float = 100e-9,
            clock_offsets: Optional[np.ndarray] = None,
            ut1_utc: float = 0.0, n_coarse: int = 49152,
            n_zoom: int = 200, zoom_rounds: int = 3,
            horizon: bool = True) -> SkyFit:
    """RA/Dec chi^2 grid + zoom fit of a TDOA event (the loc_step3 fit,
    ref analysis/loc_step3.py:287-324).

    positions_itrs: (nant, 3) geocentric ITRS [m] (antprop_positions_itrs
    output, ordered to match `pairs` indices); delays: (nbaseline,)
    measured arrival-time differences t_i - t_j [s] per (i, j) in pairs
    (the analysis.baseband.baseline_delay convention);
    clock_offsets: per-antenna instrumental delays [s] (correlator +
    pipeline tables) subtracted as tau_ij - (c_i - c_j);
    t0: unix time of the event (sets the Earth-rotation angle).

    Coarse pass: ~n_coarse-point quasi-uniform all-sky grid (the healpix
    nside=64 role); then `zoom_rounds` of an n_zoom x n_zoom local grid
    shrinking 10x each round (the 200x200 zoom role).

    horizon: a (near-)coplanar array like the VLA cannot distinguish a
    direction from its mirror image through the array plane (identical
    plane-wave delays), and the mirror of an elevated source lies below
    the local horizon.  An observed event was above the horizon by
    construction, so coarse-grid points with s_hat pointing into the
    ground at the array centroid are excluded (the reference gets the
    same effect from healpix masks, loc_step3.py:287-295).
    """
    delays = np.asarray(delays, np.float64)
    if clock_offsets is not None:
        delays = delays - np.array([clock_offsets[i] - clock_offsets[j]
                                    for i, j in pairs])
    M = itrs_to_icrs_matrix(t0, ut1_utc)
    p_icrs = positions_itrs @ M.T                       # (nant, 3)
    # wavefront from s_hat reaches antenna r at t0 - r.s_hat/c, so
    # tau_ij = t_i - t_j = (r_j - r_i).s_hat / c
    B = np.stack([p_icrs[j] - p_icrs[i] for i, j in pairs]) / C_LIGHT

    def chi2_of(s_hat):                                 # s_hat (..., 3)
        model = s_hat @ B.T                             # (..., nb)
        return (((model - delays) / sigma) ** 2).sum(axis=-1)

    ra, dec = _fibonacci_sky(n_coarse)
    chi2 = chi2_of(radec_unit(ra, dec))
    if horizon:
        up = positions_itrs.mean(axis=0)
        up_icrs = (M @ up) / np.linalg.norm(up)
        chi2 = np.where(radec_unit(ra, dec) @ up_icrs > 0.0, chi2, np.inf)
    k = int(np.argmin(chi2))
    best_ra, best_dec, best_chi2 = ra[k], dec[k], chi2[k]

    half = np.sqrt(4 * np.pi / n_coarse)     # coarse cell scale [rad]
    chi2_map = rag = decg = None
    for _ in range(zoom_rounds):
        decg = best_dec + np.linspace(-half, half, n_zoom)
        cosd = max(np.cos(best_dec), 1e-6)
        rag = best_ra + np.linspace(-half, half, n_zoom) / cosd
        RA, DEC = np.meshgrid(rag, decg, indexing="ij")
        chi2_map = chi2_of(radec_unit(RA, DEC))
        kk = np.unravel_index(np.argmin(chi2_map), chi2_map.shape)
        best_ra, best_dec = RA[kk], DEC[kk]
        best_chi2 = chi2_map[kk]
        half /= 10.0
    # error scale: sky radius where chi2 rises by 1 above the minimum,
    # from the final map
    inside = chi2_map <= best_chi2 + 1.0
    err = np.sqrt(inside.mean() * (rag[-1] - rag[0]) * max(np.cos(
        best_dec), 1e-6) * (decg[-1] - decg[0]) / np.pi)
    return SkyFit(
        ra_deg=float(np.degrees(best_ra) % 360.0),
        dec_deg=float(np.degrees(best_dec)),
        chi2=float(best_chi2),
        chi2_map=chi2_map,
        ra_grid_deg=np.degrees(rag),
        dec_grid_deg=np.degrees(decg),
        err_arcmin=float(np.degrees(err) * 60.0))


def refine_dm(fb: np.ndarray, tsamp: float, freqs_mhz: np.ndarray,
              dm_grid: np.ndarray) -> Tuple[float, np.ndarray]:
    """Pulse/DM refinement on a filterbank block: pick the DM maximizing the
    peak dedispersed S/N (ref analysis/loc_step0.py:44-176)."""
    from vlite_fast_tpu_torch.ops import dedisperse as dd
    delays = dd.delay_table(np.asarray(dm_grid), freqs_mhz, tsamp)
    ntime_out = fb.shape[0] - int(delays.max())
    prof = dd.dedisperse_reference(fb.astype(np.float32), delays, ntime_out)
    snr = (prof.max(axis=1) - np.median(prof, axis=1)) / (
        prof.std(axis=1) + 1e-12)
    return float(dm_grid[int(np.argmax(snr))]), snr
