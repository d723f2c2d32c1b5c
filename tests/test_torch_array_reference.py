"""The sharded array step on a one-rank gloo mesh against the plain
float64 reference of the array (portbench/reference/coadd.py): at
PipelineConfig.tiny's geometry and SearchConfig.tiny's grid, 4 antennas
in two calls with the state carried, every antenna's rows and bandpasses
agree with the reference's DSP, the coadd's candidates and crossings
with the reference coadd's search, within the cell's limits
(portbench/limits/array8.coadd.json); the reference coadd of identical
beams is sqrt(nant) times a beam; and the control (the reference one
precision step below float32) fails the limits."""

import numpy as np
import pytest
import torch

from portbench import check, check_array, control_array
from portbench.reference import coadd as ref_coadd
from portbench.reference import search as ref_search
from portbench.tests import _tiny_array as ta

NCALLS = 2


@pytest.fixture(scope="module")
def cell():
    return ta.tiny_array_cell()


@pytest.fixture(scope="module")
def ran(cell):
    return ta.array_calls(cell, NCALLS, seed=2 ** 31 + 11)


@pytest.fixture(scope="module")
def reference(cell, ran):
    """Each antenna's reference seconds over both calls."""
    g, _, nsec, inject_sec = check_array.settings(cell)
    return [ref_coadd.antenna_seconds(g, ran["raw"][a], nsec, inject_sec, 0,
                                      NCALLS * nsec - 1)
            for a in range(ta.NANT)]


def test_every_antennas_rows_and_bandpasses(cell, ran, reference):
    g, _, nsec, _ = check_array.settings(cell)
    for k, c in enumerate(ran["calls"]):
        bp, bp_kur, _ = c["state"]
        for a, outs in enumerate(reference):
            got = check.unpack2(torch.as_tensor(c["full"].packed_kur[a]))
            want = torch.cat([outs[k * nsec + s].levels_kur
                              for s in range(nsec)])
            mismatch = float((got != want).double().mean())
            assert mismatch <= cell.limits["levels_mismatch"], (k, a)
            last = outs[k * nsec + nsec - 1]
            for stream, (p, r) in enumerate(((bp[a], last.bp),
                                             (bp_kur[a], last.bp_kur))):
                known = last.bp_known[stream]
                assert known.double().mean() > 0.9
                rel = ((p.double() - r).abs() / r.abs())[known]
                assert float(rel.median()) <= \
                    cell.limits["bandpass_rel_median"], (k, a, stream)


def test_coadd_candidates_against_the_reference_coadd(cell, ran):
    """Call 1's coadd (the span from call 0's last halo rows) against the
    reference coadd of the program's rows, searched."""
    g, s, nsec, _ = check_array.settings(cell)
    info = ran["info"]
    prev, cur = (c["full"] for c in ran["calls"][:2])
    lev = [check_array.span_levels(r, t[info.T - info.halo:], "cpu")
           for r, t in zip(cur.packed_kur, prev.packed_kur)]
    plan = ref_search.make_plan(s, g, "cpu")
    res = ref_coadd.search_fb(ref_coadd.coadd(lev), plan, s,
                              info.T - info.halo)
    crossings = int(cur.coadd_topk[0, 0, -1])
    tally = check.Tally()
    tally.gulp(ran["calls"][1]["coadd"], res, crossings)
    assert res.cands and ran["calls"][1]["coadd"]
    assert res.n_crossings == crossings
    assert tally.snr_gap <= cell.limits["coadd_snr_gap"]
    # the burst, armed at second 1 of the call (the tiny band's sweep is
    # a few samples, too short to tell its DM apart)
    best = max(ran["calls"][1]["coadd"], key=lambda c: c.snr)
    arrival = (nsec + ta.INJECT_SEC) * info.T // nsec
    assert best.snr >= 10.0 and abs(best.peak_idx - arrival) <= 4, best


def test_reference_coadd_of_identical_beams():
    lev = torch.randint(0, 4, (64, 48), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(3))
    for nant in (1, 4, 8):
        got = ref_coadd.coadd([lev] * nant)
        want = np.sqrt(nant) * ref_search.dequantize(lev)
        torch.testing.assert_close(got, want, rtol=1e-15, atol=0.0)


def test_the_control_fails(cell):
    for seed in (2 ** 31 + 1, 2 ** 31 + 2):
        vals = control_array.control_numbers(cell, seed, "cpu")
        failed = [n for n in vals if vals[n] > cell.limits[n]]
        assert failed, vals
