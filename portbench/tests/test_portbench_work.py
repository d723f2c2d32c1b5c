"""The frozen work counts equal counts made by hand at a tiny geometry."""

import math

from portbench.work import counts
from portbench.tests._tiny import tiny_cell


def test_second_by_hand():
    dsp = tiny_cell().config["dsp"]
    # 1 Msamp/s, nfft 500: 2000 spectra a pol, 251 channels, 500 rows
    frames = 2 * 2000
    fft = 2.5 * 500 * math.log2(500)
    ops = frames * 1.25 * fft + 2 * frames * 251 * 8 + 5 * 2 * 1_000_000
    nbytes = 2 * 1_000_000 + 2 * 500 * 48 + 4 * frames + 2 * 4 * 2 * 251
    w = counts.second_work(dsp, armed=False, masked=0.25)
    assert w["ops"] == ops and w["bytes"] == nbytes
    assert w["bound_by"] == "operations"
    assert w["seconds"] == ops / 67e12
    armed = counts.second_work(dsp, armed=True, masked=0.25)
    width = 0.002 * 2000 + 1
    assert armed["ops"] == ops + 2 * 2 * 251 * width * 2


def test_pfb_adds_the_taps():
    dsp = tiny_cell(channelizer="pfb").config["dsp"]
    plain = counts.second_work(tiny_cell().config["dsp"], False, 0.0)
    w = counts.second_work(dsp, False, 0.0)
    assert w["ops"] - plain["ops"] == 2 * 2000 * 500 * 2 * 4


def test_gulp_by_hand():
    from portbench.reference import dsp as ref_dsp
    from portbench.reference import search as ref_search
    cell = tiny_cell()
    s = cell.config["search"]
    plan = ref_search.make_plan(
        s, ref_dsp.Geometry.from_settings(cell.config["dsp"]), "cpu")
    # 64 trials in 64 batches, 96 subbands of 2 channels, no zaps
    assert (len(plan.dms), plan.rel.shape[0], plan.nsub) == (64, 64, 96)
    nt = 512
    adds = 64 * 192 * (nt + plan.max_sub_delay) + 64 * 96 * nt
    ops = adds + 64 * nt * (2 + 2 * 5) + 5 * 64 * nt
    nbytes = (nt + plan.max_delay) * 48 + 8 * (4096 + 1)
    w = counts.gulp_work(cell.config["dsp"], s)
    assert (w["ops"], w["bytes"]) == (ops, nbytes)
