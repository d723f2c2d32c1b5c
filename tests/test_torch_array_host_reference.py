"""The array host, ArrayPipeline.run_streaming with its rings, against
the plain float64 reference of the array host (portbench/reference/
host.py): at the benchmark's tiny host cell (portbench/tests/
_tiny_host.py: PipelineConfig.tiny's geometry, 2 bits, the burst armed
at second 0; SearchConfig.tiny's grid; 3 antennas, 8-s rings, the
coincidence every 2 data-seconds, no .fil), on the CPU, antenna a's
second k being its staged[k % 3]:

- every antenna's rows agree with the reference's DSP within the cell's
  levels limit (portbench/limits/host8.realtime.json);
- every full gulp of each beam and of the coadd has the candidates of
  the reference's search of the program's rows (for the coadd, of the
  reference coadd of every beam's rows), within the cell's S/N limit,
  and the burst is found;
- the float16 coadd stream, summed where the rows are, is bit-equal to
  the numpy sum the coadd made on the host before (each beam's
  filterbank_from_packed, stacked and summed, scaled by 1/sqrt(3) in
  float32, cast to float16);
- the brightest trigger is the reference's (src/trigger.py's cuts over
  the reference's candidates): its window and DM;
- every dump, made from a pre-faulted ring on the ring's thread, holds
  the fed bytes of the seconds it lists, and every antenna dumped the
  burst's second.
"""

import numpy as np
import pytest
import torch

from portbench import check as station_check
from portbench import check_host, spec
from portbench.reference import dsp as ref_dsp
from portbench.reference import host as ref_host
from portbench.reference import search as ref_search
from portbench.tests import _tiny_host as th
from vlite_fast_tpu_torch.config import (AntennaConfig, ArrayConfig,
                                         PipelineConfig, SearchConfig,
                                         TriggerConfig)
from vlite_fast_tpu_torch.models import search as search_mod
from vlite_fast_tpu_torch.runtime import pipeline
from vlite_fast_tpu_torch.runtime.pipeline import (COADD_BEAM,
                                                   ArrayPipeline,
                                                   ObservationDocument)

NSEC = 6
UNIX0 = 1.7e9
SEED = 2 ** 31 + 23
# station ids no other test takes: a ring is named after its station, and
# tests/test_torch_cli.py looks for rings of stations 1 and 2 left behind
STATION0 = 71


@pytest.fixture(scope="module")
def cell():
    return th.tiny_host_cell()


@pytest.fixture(scope="module")
def ran(cell, tmp_path_factory):
    """One observation of NSEC data-seconds through run_streaming: each
    station's rows (a device tap of the test's own), the coadd's float16
    blocks, the result."""
    s = dict(cell.config["search"])
    s["zap_ranges"] = tuple(tuple(r) for r in s["zap_ranges"])
    acfg = ArrayConfig(
        antennas=tuple(AntennaConfig(STATION0 + i, f"ea{STATION0 + i}")
                       for i in range(th.NANT)),
        pipeline=PipelineConfig(**cell.config["dsp"]),
        search=SearchConfig(**s))
    gen = spec.generator(cell.traffic)
    staged = {a.station_id: [x.numpy() for x in gen.staged_seconds(
        cell.traffic, cell.config["dsp"], SEED, "cpu", antenna=i)]
        for i, a in enumerate(acfg.antennas)}
    rows = {a.station_id: [] for a in acfg.antennas}
    coadd = []
    append = pipeline.GulpStream.append

    def kept(stream, block):
        if isinstance(block, torch.Tensor) and block.dtype == torch.float16:
            coadd.append(block.clone())
        append(stream, block)

    ap = ArrayPipeline(acfg, out_dir=str(tmp_path_factory.mktemp("host")),
                       device="cpu", ring_seconds=th.RING_S)
    try:
        for st in ap.stations:
            st.device_taps.append(
                lambda sid, off, b: rows[sid].append((off, b.clone())))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pipeline.GulpStream, "append", kept)
            res = ap.run_streaming(
                {sid: [(UNIX0 + k, secs[k % len(secs)])
                       for k in range(NSEC)]
                 for sid, secs in staged.items()},
                ObservationDocument(name="HOST", start_time=UNIX0),
                coincide_every_s=th.COINCIDE_S, write_fil=False)
        overlap = ap.stations[0].search.overlap
    finally:
        ap.close()
    for sid, blocks in rows.items():
        assert [off for off, _ in blocks] == \
            list(np.cumsum([0] + [b.shape[0] for _, b in blocks[:-1]]))
    return {"acfg": acfg, "staged": staged, "res": res, "coadd": coadd,
            "overlap": overlap,
            "rows": {sid: torch.cat([b for _, b in blocks])
                     for sid, blocks in rows.items()}}


@pytest.fixture(scope="module")
def searched(cell, ran):
    """Each full gulp's reference search of every beam's rows and of the
    reference coadd: {beam: [(gulp start, GulpResult)]}."""
    g = ref_dsp.Geometry.from_settings(cell.config["dsp"])
    s = cell.config["search"]
    plan = ref_search.make_plan(s, g, "cpu")
    assert plan.max_delay == ran["overlap"]
    lev = {sid: station_check.unpack2(r) for sid, r in ran["rows"].items()}
    nrows = min(int(x.shape[0]) for x in lev.values())
    out = {b: [] for b in list(lev) + [COADD_BEAM]}
    gulp = 0
    while True:
        start, stop = ref_host.gulp_span(s, plan, gulp)
        if stop > nrows:
            break
        for sid, x in lev.items():
            out[sid].append((start, ref_host.search_beam(
                x[start:stop], plan, s, start)))
        out[COADD_BEAM].append((start, ref_host.search_coadd(
            [x[start:stop] for x in lev.values()], plan, s, start)))
        gulp += 1
    assert gulp >= 3
    return out


def test_every_antennas_rows_agree_with_the_reference_dsp(cell, ran):
    g = ref_dsp.Geometry.from_settings(cell.config["dsp"])
    for sid, rows in ran["rows"].items():
        staged = [torch.as_tensor(x) for x in ran["staged"][sid]]
        ref = ref_host.antenna_seconds(g, staged, 0, NSEC - 1)
        want = torch.cat([ref[k].levels_kur for k in range(NSEC)])
        got = station_check.unpack2(rows)
        assert got.shape == want.shape
        mismatch = float((got != want).double().mean())
        assert mismatch <= cell.limits["levels_mismatch"], (sid, mismatch)


def _candidates(ran, beam):
    res = ran["res"]
    if beam == COADD_BEAM:
        return res["coadd_candidates"]
    return res["products"][beam].candidates


@pytest.mark.parametrize("beam", [STATION0 + i for i in range(th.NANT)]
                         + [COADD_BEAM])
def test_each_beams_and_the_coadds_candidates(cell, ran, searched, beam):
    gulp = cell.config["search"]["gulp_samps"]
    limit = cell.limits["coadd_snr_gap" if beam == COADD_BEAM
                        else "cand_snr_gap"]
    cands = _candidates(ran, beam)
    for start, ref in searched[beam]:
        mine = [c for c in cands if start <= c.peak_idx < start + gulp]
        tally = station_check.Tally()
        tally.gulp(mine, ref, ref.n_crossings)
        assert tally.snr_gap <= limit, (beam, start, tally.snr_gap)
    assert max(c.snr for c in cands) >= 10.0


def test_the_float16_coadd_is_the_numpy_sum(cell, ran):
    cfg = ran["acfg"].pipeline
    got = torch.cat(ran["coadd"]).numpy()
    n = got.shape[0]
    assert n > 0 and got.dtype == np.float16
    fbs = np.stack([search_mod.filterbank_from_packed(
        r[:n].numpy(), cfg.nbit, cfg.nchanout)
        for r in ran["rows"].values()])
    want = (fbs.sum(axis=0) * np.float32(1.0 / np.sqrt(len(fbs)))
            ).astype(np.float16)
    assert got.tobytes() == want.tobytes()


def test_the_brightest_trigger_is_the_references(cell, ran, searched):
    cfg = ran["acfg"].pipeline
    t = TriggerConfig()
    per_beam = {b: [c for _, r in v for c in r.cands]
                for b, v in searched.items()}
    want = max(ref_host.triggers(per_beam, COADD_BEAM, cfg.tsamp,
                                 vars(t), UNIX0), key=lambda x: x["sn"])
    got = max(ran["res"]["triggers"], key=lambda x: x.sn)
    assert got.dm == pytest.approx(want["dm"], rel=1e-6)
    assert got.sn == pytest.approx(want["sn"], rel=1e-3)
    assert (got.t0, got.t1) == pytest.approx((want["t0"], want["t1"]),
                                             abs=1e-6)


def test_dumps_hold_the_fed_seconds(ran):
    res = ran["res"]
    assert res["dumps"] and res["triggers"]
    brightest = max(res["triggers"], key=lambda x: x.sn)
    assert check_host.dump_mismatch(res["dumps"], ran["staged"], UNIX0,
                                    [brightest], brightest.dm) == 0.0
    assert {int(d.path.split("_ea")[1][:2]) for d in res["dumps"]} == \
        set(ran["staged"])
