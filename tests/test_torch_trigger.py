"""The port's coincidencer and trigger plane (runtime/trigger.py) against
the JAX package's, on the CPU.

The same candidate sets go through both packages' coincidence and
make_triggers: equal beam masks, equal triggers, equal wire bytes.  The
sets are tests/test_trigger.py's cases (overlap rules, a pair straddling
a slice, the trigger cuts, a lone beam, window merge, the coadd beam's
bar) and seeded random sets.
"""

import dataclasses
import struct

import numpy as np
import pytest

from vlite_fast_tpu.config import TriggerConfig as JTrigCfg
from vlite_fast_tpu.ops.dedisperse import Candidate as JCand
from vlite_fast_tpu.runtime import trigger as jtrig
from vlite_fast_tpu_torch.config import TriggerConfig
from vlite_fast_tpu_torch.ops.dedisperse import Candidate
from vlite_fast_tpu_torch.runtime import trigger as trig

TSAMP = 1.0 / 1280
COADD = -1


def cand(sn=10.0, dm=80.0, i0=1000, i1=1010, tfilt=3, dmi=40):
    return Candidate(snr=sn, peak_idx=(i0 + i1) // 2,
                     peak_time=(i0 + i1) / 2 * TSAMP, tfilt=tfilt,
                     dmi=dmi, dm=dm, ngiant=1, i0=i0, i1=i1)


def _random_set(seed):
    """Seeded candidates in 4 beams and the coadd beam: a few events seen
    by several beams at jittered times, widths and DMs, and noise."""
    rng = np.random.default_rng(seed)
    per_beam = {b: [] for b in (1, 2, 3, 4, COADD)}
    for _ in range(6):
        t, dm = int(rng.integers(0, 20000)), float(rng.uniform(5, 900))
        w = int(rng.integers(1, 60))
        for b in per_beam:
            if rng.random() < 0.6:
                i0 = t + int(rng.integers(-5, 6))
                per_beam[b].append(cand(
                    sn=float(rng.uniform(5, 30)),
                    dm=dm * float(rng.uniform(0.95, 1.05)), i0=i0,
                    i1=i0 + w + int(rng.integers(0, 4))))
    for b in per_beam:
        for _ in range(int(rng.integers(0, 5))):
            i0 = int(rng.integers(0, 20000))
            per_beam[b].append(cand(sn=float(rng.uniform(5, 12)),
                                    dm=float(rng.uniform(1, 1000)), i0=i0,
                                    i1=i0 + int(rng.integers(1, 40))))
    return per_beam


SETS = {
    "beam_mask": {0: [cand()], 1: [cand(i0=1002, i1=1012)],
                  2: [cand(i0=5000, i1=5010)]},
    "straddling_pair": {0: [cand(i0=1200, i1=1270)],
                        1: [cand(i0=1250, i1=1300)]},
    "cuts": {0: [cand(sn=12.0), cand(sn=12.0, dm=10.0, i0=3000, i1=3010),
                 cand(sn=5.0, i0=7000, i1=7010)],
             1: [cand(sn=9.0, i0=1003, i1=1013),
                 cand(sn=12.0, dm=10.0, i0=3001, i1=3011),
                 cand(sn=5.0, i0=7001, i1=7011)]},
    "single_beam": {0: [cand(sn=50.0)]},
    "window_merge": {0: [cand(sn=12.0, i0=1000, i1=1010),
                         cand(sn=15.0, i0=1100, i1=1110)],
                     1: [cand(sn=12.0, i0=1001, i1=1011),
                         cand(sn=15.0, i0=1101, i1=1111)]},
    # the coadd beam alone: no min_beams cut, its own S/N bar
    "coadd_bar": {COADD: [cand(sn=9.0), cand(sn=12.0, i0=4000, i1=4010)],
                  1: [cand(sn=12.0, i0=8000, i1=8010)]},
    **{f"random{seed}": _random_set(seed) for seed in range(6)},
}


def _jax(per_beam):
    return {b: [JCand(*c) for c in cs] for b, cs in per_beam.items()}


@pytest.mark.parametrize("name", sorted(SETS))
def test_coincidence_and_triggers_match_jax(name):
    per_beam = SETS[name]
    got = trig.coincidence(per_beam, TSAMP)
    want = jtrig.coincidence(_jax(per_beam), TSAMP)
    assert [(bc.beam, tuple(bc.cand), bc.beam_mask.tolist()) for bc in got] \
        == [(bc.beam, tuple(bc.cand), bc.beam_mask.tolist()) for bc in want]
    cfg = TriggerConfig()
    jcfg = JTrigCfg(**dataclasses.asdict(cfg))
    t = trig.make_triggers(got, 1_700_000_000.0, cfg, coadd_beam=COADD)
    j = jtrig.make_triggers(want, 1_700_000_000.0, jcfg, coadd_beam=COADD)
    assert [dataclasses.astuple(x) for x in t] == \
        [dataclasses.astuple(x) for x in j]
    assert [x.pack() for x in t] == [x.pack() for x in j]
    if name == "cuts":          # only the first event passes
        assert len(t) == 1 and t[0].sn == 12.0
        assert abs(t[0].t0 - (1_700_000_000.0 + 1000 * TSAMP - 0.1)) < 1e-6
    if name in ("single_beam", "window_merge", "straddling_pair"):
        assert len(t) == {"single_beam": 0, "window_merge": 1,
                          "straddling_pair": 1}[name]
    if name == "coadd_bar":     # 9 < the coadd bar < 12; beam 1 alone: none
        assert [x.sn for x in t] == [12.0] and "beam-1" in t[0].meta


@pytest.mark.parametrize("legacy", [False, True])
def test_trigger_wire_format_matches_jax(legacy):
    t = trig.Trigger(t0=1.5, t1=3.25, sn=12.5, dm=80.0, width=0.004,
                     peak_time=2.0, meta="beam3 nbeam4")
    j = jtrig.Trigger(**dataclasses.asdict(t))
    buf = t.pack_legacy() if legacy else t.pack()
    assert buf == (j.pack_legacy() if legacy else j.pack())
    assert dataclasses.astuple(trig.Trigger.unpack(buf)) == \
        dataclasses.astuple(jtrig.Trigger.unpack(buf))
    for n in (150, 159, 100, 10):
        with pytest.raises(struct.error):
            trig.Trigger.unpack(t.pack()[:n])


def test_coadd_bar_above_beam_bar():
    cfg = TriggerConfig()
    assert cfg.coadd_snr_thresh > cfg.snr_thresh
