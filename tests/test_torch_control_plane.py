"""The port's control plane against the JAX package's, on the CPU: the VLA
XML documents, the sources-of-interest policy, the candidate batches on
the wire, the coincidencer over TCP, the messenger's document feed, the
recorder's triggers and the watchdog's counters.

Bar: equal objects (dataclasses field for field), byte-equal batches,
the same triggers from the same batches, the same commands from the same
documents.  Every socket binds port 0.
"""

import dataclasses
import os
import time

import numpy as np
import pytest

from tests.test_aux import ALERT_XML, ANTPROP_XML, FINISH_XML, OBS_XML
from vlite_fast_tpu.config import TriggerConfig as JTrigCfg
from vlite_fast_tpu.ops.dedisperse import Candidate as JCand
from vlite_fast_tpu.runtime import candidate_server as jcs
from vlite_fast_tpu.runtime import control as jctl
from vlite_fast_tpu.runtime import messenger as jmsg
from vlite_fast_tpu.runtime import recorder as jrec
from vlite_fast_tpu.runtime import sources as jsrc
from vlite_fast_tpu.runtime import vla_xml as jxml
from vlite_fast_tpu.runtime import watchdog as jwd
from vlite_fast_tpu_torch.config import TriggerConfig as TTrigCfg
from vlite_fast_tpu_torch.ops.dedisperse import Candidate as TCand
from vlite_fast_tpu_torch.runtime import candidate_server as tcs
from vlite_fast_tpu_torch.runtime import control as tctl
from vlite_fast_tpu_torch.runtime import messenger as tmsg
from vlite_fast_tpu_torch.runtime import recorder as trec
from vlite_fast_tpu_torch.runtime import sources as tsrc
from vlite_fast_tpu_torch.runtime import vla_xml as txml
from vlite_fast_tpu_torch.runtime import watchdog as twd

TSAMP = 1.0 / 1280


def _plain(obj):
    """A parsed document as plain data (dataclasses of either package)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


DOCS = {"obs": OBS_XML, "finish": FINISH_XML, "antprop": ANTPROP_XML,
        "alert": ALERT_XML}


@pytest.mark.parametrize("name", sorted(DOCS))
def test_vla_xml_documents_parse_equal(name):
    got, want = txml.parse_scaninfo(DOCS[name]), jxml.parse_scaninfo(DOCS[name])
    assert type(got).__name__ == type(want).__name__
    assert _plain(got) == _plain(want)
    if name in ("obs", "finish"):
        assert _plain(txml.parse_obs_document(DOCS[name])) == \
            _plain(jxml.parse_obs_document(DOCS[name]))
    if name == "antprop":
        assert _plain(txml.parse_antprop_document(DOCS[name])) == \
            _plain(jxml.parse_antprop_document(DOCS[name]))
    if name == "alert":
        t, j = txml.parse_alert_document(ALERT_XML), \
            jxml.parse_alert_document(ALERT_XML)
        assert (t.vla_ant, t.location_suffix) == (j.vla_ant, j.location_suffix)


OBSERVATIONS = [
    dict(name="PSR B0329+54 drift", ra=0.9, dec=0.95),
    dict(name="R3", ra=0.0, dec=0.0),
    dict(name="J9999+99", ra=0.0, dec=0.0, datasetId="TSKY.18B-405.eb1"),
    dict(name="J9999+99", ra=1.1448, dec=1.2857),
    dict(name="J9999+99", ra=2.0, dec=0.1, datasetId="20A-000"),
]


def test_source_whitelist_equal(tmp_path):
    tw, jw = tsrc.SourceWhitelist(), jsrc.SourceWhitelist()
    assert tw.to_json() == jw.to_json()
    for kw in OBSERVATIONS:
        assert tw.check_observation(tctl.ObservationDocument(**kw)) == \
            jw.check_observation(jctl.ObservationDocument(**kw))
        assert tw.check_name(kw["name"]) == jw.check_name(kw["name"])
        assert tw.check_coords(kw["ra"], kw["dec"]) == \
            jw.check_coords(kw["ra"], kw["dec"])
    assert tsrc.coord_dist(0.1, 0.2, 0.3, 0.4) == \
        jsrc.coord_dist(0.1, 0.2, 0.3, 0.4)
    path = str(tmp_path / "src.json")
    jw.save(path)
    assert tsrc.SourceWhitelist.load(path).to_json() == jw.to_json()


def _cands(mod, seed, n, dm=300.0, peak=100, snr=12.0):
    """n candidates of one pulse, plus noise candidates from a seed."""
    rng = np.random.default_rng(seed)
    out = [mod(snr=snr, peak_idx=peak, peak_time=peak * TSAMP, tfilt=2,
               dmi=30, dm=dm, ngiant=5, i0=peak - 5, i1=peak + 5)]
    for _ in range(n - 1):
        p = int(rng.integers(0, 5000))
        out.append(mod(snr=float(rng.uniform(6, 9)), peak_idx=p,
                       peak_time=p * TSAMP, tfilt=int(rng.integers(0, 5)),
                       dmi=int(rng.integers(0, 60)),
                       dm=float(rng.uniform(0, 600)), ngiant=1,
                       i0=p - 1, i1=p + 1))
    return out


def test_candidate_batch_byte_equal():
    for seed in range(3):
        t, j = _cands(TCand, seed, 6), _cands(JCand, seed, 6)
        payload = jcs.format_batch("1600000000", 3, j)
        assert tcs.format_batch("1600000000", 3, t) == payload
        utc, beam, cands = tcs.parse_batch(payload)
        assert (utc, beam) == ("1600000000", 3)
        assert [tuple(c) for c in cands] == \
            [tuple(c) for c in jcs.parse_batch(payload)[2]]
    with pytest.raises(ValueError):
        tcs.parse_batch(b"\n")


def _wait_triggers(srv, n, timeout=10.0):
    deadline = time.time() + timeout
    while len(srv.triggers) < n and time.time() < deadline:
        time.sleep(0.02)


def test_coincidencer_over_tcp_matches_jax():
    """Three beams' batches, the pulse in two of them (min_beams 2), sent
    over TCP to each package's server: the same triggers, and a garbage
    batch on the way leaves both serving."""
    results = []
    for cs, cand, tcfg in ((tcs, TCand, TTrigCfg), (jcs, JCand, JTrigCfg)):
        fired = []
        srv = cs.CoincidencerServer(port=0, tsamp=TSAMP,
                                    tcfg=tcfg(min_dm=20.0),
                                    on_trigger=fired.append)
        port = srv._srv.getsockname()[1]
        try:
            cli = cs.CandidateClient(port=port)
            import socket
            with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
                s.sendall(b"not a batch")
            for beam, seed in ((1, 0), (2, 1), (3, 2)):
                cands = _cands(cand, seed, 4)
                if beam == 3:
                    cands = cands[1:]          # no pulse in beam 3
                cli.send("1600000000", beam, cands)
            _wait_triggers(srv, 1)
            time.sleep(0.3)                    # any later trigger lands too
        finally:
            srv.close()
        results.append(([dataclasses.astuple(t) for t in srv.triggers],
                        [dataclasses.astuple(t) for t in fired]))
    (tt, tf), (jt, jf) = results
    assert tt and tt == jt and tf == tt and jf == jt


def test_coincidencer_ingest_matches_jax():
    """The same batches through ingest() directly, in several UTC groups:
    the same new triggers batch by batch (deduplicated per UTC)."""
    srv_t = tcs.CoincidencerServer(port=0, tsamp=TSAMP,
                                   tcfg=TTrigCfg(min_dm=20.0))
    srv_j = jcs.CoincidencerServer(port=0, tsamp=TSAMP,
                                   tcfg=JTrigCfg(min_dm=20.0))
    try:
        for utc in ("1600000000", "2020-09-13-12:26:40"):
            for beam, seed in ((1, 3), (2, 4), (1, 3)):
                payload = jcs.format_batch(utc, beam,
                                           _cands(JCand, seed, 3))
                got = srv_t.ingest(payload)
                want = srv_j.ingest(payload)
                assert [dataclasses.astuple(t) for t in got] == \
                    [dataclasses.astuple(t) for t in want]
        assert len(srv_t.triggers) == len(srv_j.triggers) == 2
    finally:
        srv_t.close()
        srv_j.close()


def test_messenger_document_feed_matches_jax(tmp_path):
    """The same document sequence through both messengers: the same
    commands, the same bus traffic to a client, the same archives,
    antenna positions and alerts."""
    out = []
    for msg, ctl in ((tmsg, tctl), (jmsg, jctl)):
        arch = tmp_path / msg.__name__
        m = msg.Messenger(msg.MessengerConfig(command_port=0,
                                              archive_dir=str(arch)))
        cli = ctl.CommandClient(port=m.bus._server.getsockname()[1])
        try:
            deadline = time.time() + 5
            while not m.bus._clients and time.time() < deadline:
                time.sleep(0.02)
            cmds = [[c.value for c in m.feed_xml(x)]
                    for x in (OBS_XML, ANTPROP_XML, ALERT_XML, FINISH_XML)]
            cmds.append([c.value for c in m.feed_observation(
                ctl.ObservationDocument(name="B0329+54", ra=0.9, dec=0.95,
                                        scan_no=4, start_time=1e9))])
            got = []
            deadline = time.time() + 5
            while len(got) < 3 and time.time() < deadline:
                got += [(c.value, od.name if od else None)
                        for c, od in cli.poll()]
            out.append((cmds, got, m.antenna_positions(),
                        _plain(m.alerts), sorted(
                            f.split("_", 2)[2] for f in os.listdir(arch)),
                        dict(m.metrics._values)))
        finally:
            cli.close()
            m.shutdown()
    assert out[0] == out[1]
    assert out[0][0] == [["S"], [], [], ["C"], ["S"]]
    assert [c for c, _ in out[0][1]] == ["S", "C", "S"]


def test_recorder_triggers_equal():
    t, j = trec.burst_triggers(1.6e9, 3.0, sn=2.0), \
        jrec.burst_triggers(1.6e9, 3.0, sn=2.0)
    assert dataclasses.astuple(t) == dataclasses.astuple(j)
    tp = list(trec.periodic_triggers(1.6e9, 2.0, 1.5, count=4))
    jp = list(jrec.periodic_triggers(1.6e9, 2.0, 1.5, count=4))
    assert [dataclasses.astuple(x) for x in tp] == \
        [dataclasses.astuple(x) for x in jp]
    sent = []
    assert trec.run_recorder(sent.append, count=3) == 3
    assert [s.t1 - s.t0 for s in sent] == [1.0] * 3


def test_watchdog_counters_equal():
    tc = twd.EscalatingCounter("skips", warn=3, abort=6)
    jc = jwd.EscalatingCounter("skips", warn=3, abort=6)
    steps = [1, 1, 1, 1, 2, 1]
    assert [tc.add(n) for n in steps] == [jc.add(n) for n in steps]
    tc.reset()
    jc.reset()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    ts, js = twd.StallDetector(timeout=5.0), jwd.StallDetector(timeout=5.0)
    for d in (ts, js):
        d.beat("capture", now=0.0)
        d.beat("search", now=4.0)
    assert ts.check(now=7.0) == js.check(now=7.0) == ["capture"]
    assert ts.check(now=10.0) == js.check(now=10.0)
