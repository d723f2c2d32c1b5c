"""The port's own copies of the JAX package's jax-free host modules
(vlite_fast_tpu_torch.constants, .config, .runtime.control) held equal
to the originals:
the same constants, the same dataclass fields and defaults, the same
derived properties and the same validation errors over a small grid of
configurations.  Tests that feed both packages build the port's config
from the JAX one's fields (PortCfg(**dataclasses.asdict(jax_cfg)), held
equal here).  The port's verbatim copies of host modules and of the C++
ring and capture helper are held to their originals text for text; the
adapted ones (capture, station_main, leader_main, cli) are held by
behaviour in their own tests.
"""

import dataclasses

import numpy as np
import pytest

from vlite_fast_tpu import config as jcfg
from vlite_fast_tpu import constants as jC
from vlite_fast_tpu_torch import config as tcfg
from vlite_fast_tpu_torch import constants as tC

CLASSES = ("PipelineConfig", "SearchConfig", "TriggerConfig",
           "AntennaConfig", "ArrayConfig")
PROPERTIES = ("nchan", "nchanout", "seg_samps", "ffts_per_seg",
              "windows_per_fft", "nwin_per_seg", "tsamp", "tspec",
              "bp_scale", "out_samps_per_seg", "chan_bw_mhz", "fch1_mhz")


def test_constants_equal():
    names = [n for n in vars(jC) if n.isupper()]
    assert names and names == [n for n in vars(tC) if n.isupper()]
    for n in names:
        assert getattr(tC, n) == getattr(jC, n), n
    freqs = jC.channel_freqs_mhz()
    assert np.array_equal(tC.channel_freqs_mhz(), freqs)
    assert np.array_equal(tC.channel_freqs_mhz(101), jC.channel_freqs_mhz(101))
    assert np.array_equal(tC.dispersion_delay_s(80.0, freqs, 384.0),
                          jC.dispersion_delay_s(80.0, freqs, 384.0))
    for n in (500, 12500):
        assert tC.dagostino_constants(n) == jC.dagostino_constants(n)


def _default(f):
    if f.default_factory is not dataclasses.MISSING:
        return f.default_factory()
    return f.default                  # MISSING for a required field


@pytest.mark.parametrize("name", CLASSES)
def test_fields_and_defaults_equal(name):
    jf = dataclasses.fields(getattr(jcfg, name))
    tf = dataclasses.fields(getattr(tcfg, name))
    assert [f.name for f in tf] == [f.name for f in jf]
    assert [f.type for f in tf] == [f.type for f in jf]
    for a, b in zip(tf, jf):
        da, db = _default(a), _default(b)
        if dataclasses.is_dataclass(db):
            da, db = dataclasses.asdict(da), dataclasses.asdict(db)
        elif isinstance(db, tuple) and db and dataclasses.is_dataclass(db[0]):
            da = [dataclasses.asdict(x) for x in da]
            db = [dataclasses.asdict(x) for x in db]
        assert da == db, a.name


# name -> (from PipelineConfig.tiny, keyword arguments)
PIPELINES = {
    "default": (False, {}),
    "staged": (False, dict(rfi_mode=0, dft_exact_input=True)),
    "tiny": (True, {}),
    "tiny_2bit": (True, dict(nbit=2)),
    "tiny_4bit_scrunch2": (True, dict(nbit=4, nscrunch=2, chanmin=20,
                                      chanmax=211)),
}


def _pipeline(mod, case):
    tiny, kw = PIPELINES[case]
    return (mod.PipelineConfig.tiny if tiny else mod.PipelineConfig)(**kw)


@pytest.mark.parametrize("case", sorted(PIPELINES))
def test_pipeline_derived_properties_equal(case):
    j, t = _pipeline(jcfg, case), _pipeline(tcfg, case)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert tcfg.PipelineConfig(**dataclasses.asdict(j)) == t
    for p in PROPERTIES:
        assert getattr(t, p) == getattr(j, p), p
    assert np.array_equal(t.freqs_mhz(), j.freqs_mhz())


@pytest.mark.parametrize("maker", ["__call__", "tiny", "low_latency"])
def test_search_configs_equal(maker):
    make = lambda mod: (mod.SearchConfig() if maker == "__call__"
                        else getattr(mod.SearchConfig, maker)())
    j, t = make(jcfg), make(tcfg)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert tcfg.SearchConfig(**dataclasses.asdict(j)) == t


def test_array_config_json_equal():
    j, t = jcfg.ArrayConfig.tiny(), tcfg.ArrayConfig.tiny()
    assert t.to_json() == j.to_json()
    assert tcfg.ArrayConfig.from_json(j.to_json()) == t
    assert t.nant == j.nant


BAD = [
    dict(sample_rate=1_000_010),              # seg_samps % nfft
    dict(nkurto=49),                          # nfft % nkurto
    dict(nscrunch=3),                         # ffts_per_seg % nscrunch
    dict(nbit=3),
    dict(rfi_impl="cuda"),
    dict(front_layout="rows"),
    dict(dft_stage2="fft"),
    dict(batch_streams=True, ema_impl="pallas"),
    dict(dft_precision="default"),
    dict(chanmin=300),                        # past nchan
    dict(chanmin=16, chanmax=17, nbit=2),     # not byte-commensurate
]


@pytest.mark.parametrize("i", range(len(BAD)))
def test_validation_errors_equal(i):
    with pytest.raises(ValueError) as je:
        jcfg.PipelineConfig.tiny(**BAD[i])
    with pytest.raises(ValueError) as te:
        tcfg.PipelineConfig.tiny(**BAD[i])
    assert str(te.value) == str(je.value)


def test_control_copy_equal():
    """runtime/control.py: the same observation document (fields, JSON,
    the ring's ASCII header), commands, thresholds and scan decisions."""
    from vlite_fast_tpu.runtime import control as jctl
    from vlite_fast_tpu_torch.runtime import control as tctl
    assert [f.name for f in dataclasses.fields(tctl.ObservationDocument)] \
        == [f.name for f in dataclasses.fields(jctl.ObservationDocument)]
    assert [(c.name, c.value) for c in tctl.Command] == \
        [(c.name, c.value) for c in jctl.Command]
    assert (tctl.POINTING_TOL_RAD, tctl.MAX_INTEGRATION_S) == \
        (jctl.POINTING_TOL_RAD, jctl.MAX_INTEGRATION_S)
    kw = dict(name="J0534+2200", ra=1.459, dec=0.384, start_time=1.7e9 + 0.25,
              scan_no=7, subscan_no=2, datasetId="x")
    t, j = tctl.ObservationDocument(**kw), jctl.ObservationDocument(**kw)
    assert t.to_json() == j.to_json()
    assert tctl.ObservationDocument.from_json(j.to_json()) == t
    assert t.to_ascii_header(3) == j.to_ascii_header(3)
    docs = [dict(name="A", ra=1.0, dec=0.5, scan_no=2),
            dict(name="A", ra=1.0 + 1e-4, dec=0.5, scan_no=3),
            dict(name="B", ra=2.0, dec=0.9, scan_no=4),
            dict(name="B", ra=2.0, dec=0.9, scan_no=5),
            dict(name="x", scan_no=1), dict(name="FINISH")]
    times = [0.0, 100.0, 200.0, 681.0, 700.0, 800.0]
    sm_t, sm_j = tctl.ScanStateMachine(), jctl.ScanStateMachine()
    for d, now in zip(docs, times):
        got = sm_t.feed(tctl.ObservationDocument(**d), now=now)
        want = sm_j.feed(jctl.ObservationDocument(**d), now=now)
        assert [c.value for c in got] == [c.value for c in want]


# the port's verbatim copies: (the port's file, the JAX package's file)
COPIES = [(f"vlite_fast_tpu_torch/{p}", f"vlite_fast_tpu/{p}") for p in (
    "utils/log.py", "utils/sigproc.py", "utils/vdif.py",
    "runtime/control.py", "runtime/trigger.py", "runtime/dumper.py",
    "runtime/vla_xml.py", "runtime/sources.py",
    "runtime/candidate_server.py", "runtime/messenger.py",
    "runtime/recorder.py", "runtime/watchdog.py", "models/synthesis.py",
    "analysis/unwrap.py", "analysis/dataset.py", "analysis/spectral.py",
    "analysis/localization.py", "analysis/cutout.py")]
COPIES += [("vlite_fast_tpu_torch/csrc/netcap.cpp", "csrc/netcap.cpp"),
           ("vlite_fast_tpu_torch/csrc/ringbuffer.cpp", "csrc/ringbuffer.cpp")]


def _body(path: str) -> str:
    """The file's text after its leading docstring or comment block (the
    port's copies say there whose copy they are)."""
    import ast
    import pathlib
    text = (pathlib.Path(__file__).resolve().parent.parent / path).read_text()
    if path.endswith(".py"):
        doc = ast.parse(text).body[0]
        assert isinstance(doc, ast.Expr) and isinstance(doc.value,
                                                        ast.Constant)
        return "\n".join(text.splitlines()[doc.end_lineno:])
    lines = text.splitlines()
    start = next(i for i, ln in enumerate(lines)
                 if not ln.startswith("//") and ln.strip())
    return "\n".join(lines[start:])


@pytest.mark.parametrize("port,ref", COPIES, ids=[p for p, _ in COPIES])
def test_verbatim_copy_equal(port, ref):
    """Each copy is its original, text for text past the header, once
    vlite_fast_tpu is read as vlite_fast_tpu_torch."""
    want = _body(ref).replace("vlite_fast_tpu", "vlite_fast_tpu_torch")
    assert _body(port) == want
