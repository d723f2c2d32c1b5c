"""process_second's hand-off of the seconds the injected track cannot
reach, on the CPU.

- `second_injects` says "injects" exactly where ops/injection.inject_frb
  multiplies some spectrum of the second by something other than 1: at
  the production station's geometry (portbench's station_fft
  configuration) at every second boundary and around the track's end,
  and at a tiny geometry for every segment offset from -1 past the
  window.
- `second_program`'s (kind, program) and the pfb WOLA kernel's gate
  (`wola_kernel_takes`) over the device, the arm state, the channelizer,
  dft_precision and the twin's resolution; never both fused launches.
- process_second routed as on a card (the device check monkeypatched)
  returns twin_second's outputs and state bit for bit (through one call
  of twin_second), marks the device stage "dft" alone and counts the
  second in "fused_seconds".
- A tiny injected station runs each second through the program
  `second_program` names, and through that one program's module name
  alone (as the benchmark's station harness wraps them).
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from vlite_fast_tpu_torch.config import PipelineConfig
from vlite_fast_tpu_torch.models import baseband_dsp as tdsp
from vlite_fast_tpu_torch.ops import injection as tinj
from vlite_fast_tpu_torch.utils import spans

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _station():
    dsp = json.loads((ROOT / "portbench" / "configs" / "station_fft.json")
                     .read_text())["dsp"]
    return PipelineConfig(**dsp)


def _tiny():
    return PipelineConfig.tiny(nbit=2, inject_frb=True, inject_dm=30.0,
                               inject_amp=1.5)


def _multiplied(cfg, since, chunk=1024):
    """Whether the program's injection multiplies some spectrum of the
    second `since` segments after the arm by something other than 1 (a
    second before any arm is not injected)."""
    if not (cfg.inject_frb and since >= 0):
        return False
    nspec = cfg.seg_per_sec * cfg.ffts_per_seg
    delays = torch.from_numpy(tdsp._frb_delays_np(cfg))
    width = cfg.inject_width_s * cfg.seg_per_sec * cfg.ffts_per_seg
    for c0 in range(0, cfg.nchan, chunk):
        d = delays[c0:c0 + chunk]
        amp = tinj.inject_frb(torch.ones((1, nspec, d.numel())), d,
                              since * cfg.ffts_per_seg, width,
                              cfg.inject_amp)
        if bool((amp != 1.0).any()):
            return True
    return False


def _station_offsets(cfg):
    """Every second's first segment after an arm through the second past
    the window, and the segments around the track's last spectrum and
    around _inject_active_limit_segs."""
    lo, hi = tdsp._track_spectra(cfg)
    last = int(hi.max()) // cfg.ffts_per_seg
    limit = tdsp._inject_active_limit_segs(cfg)
    spsec = cfg.seg_per_sec
    return sorted({-1, 0, 1, last - 1, last, last + 1, limit, limit + 1,
                   *(k * spsec for k in range(
                       tdsp.inject_window_seconds(cfg) + 1))})


@pytest.mark.parametrize("since", _station_offsets(_station()))
def test_station_predicate_is_the_multiplier(since):
    cfg = _station()
    assert tdsp.second_injects(cfg, since) == _multiplied(cfg, since)


def test_tiny_predicate_is_the_multiplier_at_every_offset():
    cfg = _tiny()
    window = tdsp.inject_window_seconds(cfg) * cfg.seg_per_sec
    got = [tdsp.second_injects(cfg, s) for s in range(-1, window + 2)]
    want = [_multiplied(cfg, s) for s in range(-1, window + 2)]
    assert got == want
    # the track ends inside the arming second: only it injects
    assert got.index(False, 1) < cfg.seg_per_sec + 1
    assert not any(got[cfg.seg_per_sec + 1:])


@pytest.mark.parametrize("cfg", [
    dataclasses.replace(_tiny(), inject_amp=1.0),
    dataclasses.replace(_tiny(), inject_frb=False)],
    ids=["amp_1", "no_injection"])
def test_nothing_injects_without_a_multiplier(cfg):
    assert not any(tdsp.second_injects(cfg, s) for s in range(-1, 30))
    assert not any(_multiplied(cfg, s) for s in (0, 1, 5))


class _Cuda:
    """A stand-in for a tensor on a card: only its device is read."""

    device = torch.device("cuda")


CPU = torch.zeros(2, 4)
FFT = PipelineConfig(inject_frb=True)        # the production station
PFB = dataclasses.replace(FFT, channelizer="pfb")

PS, TS = "process_second", "twin_second"

# (config, voltages, since) -> second_program's (kind, program), whether
# process_second hands the second to the twin's chain kernel on these
# voltages, and wola_kernel_takes
GATES = [
    ("fft unarmed", FFT, _Cuda(), -1, "twin", TS, True, False),
    ("fft arming second", FFT, _Cuda(), 0, "armed", PS, False, False),
    ("fft armed, on the track", FFT, _Cuda(), 317, "armed", PS, False,
     False),
    ("fft armed, past the track", FFT, _Cuda(), 320, "twin", TS, True,
     False),
    ("fft on the cpu", FFT, CPU, -1, "twin", TS, False, False),
    ("fft past the track on the cpu", FFT, CPU, 320, "twin", TS, False,
     False),
    ("fft highest", dataclasses.replace(FFT, dft_precision="highest"),
     _Cuda(), 320, "twin", TS, True, False),
    ("fft twin xla", dataclasses.replace(FFT, twin_chain_impl="xla"),
     _Cuda(), -1, "twin", PS, False, False),
    ("fft twin same", dataclasses.replace(FFT, twin_chain_impl="same"),
     _Cuda(), -1, "twin", PS, False, False),
    ("fft twin megakernel4",
     dataclasses.replace(FFT, twin_chain_impl="megakernel4"), _Cuda(), 320,
     "twin", TS, True, False),
    ("fft twin refused", dataclasses.replace(FFT, chain_impl="megakernel2"),
     _Cuda(), -1, "twin", PS, False, False),
    ("fft twin refused, arming second",
     dataclasses.replace(FFT, chain_impl="megakernel2"), _Cuda(), 0,
     "armed", PS, False, False),
    ("fft 8-bit: no chain kernel", dataclasses.replace(FFT, nbit=8),
     _Cuda(), -1, "twin", PS, False, False),
    ("fft no injection", dataclasses.replace(FFT, inject_frb=False),
     _Cuda(), 0, "twin", TS, True, False),
    ("pfb unarmed", PFB, _Cuda(), -1, "twin", PS, False, True),
    ("pfb arming second", PFB, _Cuda(), 0, "armed", PS, False, True),
    ("pfb armed, past the track", PFB, _Cuda(), 320, "twin", PS, False,
     True),
    ("pfb armed later", PFB, _Cuda(), 640, "twin", PS, False, True),
    ("pfb on the cpu", PFB, CPU, 320, "twin", PS, False, False),
    ("pfb highest", dataclasses.replace(PFB, dft_precision="highest"),
     _Cuda(), 320, "twin", PS, False, False),
    ("pfb twin refused",
     dataclasses.replace(PFB, twin_chain_impl="megakernel2"), _Cuda(), -1,
     "twin", PS, False, True),
]


@pytest.mark.parametrize("cfg,v,since,kind,program,chain,wola",
                         [g[1:] for g in GATES], ids=[g[0] for g in GATES])
def test_gates(cfg, v, since, kind, program, chain, wola):
    got_kind, got_program, _ = tdsp.second_program(cfg, since)
    assert (got_kind, got_program.__name__) == (kind, program)
    assert (got_program is tdsp.twin_second and tdsp._on_card(v)) == chain
    assert tdsp.wola_kernel_takes(cfg, v) == wola
    # a second takes one fused launch at most: the WOLA kernel in a twin
    # second process_second keeps
    assert not (chain and wola)


@pytest.mark.parametrize("cfg,since,chain_impl", [
    (FFT, -1, "megakernel2"), (FFT, 0, "xla"), (PFB, -1, "xla"),
    (dataclasses.replace(FFT, twin_chain_impl="megakernel4"), -1,
     "megakernel4")], ids=["fft twin", "fft armed", "pfb twin", "fft v4"])
def test_second_program_config(cfg, since, chain_impl):
    kind, _, pcfg = tdsp.second_program(cfg, since)
    if kind == "armed":
        assert pcfg is cfg
    else:
        assert pcfg == tdsp.twin_config(cfg) and not pcfg.inject_frb
    assert pcfg.chain_impl == chain_impl


def test_refused_twin_keeps_process_second():
    cfg = dataclasses.replace(FFT, chain_impl="megakernel2")
    with pytest.raises(ValueError):
        tdsp.twin_config(cfg)
    for since in (-1, 320):
        kind, program, pcfg = tdsp.second_program(cfg, since)
        assert (kind, program, pcfg) == ("twin", tdsp.process_second, cfg)


def _raw(cfg, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.clip(
        rng.standard_normal((cfg.npol_in, cfg.sample_rate)) / 0.05914
        + 128.5, 0, 255).astype(np.uint8))


@pytest.mark.parametrize("since,arm", [(-1, False), (10, False),
                                       (-1, True)],
                         ids=["unarmed", "past_the_track", "arm_no_frb"])
def test_process_second_hands_the_second_to_the_twin(monkeypatch, since,
                                                     arm):
    cfg = _tiny()
    if arm:
        cfg = dataclasses.replace(cfg, inject_frb=False)
    monkeypatch.setattr(tdsp, "_on_card", lambda v: True)
    twin, handed = tdsp.twin_second, []
    monkeypatch.setattr(tdsp, "twin_second",
                        lambda *a: handed.append(1) or twin(*a))
    raw = _raw(cfg, 3)
    st = tdsp.seed_bandpass(cfg, raw, tdsp.init_state(cfg, "cpu"))
    st = st._replace(segs_since_inject=since)
    rec = spans.Record("call", 0)
    with spans.bound(rec):
        got, st_g = tdsp.process_second(cfg, raw, st, arm)
    assert handed == [1]
    want, st_w = twin(tdsp.twin_config(cfg), raw, st, arm)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(st_g.bp, st_w.bp)
    assert torch.equal(st_g.bp_kur, st_w.bp_kur)
    start = 0 if arm else since
    assert st_g.segs_since_inject == (start + cfg.seg_per_sec
                                      if start >= 0 else -1)
    rec.resolve()
    assert set(rec.stages) == {"dft"}
    assert rec.counters == {"fused_seconds": 1}


def test_process_second_keeps_the_arming_second(monkeypatch):
    cfg = _tiny()
    monkeypatch.setattr(tdsp, "_on_card", lambda v: True)
    raw = _raw(cfg, 4)
    st = tdsp.init_state(cfg, "cpu")
    rec = spans.Record("call", 0)
    with spans.bound(rec):
        got, st_g = tdsp.process_second(cfg, raw, st, True)
    want, st_w = tdsp.process_second_plain(cfg, raw, st, True)
    rec.resolve()
    assert "fused_seconds" not in rec.counters
    assert {"front", "dft", "detect", "ema", "pack"} <= set(rec.stages)
    assert torch.equal(got.weights, want.weights)
    assert st_g.segs_since_inject == st_w.segs_since_inject == \
        cfg.seg_per_sec


@pytest.mark.parametrize("twin", ["auto", "xla"])
def test_station_runs_the_program_second_program_names(monkeypatch,
                                                       tmp_path, twin):
    """Each fed second's kind (its feed_seconds key and span counter) is
    second_program's for that second, and the second reaches that
    program's module name alone: the station never sends a second to both
    names, even routed as on a card (the device check monkeypatched)."""
    from vlite_fast_tpu_torch.config import SearchConfig
    from vlite_fast_tpu_torch.runtime.pipeline import (ObservationDocument,
                                                       StationPipeline)
    cfg = dataclasses.replace(_tiny(), twin_chain_impl=twin)
    n = 4
    want = [tdsp.second_program(cfg, s * cfg.seg_per_sec) for s in range(n)]
    monkeypatch.setattr(tdsp, "_on_card", lambda v: True)
    reached = []
    for name in ("process_second", "twin_second"):
        monkeypatch.setattr(tdsp, name, lambda *a, _n=name,
                            _f=getattr(tdsp, name): reached.append(_n)
                            or _f(*a))
    pipe = StationPipeline(1, cfg, SearchConfig.tiny(), out_dir=str(tmp_path),
                           keep_ring=False, write_cands=False, device="cpu")
    pipe.run_observation(((1.6e9 + s, _raw(cfg, 30 + s).numpy())
                          for s in range(n)),
                         ObservationDocument(name="ROUTE", start_time=1.6e9),
                         write_fil=False)
    kinds = ["armed" if rec.counters["armed"] else "twin"
             for rec in pipe.records.seconds]
    assert kinds == [k for k, _, _ in want] == ["armed"] + ["twin"] * (n - 1)
    assert reached == [p.__name__ for _, p, _ in want]
    assert len(pipe.feed_seconds["armed"]) == 1
    assert len(pipe.feed_seconds["twin"]) == n - 1
