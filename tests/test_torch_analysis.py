"""The port's offline analysis (vlite_fast_tpu_torch.analysis) against the
JAX package's, on the CPU.

Voltages come from numpy seeds at a 1 MHz rate; both packages get the same
dumps.  Bars: filterbanks and correlations within 1e-4 of the largest
value (relative), fractional shifts within 1e-5 of the signal's rms,
baseline delays within 0.01 sample, the re-digitized beams at the chain
bar (>= 0.9999 of samples equal, none a count further).  The PNGs are
the port's own (no matplotlib): they decode with zlib to their stated
size.  The leader's watcher renders a .fil dropped into its directory.
"""

import os
import socket
import struct
import time
import zlib

import numpy as np
import pytest
import torch

from vlite_fast_tpu.analysis import baseband as jbb
from vlite_fast_tpu.analysis import beamforming as jbf
from vlite_fast_tpu.analysis import waterfall as jwf
from vlite_fast_tpu_torch.analysis import baseband as tbb
from vlite_fast_tpu_torch.analysis import beamforming as tbf
from vlite_fast_tpu_torch.analysis import waterfall as twf

RATE = 1_000_000


def _dump(pkg, u, station=1, t0=100.0):
    return pkg.VoltageDump(samples=u, start_time=t0, station_id=station,
                           sample_rate=RATE)


def _voltages(seed, n=200_000, delay=0, common=None):
    """(2, n) uint8: a common signal delayed by `delay` samples plus noise."""
    rng = np.random.default_rng(seed)
    if common is None:
        common = rng.standard_normal(n + 1000).astype(np.float32)
    x = np.stack([common[delay:delay + n]] * 2) \
        + 0.3 * rng.standard_normal((2, n)).astype(np.float32)
    return np.clip(x / 0.05914 + 128.5, 0, 255).astype(np.uint8), common


@pytest.fixture(scope="module")
def pair():
    ua, common = _voltages(4)
    ub, _ = _voltages(5, delay=7, common=common)
    uc, _ = _voltages(6, delay=3, common=common)
    return [ua, ub, uc]


def _close(got, want, rtol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = np.abs(got.astype(np.complex128) - want)
    assert diff.max() <= rtol * np.abs(want).max()


@pytest.mark.parametrize("dm", [0.0, 40.0])
def test_filterbank_equals_jax(pair, dm):
    kw = dict(nfft=500, coherent_dm=dm, bandwidth_mhz=0.5,
              freq_bot_mhz=320.0)
    _close(tbb.filterbank(_dump(tbb, pair[0]), device="cpu", **kw),
           jbb.filterbank(_dump(jbb, pair[0]), **kw))


def test_polyphase_filterbank_equals_jax(pair):
    _close(tbb.polyphase_filterbank(_dump(tbb, pair[0]), nfft=500,
                                    device="cpu"),
           jbb.polyphase_filterbank(_dump(jbb, pair[0]), nfft=500))


@pytest.mark.parametrize("nav,alpha", [(0, 0.0), (50, 0.0), (0, 4000.0)])
def test_correlate_equals_jax(pair, nav, alpha):
    kw = dict(nfft=500, nav=nav, alpha_hz=alpha)
    _close(tbb.correlate(_dump(tbb, pair[0]), _dump(tbb, pair[1], 2),
                         device="cpu", **kw),
           jbb.correlate(_dump(jbb, pair[0]), _dump(jbb, pair[1], 2), **kw))


@pytest.mark.parametrize("alpha", [0.0, 4000.0])
def test_correlation_matrix_equals_jax(pair, alpha):
    # ragged starts: re_order trims each to the common window
    starts = (100.0, 100.002, 99.999)
    got = tbb.correlation_matrix(
        [_dump(tbb, u, k + 1, t) for k, (u, t) in enumerate(zip(pair,
                                                               starts))],
        nfft=500, alpha_hz=alpha, device="cpu")
    want = jbb.correlation_matrix(
        [_dump(jbb, u, k + 1, t) for k, (u, t) in enumerate(zip(pair,
                                                               starts))],
        nfft=500, alpha_hz=alpha)
    _close(got, want)


def test_baseline_delays_equal_jax(pair):
    a, b = pair[0], pair[1]
    got = tbb.baseline_delay_precise(_dump(tbb, a), _dump(tbb, b, 2),
                                     nfft=500, device="cpu")
    want = jbb.baseline_delay_precise(_dump(jbb, a), _dump(jbb, b, 2),
                                      nfft=500)
    assert abs(got[0] - want[0]) * RATE < 0.01
    assert abs(got[0] * RATE - 7.0) < 0.1
    assert got[1] == pytest.approx(want[1], rel=1e-4)
    assert got[2] == pytest.approx(want[2], rel=1e-3)
    coarse = tbb.baseline_delay(_dump(tbb, a), _dump(tbb, b, 2), nfft=500,
                                device="cpu")
    assert coarse[0] == jbb.baseline_delay(_dump(jbb, a), _dump(jbb, b, 2),
                                           nfft=500)[0]


def test_clean_coherent_dedisperse_equals_jax(pair):
    x = _dump(tbb, pair[0]).voltages()
    kw = dict(bandwidth_mhz=0.5, freq_bot_mhz=320.0, smooth_bins=201)
    got, gflag = tbb.clean_coherent_dedisperse(x, 40.0, RATE, **kw)
    want, wflag = jbb.clean_coherent_dedisperse(x, 40.0, RATE, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gflag, wflag)


@pytest.mark.parametrize("delay", [3.0, 0.37, -12.625])
def test_fractional_shift_equals_jax(delay):
    import jax.numpy as jnp
    x = np.random.default_rng(11).standard_normal((2, 100_000)).astype(
        np.float32)
    got = tbf.fractional_shift(torch.from_numpy(x), delay).numpy()
    want = np.asarray(jbf.fractional_shift(jnp.asarray(x),
                                           jnp.float32(delay)))
    rms = np.sqrt(np.mean(want ** 2))
    assert np.abs(got - want).max() <= 1e-5 * rms


def _same_counts(got, want):
    """Re-digitized beams: the float sums agree to rounding, so a sample
    on a quantizer step may land one count apart; the chain bar (>= 0.9999
    equal), none further."""
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1 and (d == 0).mean() >= 0.9999, (d.max(),
                                                         (d == 0).mean())


def test_beamform_equals_jax(pair):
    delays = np.array([0.0, 7.0, 3.0]) / RATE
    got = tbf.beamform([_dump(tbb, u, k + 1) for k, u in enumerate(pair)],
                       delays_s=delays, device="cpu")
    want = jbf.beamform([_dump(jbb, u, k + 1) for k, u in enumerate(pair)],
                        delays_s=delays)
    _same_counts(got.samples, want.samples)
    assert got.start_time == want.start_time
    positions = np.array([[0.0, 0.0, 0.0], [900.0, 0.0, 0.0],
                          [0.0, 700.0, 0.0]])
    got = tbf.beamform_toward([_dump(tbb, u, k + 1)
                               for k, u in enumerate(pair)], positions,
                              0.8, 0.9, device="cpu")
    want = jbf.beamform_toward([_dump(jbb, u, k + 1)
                                for k, u in enumerate(pair)], positions,
                               0.8, 0.9)
    _same_counts(got.samples, want.samples)


def _png_size(path):
    """(width, height) of an 8-bit RGB PNG, after checking that its
    deflated rows decode to that size."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        assert struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == \
            zlib.crc32(kind + body) & 0xFFFFFFFF
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h, depth, colour = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, colour) == (8, 2) and b"IEND" in chunks
    assert len(zlib.decompress(chunks[b"IDAT"])) == h * (1 + 3 * w)
    return w, h


def _fil(path, ntime=3000, nchan=96, seed=2):
    from vlite_fast_tpu_torch.utils import sigproc
    data = np.random.default_rng(seed).integers(0, 4, (ntime, nchan),
                                                dtype=np.uint8)
    hdr = sigproc.FilterbankHeader(nchans=nchan, nbits=8, tsamp=1e-3,
                                   fch1=384.0, foff=-0.5,
                                   source_name="WF")
    with sigproc.FilterbankWriter(str(path), hdr) as w:
        w.write_block(data)
    return data


def test_waterfall_and_png(tmp_path):
    _fil(tmp_path / "a.fil")
    wf, meta = twf.waterfall_from_fil(str(tmp_path / "a.fil"),
                                      max_time=1000, max_chan=48)
    jwf_, jmeta = jwf.waterfall_from_fil(str(tmp_path / "a.fil"),
                                         max_time=1000, max_chan=48)
    np.testing.assert_array_equal(wf, jwf_)
    assert meta == jmeta and wf.shape == (1000, 48)
    twf.render_png(wf, meta, str(tmp_path / "a.png"))
    assert _png_size(tmp_path / "a.png") == (1000, 48)


def test_render_candidate_png(tmp_path):
    from vlite_fast_tpu_torch.ops.dedisperse import Candidate
    fb = np.random.default_rng(9).standard_normal((600, 64)).astype(
        np.float32)
    freqs = np.linspace(384.0, 352.0, 64)
    cand = Candidate(snr=9.0, peak_idx=300, peak_time=0.3, tfilt=2, dmi=3,
                     dm=20.0, ngiant=4, i0=296, i1=301)
    twf.render_candidate_png(fb, cand, 1e-3, freqs, str(tmp_path / "c.png"))
    from vlite_fast_tpu_torch.analysis import cutout
    _, blk = cutout.candidate_block(fb, cand, 1e-3, freqs, wmult=3)
    assert _png_size(tmp_path / "c.png") == \
        (blk.shape[0], 2 * 64 + twf.PROFILE_ROWS)


def test_cli_waterfall(tmp_path, capsys):
    from vlite_fast_tpu_torch import cli
    _fil(tmp_path / "obs.fil")
    cli.main(["waterfall", str(tmp_path / "obs.fil")])
    out = capsys.readouterr().out.strip()
    assert out == str(tmp_path / "obs.png")
    assert _png_size(out) == (3000, 96)


def _free_port(kind=socket.SOCK_STREAM):
    with socket.socket(socket.AF_INET, kind) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_leader_waterfall_renders_fil(tmp_path):
    """Leader(waterfall=True) starts the watcher thread, which renders a
    .fil dropped into the leader's directory."""
    from vlite_fast_tpu_torch.config import ArrayConfig
    from vlite_fast_tpu_torch.runtime.leader_main import Leader
    acfg = ArrayConfig.tiny(nant=1, command_port=_free_port(),
                            coincidencer_port=_free_port(),
                            trigger_port_base=_free_port(socket.SOCK_DGRAM))
    leader = Leader(acfg, str(tmp_path), waterfall=True)
    try:
        assert leader._wf_thread.is_alive()
        _fil(tmp_path / "late.part")        # a finished file appears whole
        os.replace(tmp_path / "late.part", tmp_path / "late.fil")
        deadline = time.time() + 30
        while not os.path.exists(tmp_path / "late.png") and \
                time.time() < deadline:
            time.sleep(0.2)
        assert _png_size(tmp_path / "late.png") == (3000, 96)
    finally:
        leader.shutdown()
    leader._wf_thread.join(timeout=10)
    assert not leader._wf_thread.is_alive()
