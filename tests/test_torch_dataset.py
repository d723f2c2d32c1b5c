"""Dump files -> dataset -> delays -> localization through the port,
against the JAX package, on the CPU; and the port's CLI unwrap,
join-dumps and localize against the JAX CLI's.

The dumps follow tests/test_dataset.py: a broadband pulse train from a
known direction, per-antenna geometric delays, ragged start frames, one
antenna split over two fragment files.  Bars: each baseline's delay
within 0.01 sample of the JAX package's, the direction within 0.1 rad of
the truth, the localize JSON within 1e-4 rad (ENU) or 1e-4 degree (sky)
of the JAX CLI's, unwrap and join-dumps outputs byte-equal.
"""

import json

import numpy as np
import pytest

from vlite_fast_tpu import cli as jcli
from vlite_fast_tpu.analysis import baseband as jbb
from vlite_fast_tpu.analysis import dataset as jds
from vlite_fast_tpu_torch import cli as tcli
from vlite_fast_tpu_torch import constants as C
from vlite_fast_tpu_torch.analysis import baseband as tbb
from vlite_fast_tpu_torch.analysis import dataset as tds
from vlite_fast_tpu_torch.analysis import localization as loc
from vlite_fast_tpu_torch.utils import vdif

RATE = 1_000_000
POSITIONS = np.array([[0.0, 0.0, 0.0], [2400.0, 0.0, 0.0],
                      [0.0, 2400.0, 0.0], [900.0, 1700.0, 0.0]])
AZ, EL = 1.1, 0.7


def frac_shift(x: np.ndarray, shift_samples: float) -> np.ndarray:
    """Delay a real 1-D signal by a (fractional) number of samples."""
    n = x.size
    X = np.fft.rfft(x)
    f = np.fft.rfftfreq(n)
    return np.fft.irfft(X * np.exp(-2j * np.pi * f * shift_samples), n=n)


def write_dump(path, samples, station, sec0, frame0):
    vdif.streams_to_frames(samples, ref_epoch=40, start_second=sec0,
                           start_frame=frame0, station_id=station,
                           sample_rate=RATE).tofile(path)
    return str(path)


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """The directory of four stations' dumps (one in two fragments) and
    the positions file."""
    d = tmp_path_factory.mktemp("dumps")
    rng = np.random.default_rng(5)
    n = 320_000
    s_hat = loc.direction_unit(np.array(AZ), np.array(EL))
    tau = POSITIONS @ s_hat / loc.C_LIGHT
    margin, extra = 4000, 16 * 5000
    common = np.zeros(n + 2 * margin + extra, np.float64)
    common[rng.integers(margin, n, 60)] = 20.0
    common += 0.3 * rng.standard_normal(common.size)
    for k in range(len(POSITIONS)):
        sig = frac_shift(common, -tau[k] * RATE)[margin:margin + n + extra]
        x = np.stack([sig, sig]) + 0.5 * rng.standard_normal((2, sig.size))
        u = np.clip(x * 12.8 + 128.5, 0, 255).astype(np.uint8)
        off = int(rng.integers(0, 15))             # ragged start frames
        cut = u[:, off * 5000:off * 5000 + n]
        if k == 2:
            h = (cut.shape[1] // 2 // 5000) * 5000
            write_dump(d / "c1.vdif", cut[:, :h], k + 1, 9, off)
            write_dump(d / "c2.vdif", cut[:, h:], k + 1, 9, off + h // 5000)
        else:
            write_dump(d / f"ant{k}.vdif", cut, k + 1, 9, off)
    pos = d / "pos.json"
    pos.write_text(json.dumps({str(k + 1): list(p)
                               for k, p in enumerate(POSITIONS)}))
    return d, pos


def test_dataset_delays_and_fit_equal_jax(dumps):
    d, _ = dumps
    got_ds = tds.load_dataset(str(d), sample_rate=RATE)
    want_ds = jds.load_dataset(str(d), sample_rate=RATE)
    assert got_ds.station_ids == want_ds.station_ids == [1, 2, 3, 4]
    got, want = got_ds.aligned(), want_ds.aligned()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.samples, w.samples)
        assert g.start_time == w.start_time
    pairs = [(i, j) for i in range(4) for j in range(i + 1, 4)]
    delays = []
    for i, j in pairs:
        dt = tbb.baseline_delay_precise(got[i], got[j], nfft=500,
                                        device="cpu")[0]
        dj = jbb.baseline_delay_precise(want[i], want[j], nfft=500)[0]
        assert abs(dt - dj) * RATE < 0.01, (i, j, dt, dj)
        delays.append(dt)
    fit = loc.fit_tdoa(POSITIONS, pairs, np.array(delays), sigma=0.7 / RATE)
    assert abs(fit.az - AZ) < 0.1 and abs(fit.el - EL) < 0.1


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_localize_equals_jax(dumps, capsys):
    d, pos = dumps
    args = ["localize", str(d), "--positions", str(pos), "--nfft", "500",
            "--sigma-ns", str(0.7 / RATE * 1e9), "--sample-rate", str(RATE)]
    tcli.main(args + ["--device", "cpu"])
    got = _last_json(capsys)
    jcli.main(args)
    want = _last_json(capsys)
    assert got["stations"] == want["stations"] == [1, 2, 3, 4]
    assert abs(got["az_rad"] - want["az_rad"]) <= 1e-4
    assert abs(got["el_rad"] - want["el_rad"]) <= 1e-4
    assert abs(got["az_rad"] - AZ) < 0.1 and abs(got["el_rad"] - EL) < 0.1


def test_cli_localize_antprop_equals_jax(tmp_path, capsys):
    """The sky frame (--antprop, --clock-delays): RA/Dec equal to the JAX
    CLI's, on 3 antennas at VLA offsets."""
    rng = np.random.default_rng(41)
    center = loc.VLA_CENTER_ITRS
    up = center / np.linalg.norm(center)
    east = np.cross([0.0, 0.0, 1.0], up)
    east /= np.linalg.norm(east)
    north = np.cross(up, east)
    enu = np.array([[0.0, 0.0], [-1800.0, 2600.0], [2100.0, 2400.0]])
    offsets = enu[:, :1] * east + enu[:, 1:2] * north
    ants = [1, 2, 3]
    (tmp_path / "antprop.xml").write_text(
        '<AntennaPropertyTable creation="59000.0" configuration="B">'
        + "".join(f'<AntennaProperties name="ea{a:02d}"><X>{o[0]:.3f}</X>'
                  f'<Y>{o[1]:.3f}</Y><Z>{o[2]:.3f}</Z>'
                  f'<axisOffset>0</axisOffset></AntennaProperties>'
                  for a, o in zip(ants, offsets))
        + '<eopday><epoch>59000</epoch><tai_utc>37</tai_utc>'
        '<ut1_utc>0.0</ut1_utc><x_pole>0</x_pole><y_pole>0</y_pole>'
        '</eopday></AntennaPropertyTable>')
    clocks_ns = np.array([0.0, 850.0, -420.0])
    (tmp_path / "vliteantennas.in").write_text("".join(
        f"{k} {a} vlite-difx{k + 1} p1p2 {c:.6f} E{k:02d} {c:.6f} 1\n"
        for k, (a, c) in enumerate(zip(ants, clocks_ns))))
    s_enu = loc.direction_unit(np.array(2.1), np.array(np.pi / 3))
    s_itrs = s_enu[0] * east + s_enu[1] * north + s_enu[2] * up
    n, margin = 200_000, 4000
    shift = -(offsets @ s_itrs) / loc.C_LIGHT + clocks_ns * 1e-9
    common = np.zeros(n + 2 * margin, np.float64)
    common[rng.integers(margin, n, 60)] = 20.0
    common += 0.3 * rng.standard_normal(common.size)
    dumps = tmp_path / "dumps"
    dumps.mkdir()
    for k, a in enumerate(ants):
        sig = frac_shift(common, shift[k] * RATE)[margin:margin + n]
        x = np.stack([sig, sig]) + 0.5 * rng.standard_normal((2, n))
        u = np.clip(x * 12.8 + 128.5, 0, 255).astype(np.uint8)
        write_dump(dumps / f"ea{a:02d}.vdif", u, a, 1234, 0)
    args = ["localize", str(dumps), "--antprop", str(tmp_path / "antprop.xml"),
            "--clock-delays", str(tmp_path / "vliteantennas.in"),
            "--nfft", "500", "--sigma-ns", "100", "--sample-rate", str(RATE)]
    tcli.main(["--device", "cpu"] + args)
    got = _last_json(capsys)
    jcli.main(args)
    want = _last_json(capsys)
    assert got["stations"] == want["stations"] == ants
    assert abs(got["ra_deg"] - want["ra_deg"]) <= 1e-4
    assert abs(got["dec_deg"] - want["dec_deg"]) <= 1e-4


def _wrapped(path, seed=3):
    """A dump at the production frame numbering across a second boundary,
    its frame pairs rotated as a ring's wrap leaves them."""
    samples = np.random.default_rng(seed).integers(1, 255, (2, 5000 * 24),
                                                   dtype=np.uint8)
    frames = vdif.streams_to_frames(samples, 40, 70,
                                    start_frame=C.FRAMES_PER_SEC - 10,
                                    sample_rate=C.VLITE_RATE).reshape(
        -1, C.VDIF_FRAME_BYTES)
    np.roll(frames, -14, axis=0).tofile(path)
    return frames


@pytest.mark.parametrize("cmd", ["unwrap", "join-dumps"])
def test_cli_unwrap_and_join_equal_jax(tmp_path, capsys, cmd):
    outs = {}
    for name, main in (("t", tcli.main), ("j", jcli.main)):
        d = tmp_path / name
        d.mkdir()
        frames = _wrapped(d / "w.vdif")
        if cmd == "unwrap":
            main(["unwrap", str(d / "w.vdif")])
            out = d / "w.vdif.uw"
            np.testing.assert_array_equal(
                np.fromfile(out, np.uint8).reshape(frames.shape), frames)
        else:
            frames[:24].tofile(d / "b.vdif")
            frames[24:].tofile(d / "a.vdif")
            out = d / "joined.vdif"
            main(["join-dumps", str(d / "a.vdif"), str(d / "b.vdif"),
                  "-o", str(out)])
        outs[name] = (capsys.readouterr().out, out.read_bytes())
    t_out, j_out = outs["t"], outs["j"]
    if cmd == "join-dumps":
        t_json, j_json = json.loads(t_out[0]), json.loads(j_out[0])
        assert t_json.pop("out") != j_json.pop("out")
        assert t_json == j_json
    else:
        assert t_out[0] == j_out[0]
    assert t_out[1] == j_out[1]
