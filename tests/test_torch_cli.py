"""The port's CLI (python -m vlite_fast_tpu_torch.cli) against the JAX
package's, on the CPU at a tiny rate (1 MHz, 0.5 MHz of band): synth's
bytes, process's and search's candidates, the operator commands' output,
and `launch --fake --device cpu` with two station daemons of the port
over real sockets.

Bar: synth byte-equal; candidates (the JAX package's gulp search at each
gulp's own length, as the port's: tests/jax_true_length.py; its station
from the port's first bandpass: tests/jax_seeded.py) to
tests/test_torch_pipeline.py's bar
(those clear of the threshold by 0.5 have equal DM index, peak index and
width, S/N within rtol 1e-3); the operator commands print the same.
Every port is bound by its own socket or checked free just before use.
"""

import glob
import json
import os
import socket
import sys

import numpy as np
import pytest
import torch

from vlite_fast_tpu import cli as jcli
from vlite_fast_tpu_torch import cli as tcli
from vlite_fast_tpu_torch.ops.dedisperse import Candidate
from vlite_fast_tpu_torch.runtime.station_main import SUMMARY

torch.set_num_threads(1)
TINY = ["--rate", "1000000", "--freq-top", "320.5", "--bandwidth", "0.5"]
SYNTH = ["-t", "2", "-d", "300", "-p", "0.05", "-k", "16", "-a", "0.4",
         "--rate", "1000000", "--bandwidth", "0.5", "--buflen", "250000"]


def _run(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def vdif_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("synth") / "obs.vdif")
    tcli.main(["synth", *SYNTH, "-r", "21", "-o", path])
    return path


@pytest.mark.parametrize("seed,rfi", [(21, False), (5, True)])
def test_synth_byte_equal(tmp_path, capsys, seed, rfi):
    extra = ["-r", str(seed)] + (["-f"] if rfi else [])
    tout = json.loads(_run(tcli.main, ["synth", *SYNTH, *extra, "-o",
                                       str(tmp_path / "t.vdif")], capsys))
    jout = json.loads(_run(jcli.main, ["synth", *SYNTH, *extra, "-o",
                                       str(tmp_path / "j.vdif")], capsys))
    assert (tmp_path / "t.vdif").read_bytes() == \
        (tmp_path / "j.vdif").read_bytes()
    tout.pop("out"), jout.pop("out")
    assert tout == jout


def _clear(lines, thresh=6.0):
    return sorted((c.dmi, c.peak_idx, c.tfilt, c.snr)
                  for c in map(Candidate.from_line, lines)
                  if c.snr > thresh + 0.5)


def _same(got, want):
    g, w = _clear(got), _clear(want)
    assert w
    assert [c[:3] for c in g] == [c[:3] for c in w]
    np.testing.assert_allclose([c[3] for c in g], [c[3] for c in w],
                               rtol=1e-3)


@pytest.fixture(scope="module")
def processed(vdif_path, tmp_path_factory):
    """Both packages' `process` on the same file (and its .fil), the JAX
    package's gulp search at each gulp's own length, as the port's
    (jax_true_length: the stream's last gulp is short), its station from
    the port's first bandpass (jax_seeded)."""
    from jax_seeded import seeded
    from jax_true_length import true_length
    out = {}
    for name, main, extra in (("torch", tcli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        d = str(tmp_path_factory.mktemp(name))
        import io
        from contextlib import redirect_stdout
        buf = io.StringIO()
        with redirect_stdout(buf), true_length(), seeded():
            main(["process", vdif_path, *TINY, "--ndm", "61", "-o", d,
                  *extra])
        out[name] = json.loads(buf.getvalue().strip().splitlines()[-1])
    return out


def test_process_candidates_match_jax(processed):
    t, j = processed["torch"], processed["jax"]
    assert t["seconds"] == j["seconds"] == 2
    _same(t["candidates"], j["candidates"])
    assert os.path.getsize(t["fil"]) == os.path.getsize(j["fil"])
    assert os.path.basename(t["fil"]) == os.path.basename(j["fil"])
    # the port's readings: the replay's wall inside the run's; no kernel
    # launched on the CPU
    assert 0 < t["replay_s"] < t["wall_s"]
    assert t["launches"] == {} and t["peak_device_gib"] is None


def test_search_candidates_match_jax(processed, capsys):
    """`search` of the .fil, the last gulp at its own length in both
    (jax_true_length)."""
    from jax_true_length import true_length
    fil = processed["torch"]["fil"]
    args = ["search", fil, "--dm-min", "0", "--dm-max", "600", "--ndm",
            "61", "--gulp", "512", "--boxcar", "16"]
    got = _run(tcli.main, ["--device", "cpu", *args], capsys).splitlines()
    with true_length():
        want = _run(jcli.main, args, capsys).splitlines()
    _same(got, want)


def test_operator_commands_print_the_same(tmp_path, capsys):
    from tests.test_aux import OBS_XML
    xml = tmp_path / "obs.xml"
    xml.write_text(OBS_XML)
    cands = []
    for k in range(2):
        p = tmp_path / f"b{k}.cand"
        p.write_text("# beam\n" + "".join(
            Candidate(10.0 + 3 * k - i, 100 * i, 0.01 * i, 1, 3, 30.0, 1,
                      100 * i, 100 * i + 4).to_line() + "\n"
            for i in range(3)))
        cands.append(str(p))
    arch = tmp_path / "arch"
    arch.mkdir()
    (arch / "20200101_000000_obsinfo.xml").write_text(OBS_XML)
    for argv in (["print-obsdoc", str(xml)],
                 ["merge-cands", *cands], ["merge-cands", *cands, "--top",
                                           "2"],
                 ["send-cmd", "S", "--name", "J0534+2200"],
                 ["send-cmd", "Q"],
                 ["disk-usage", str(tmp_path)],
                 ["clean", str(tmp_path), "--days", "0"],
                 ["find-obs", str(arch), "--ra", "0", "--dec", "0",
                  "--radius", "10"]):
        assert _run(tcli.main, argv, capsys) == _run(jcli.main, argv,
                                                     capsys), argv


def test_scrub_ring(capsys):
    name = f"/vfast_torch_scrub_{os.getpid()}"
    try:
        out = json.loads(_run(tcli.main, ["scrub-ring", name, "--bufsz",
                                          "4096", "--nbufs", "4"], capsys))
        assert out == {"ring": name, "bufsz": 4096, "nbufs": 4,
                       "replaced": False}
        assert os.path.exists("/dev/shm" + name)
        out = json.loads(_run(tcli.main, ["scrub-ring", name, "--bufsz",
                                          "4096"], capsys))
        assert out["replaced"] is True and out["nbufs"] == 8
    finally:
        if os.path.exists("/dev/shm" + name):
            os.unlink("/dev/shm" + name)


def _free_ports(n, kind=socket.SOCK_STREAM, consecutive=False):
    """n ports free right now (bound, read, released); consecutive ones
    from a free base when asked."""
    while True:
        socks = []
        try:
            s = socket.socket(socket.AF_INET, kind)
            s.bind(("127.0.0.1", 0))
            socks.append(s)
            base = s.getsockname()[1]
            for k in range(1, n):
                s = socket.socket(socket.AF_INET, kind)
                s.bind(("127.0.0.1", base + k if consecutive else 0))
                socks.append(s)
            return [s.getsockname()[1] for s in socks]
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()


def _array(tmp_path, vdif):
    from vlite_fast_tpu_torch.config import (AntennaConfig, ArrayConfig,
                                             PipelineConfig, SearchConfig,
                                             TriggerConfig)
    cmd, coinc = _free_ports(2)
    trig = _free_ports(3, socket.SOCK_DGRAM, consecutive=True)[0]
    acfg = ArrayConfig(
        antennas=(AntennaConfig(station_id=1, name="ea01",
                                source=f"file:{vdif}"),
                  AntennaConfig(station_id=2, name="ea02",
                                source=f"file:{vdif}")),
        pipeline=PipelineConfig.tiny(freq_top_mhz=320.5, bandwidth_mhz=0.5),
        search=SearchConfig(dm_min=0.0, dm_max=600.0, ndm=61,
                            gulp_samps=512, boxcar_max=16, zap_ranges=(),
                            snr_thresh=6.0, dm_grid_mode="linear"),
        trigger=TriggerConfig(snr_thresh=7.5, min_beams=2, min_dm=20.0),
        command_port=cmd, coincidencer_port=coinc, trigger_port_base=trig)
    path = str(tmp_path / "array.json")
    acfg.save(path)
    return path


def test_launch_fake_two_stations_on_the_cpu(vdif_path, tmp_path, capsys):
    """The leader in this process, two station daemons of the port as
    subprocesses on the CPU, the same file for both: both connect, the
    coincidencer raises a trigger, and each station writes its .fil
    files and a dump whose bytes are the file's seconds."""
    cfg = _array(tmp_path, vdif_path)
    out = str(tmp_path / "products")
    tcli.main(["launch", cfg, "--out-dir", out, "--fake", "--device", "cpu",
               "--fake-duration", "150", "--startup-timeout", "150"])
    got = capsys.readouterr()
    printed = got.out.strip().splitlines()
    assert "array up: 2 stations connected" in printed
    # the daemons' logs pass through the CLI, which waited for each
    # station's observation of its file to end
    ends = [json.loads(line.split(SUMMARY, 1)[1])
            for line in got.err.splitlines() if SUMMARY in line]
    assert sorted((e["station"], e["seconds"]) for e in ends) == \
        [(1, 2), (2, 2)]
    summary = json.loads(printed[-1])
    assert summary["stations"] == 2 and summary["triggers"] >= 1
    assert summary["exit_codes"] == [0, 0]
    assert len(summary["trigger_list"]) == summary["triggers"]
    assert all(t["fired_s"] > 0 for t in summary["trigger_list"])
    assert any(abs(t["dm"] - 300.0) < 75.0 for t in summary["trigger_list"])
    fils = glob.glob(os.path.join(out, "*.fil"))
    assert len(fils) == 4 and sum(f.endswith("_plain.fil") for f in fils) == 2
    from vlite_fast_tpu_torch.runtime.capture import replay_file
    secs = {int(s): b.tobytes() for s, b, _ in
            replay_file(vdif_path, sample_rate=1_000_000)}
    dumps = glob.glob(os.path.join(out, "dumps", "*.vdif"))
    assert {os.path.basename(d).split("_ea")[1][:2] for d in dumps} == \
        {"01", "02"}
    for d in dumps:
        first = int(os.path.basename(d).rsplit("_", 1)[1][:-5])
        got = open(d, "rb").read()
        n = len(got) // len(secs[first])
        assert n >= 1 and got == b"".join(secs[first + k] for k in range(n))
    assert not glob.glob("/dev/shm/vfast_torch_bb_0[12]_*")


def test_launch_plan_names_the_ports_daemon(tmp_path, capsys):
    from vlite_fast_tpu_torch.config import (AntennaConfig, ArrayConfig,
                                             PipelineConfig, SearchConfig,
                                             TriggerConfig)
    acfg = ArrayConfig(
        antennas=(AntennaConfig(1, "ea01", host="vd01", source="udp:20000"),
                  AntennaConfig(2, "ea02", source="udp:20001")),
        pipeline=PipelineConfig.tiny(), search=SearchConfig.tiny(),
        trigger=TriggerConfig(), command_port=24101, coincidencer_port=24155,
        trigger_port_base=24200)
    path = str(tmp_path / "array.json")
    acfg.save(path)
    lines = _run(tcli.main, ["launch", path, "--print-remote",
                             "--leader-addr", "10.0.0.9"],
                 capsys).splitlines()
    assert lines == [
        "ssh vd01 nohup python3 -m vlite_fast_tpu_torch.runtime.station_main"
        f" --station 1 --config {path} --source udp:20000 --out-dir "
        f"{os.path.join(__import__('tempfile').gettempdir(), 'vfast')} "
        "--leader 10.0.0.9 --command-port 24101 --coincidencer "
        "10.0.0.9:24155 --trigger-port 24201 --device cuda </dev/null "
        ">/dev/null 2>&1 &"]
    lines = _run(tcli.main, ["--device", "cpu", "launch", path,
                             "--print-remote"], capsys).splitlines()
    assert lines[0].split(" </dev/null")[0].endswith("--device cpu")


def test_entry_points_default_to_the_card(vdif_path, processed, tmp_path,
                                         capsys):
    """process, search, localize and launch's daemons ask for the card;
    without one process, search and localize raise, and launch's daemons
    exit, so the array never comes up."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults run there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["process", vdif_path, *TINY, "-o", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["search", processed["torch"]["fil"], "--ndm", "8"])
    with pytest.raises(RuntimeError, match="0/2 stations connected"):
        tcli.main(["launch", _array(tmp_path, vdif_path), "--fake",
                   "--out-dir", str(tmp_path / "out"),
                   "--startup-timeout", "20"])
    assert "array up" not in capsys.readouterr().out
    from vlite_fast_tpu_torch.utils import vdif
    dumps = tmp_path / "dumps"
    dumps.mkdir()
    rng = np.random.default_rng(3)
    for k in (1, 2):
        vdif.streams_to_frames(
            rng.integers(1, 255, (2, 50_000), dtype=np.uint8), 40, 9,
            station_id=k, sample_rate=50_000).tofile(dumps / f"a{k}.vdif")
    pos = tmp_path / "pos.json"
    pos.write_text(json.dumps({"1": [0, 0, 0], "2": [100, 0, 0]}))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["localize", str(dumps), "--positions", str(pos),
                   "--nfft", "500", "--sample-rate", "50000"])


def test_module_runs_as_a_script(tmp_path):
    import subprocess
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-m", "vlite_fast_tpu_torch.cli",
                          "send-cmd", "F"], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout) == {"cmd": "F", "od": None}


def _subcommands(main, capsys):
    """The subcommands a CLI's --help lists."""
    with pytest.raises(SystemExit):
        main(["--help"])
    usage = capsys.readouterr().out
    return set(usage.split("{", 1)[1].split("}", 1)[0].split(","))


def test_every_jax_subcommand_is_the_ports(capsys):
    want = _subcommands(jcli.main, capsys)
    got = _subcommands(tcli.main, capsys)
    assert "bench" in want
    assert want <= got, sorted(want - got)
