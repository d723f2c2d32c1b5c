"""The array host's cell on the CPU: the declaration, the open loop's
pacing, its rule for a failed gulp and its late seconds on a fake clock,
and drivers/array_host.py at the tiny geometry (tests/_tiny_host): the
window ends on time, no data-second is fed after it, and the end of
run_streaming that follows it is bounded."""

import time

import pytest

from portbench import check_host, run, spec
from portbench.drivers import array_host
from portbench.tests import _tiny_host as th

SEED = 2 ** 31 + 29


class FakeClock:
    def __init__(self):
        self.t = 100.0
        self.slept = []

    def clock(self):
        return self.t

    def sleep(self, dt):
        self.slept.append(dt)
        self.t += dt


def test_the_cell_is_declared():
    cell = spec.load_cell("host8.realtime")
    assert cell.config["driver"] == "array_host"
    assert cell.traffic["generator"] == "array_baseband"
    assert {m["name"] for m in cell.end_to_end} == {"gulp_latency_p95_ms",
                                                     "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "rt_second_ms", "rt_lag_p95_s", "rt_ring_ms", "rt_coadd_ms",
        "late_seconds"}
    assert set(cell.limits) == set(check_host.NUMBERS)
    arr = cell.config["array"]
    assert (arr["nant"], arr["ring_seconds"], arr["coincide_every_s"],
            arr["write_fil"]) == (8, 32, 8, False)
    station = spec.load_cell("station_fft.noise").config
    assert cell.config["dsp"] == station["dsp"]
    assert cell.config["search"] == station["search"]


def test_the_open_loop_paces_the_seconds():
    """Data-second k0 + j is due at t0 + j: a second fed early waits for
    its due time; one the host is late for goes at once, its lag kept;
    nothing is due at or after the window's end."""
    fc = FakeClock()
    loop = array_host.OpenLoop(5.0, clock=fc.clock, sleep=fc.sleep)
    loop.start(20)
    assert loop.wait(20) and fc.slept == []
    fc.t += 0.25
    assert loop.wait(21)                  # early: sleeps 0.75 s
    assert fc.slept == [pytest.approx(0.75)] and fc.t == pytest.approx(101)
    fc.t += 2.5                           # the host takes 2.5 s
    assert loop.wait(22) and fc.slept == [pytest.approx(0.75)]
    fc.t += 0.1
    assert loop.wait(23)
    assert loop.lag == pytest.approx([0.0, 0.0, 1.5, 0.6])
    assert loop.late == 1
    assert loop.wait(24)                  # due at t0 + 4 < t0 + 5
    assert not loop.wait(25)              # due at the window's end
    fc.t = 99.0 + 200
    assert not loop.wait(24)              # the window is over


def test_the_failed_rule():
    """A gulp is attempted when the data-second after its last is due in
    the window; failed when it was not searched by the window's end, or
    when its candidates came after a ring of 4 s had lost its first
    second."""
    fc = FakeClock()
    loop = array_host.OpenLoop(10.0, clock=fc.clock, sleep=fc.sleep)
    loop.start(4)                 # t0 = 100, second k due at 96 + k
    span = lambda g: (2 * g, 2 * g + 2)     # gulps of 2 s, 1 s overlap
    searched = {(0, 1): 101.5,    # its first second 2 overwritten at 102
                (0, 2): 106.5,    # after 104, when second 4 is lost
                (0, 3): 110.5,    # after the window's end (110)
                (1, 1): 105.0,    # after 102
                (1, 2): 104.0}    # just in time
    attempted, failed, lat = loop.tally(searched, 2, span, 4)
    # gulps 1..5 of each stream: gulp 0's next second (3) is due before
    # the window, gulp 6's (15) at its end
    assert attempted == 10
    assert failed == 4 + 4
    # from the due time of each searched gulp's last second, 96 + 2g + 2
    assert lat == pytest.approx([1.5, 4.5, 5.0, 2.0])


def test_the_driver_ends_on_time(monkeypatch):
    cell = th.tiny_host_cell()
    runs = []
    drive = array_host.run

    def three_s(*a, **kw):
        out = drive(*a, window_min_s=3.0, window_k0=3, **kw)
        runs.append(out[0])
        return out

    monkeypatch.setattr(array_host, "run", three_s)
    t = time.time()
    out = run.execute(cell, SEED, 1.0, False, "cpu", t)
    r, = runs
    # the window ends once the last second due in it (at 2 s) has been
    # fed, or at 3 s when the host lags: seen when the second in progress
    # returns
    assert r.window_data_s == len(r.lag_s) == len(r.second_s) >= 1
    assert 2.0 <= r.window_s < 3.0 + max(r.second_s)
    assert out["attempted"] == r.attempted > 0 and r.setup_s > 0
    # after the window: the second in progress, each station's last drain
    # and flush gulp, the coadd's flush, the last coincidence, the check
    assert time.time() - t < r.setup_s + r.window_s + 120
    assert set(out["compared"]) == set(check_host.NUMBERS)
    assert "setup_s" in out["metrics"]
    # what the station cells' readers of the gulp search and its
    # clustering read is there (every beam's and the coadd's gulps)
    assert r.window_gulps > 0 and r.search_parts["cluster"] > 0
    for name in ("cluster_ms_per_gulp", "gulp_wait_p95_ms", "gulp_ahead_s",
                 "cluster_rows_per_gulp"):
        assert spec.reader(name)(r) is not None, name


def test_correct_needs_the_windows_burst_and_trigger():
    """A run is correct only with the burst's gulp compared, and with a
    trigger at the injected DM raised (its dumps queued) in the window:
    one raised after data-second k0 - 1 or past the window's last does
    not count."""
    limits = spec.load_cell("host8.realtime").limits
    vals = dict.fromkeys(check_host.NUMBERS, 0.0)
    ok = check_host.Result(values=vals, limits=limits, gulps=2, burst=True)
    assert ok.correct
    assert not check_host.Result(values=vals, limits=limits, gulps=2,
                                 burst=False).correct
    trig = [type("T", (), {"dm": d})() for d in (80.0, 79.0, 81.0)]
    assert check_host.in_window(trig, [60, 61, 97], 60, 36) == [trig[1]]
    assert check_host.trigger_gap(
        check_host.in_window(trig, [60, 97, 98], 60, 36), 80.0) == \
        float("inf")
