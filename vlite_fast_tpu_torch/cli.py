"""Command-line entry points: the reference's binaries/scripts as one CLI.

python -m vlite_fast_tpu_torch.cli [--device D] <command>
(installed: vlite-fast-torch <command>):

  synth        generate synthetic dispersed baseband VDIF (genbase role)
  process      run the DSP chain over a .vdif file -> .fil (+candidates)
               (readbase + process_baseband + heimdall roles)
  search       search an existing .fil for single pulses
  send-cmd     validate and print a control command (send_commands.py role)
  merge-cands  merge per-beam candidate files
  waterfall    render a .fil's waterfall PNG
  unwrap       check/repair a dump's continuity (db_unwrap role)
  join-dumps   join dump segments in time order
  localize     TDOA localization from a directory of dumps
               (the loc_step pipeline)
  disk-usage, print-obsdoc, find-obs, clean, scrub-ring
               the operator scripts' roles
  launch       start a whole array from one config: leader + coincidencer +
               N station daemons (the scripts/launch + start_single +
               start_coadd role)
  bench        the headline benchmark (vlite_fast_tpu_torch/bench.py):
               one JSON line of measured antennas per card

The port's counterpart of vlite_fast_tpu/cli.py.  `--device` (default
'cuda'; given before the command or after it) is the torch device of
process, search, localize, bench and launch's station daemons, where the
JAX CLI took a jax platform; without a card they raise.  `process` also prints
the replay's wall, the kernel launches and peak device memory; `launch`
prints each trigger and when it fired, and `launch --fake` waits for its
local file: stations to replay their files before it settles.  The
waterfall PNG is the port's own (analysis/waterfall: no axes or labels).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from vlite_fast_tpu_torch import constants as C


def cmd_synth(args):
    from vlite_fast_tpu_torch.models import synthesis
    cfg = synthesis.SynthConfig(
        tobs=args.seconds, dm=args.dm, pulse_period=args.period,
        skip_period=args.skip, amp=args.amp, seed=args.seed,
        add_rfi=args.rfi,
        sample_rate=args.rate, freq_bot_mhz=args.freq_bot,
        bandwidth_mhz=args.bandwidth,
        buflen=args.buflen)
    stream, info = synthesis.generate_vdif(cfg, station_id=args.station)
    stream.tofile(args.out)
    print(json.dumps({"out": args.out, "nbytes": int(stream.size),
                      "n_dm_samp": info["n_dm_samp"],
                      "period_samples": info["period"]}))


def cmd_process(args):
    import torch

    from vlite_fast_tpu_torch import launches
    from vlite_fast_tpu_torch.config import PipelineConfig, SearchConfig
    from vlite_fast_tpu_torch.runtime.capture import replay_file
    from vlite_fast_tpu_torch.runtime.control import ObservationDocument
    from vlite_fast_tpu_torch.runtime.pipeline import StationPipeline

    cfg = PipelineConfig(nbit=args.nbit, rfi_mode=args.rfi_mode,
                         inject_frb=args.inject) \
        if args.rate == 128_000_000 else \
        PipelineConfig.tiny(nbit=args.nbit, rfi_mode=args.rfi_mode,
                            sample_rate=args.rate,
                            freq_top_mhz=args.freq_top,
                            bandwidth_mhz=args.bandwidth)
    scfg = SearchConfig() if args.rate == 128_000_000 else \
        SearchConfig(dm_min=0, dm_max=args.dm_max, ndm=args.ndm,
                     gulp_samps=512, boxcar_max=16, zap_ranges=(),
                     dm_grid_mode="linear")
    st = StationPipeline(args.station, cfg, scfg, out_dir=args.out_dir,
                         keep_ring=False, device=args.device)
    replay = [0.0]          # wall seconds inside replay_file and assembly

    def seconds():
        it = replay_file(args.vdif, sample_rate=cfg.sample_rate)
        while True:
            t0 = time.perf_counter()
            item = next(it, None)
            replay[0] += time.perf_counter() - t0
            if item is None:
                return
            yield item[0], item[1]
    od = ObservationDocument(name=args.name, scan_no=2)
    st.begin_observation(od)            # prewarms: its launches not counted
    on_card = st.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(st.device)
    before = launches.counts()
    t0 = time.perf_counter()
    for sec, buf in seconds():
        st.feed_second(sec, buf)
    prod = st.end_observation()
    wall = time.perf_counter() - t0
    launched = launches.since(before)
    print(json.dumps({
        "fil": prod.fil_path, "seconds": prod.seconds,
        "rt_factor": round(prod.rt_factor, 3),
        "candidates": [c.to_line() for c in prod.candidates],
        "wall_s": wall, "replay_s": replay[0],
        "launches": {k: v for k, v in launched.items() if v},
        "peak_device_gib": (torch.cuda.max_memory_allocated(st.device)
                            / 2 ** 30 if on_card else None)}))
    st.close()


def cmd_search(args):
    from vlite_fast_tpu_torch.config import SearchConfig
    from vlite_fast_tpu_torch.models.search import SinglePulseSearch
    from vlite_fast_tpu_torch.utils import sigproc

    from vlite_fast_tpu_torch.ops import quantize as q_ops

    hdr, data = sigproc.read_filterbank(args.fil)
    # recenter quantized levels like the in-pipeline search (the SAME
    # constants as ops/quantize.dequantize -- no drifting copies)
    if hdr.nbits == 2:
        cent = np.array(q_ops._LEVEL2_CENTROIDS, np.float32)
        data = cent[data.astype(np.int32)]
    elif hdr.nbits == 4:
        data = (data - C.QUANT4_OFFSET) * np.float32(C.QUANT4_SCALE)
    else:
        data = (data - C.QUANT8_OFFSET) * np.float32(C.QUANT8_SCALE)
    freqs = hdr.fch1 + np.arange(hdr.nchans) * hdr.foff
    # an explicit --ndm asks for a FIXED grid; otherwise the production
    # tolerance-driven grid runs (its size is set by dm_tol, not --ndm)
    ndm = args.ndm if args.ndm is not None else 1024
    mode = "linear" if args.ndm is not None else "tol"
    scfg = SearchConfig(dm_min=args.dm_min, dm_max=args.dm_max,
                        ndm=ndm, gulp_samps=args.gulp,
                        boxcar_max=args.boxcar, zap_ranges=(),
                        snr_thresh=args.snr, dm_grid_mode=mode)
    eng = SinglePulseSearch(scfg, hdr.tsamp, freqs,
                            nsub=min(128, hdr.nchans),
                            nbatch=min(ndm, 128), device=args.device)
    cands = eng.search_stream(data.astype(np.float32))
    for c in cands:
        print(c.to_line())
    print(f"# {len(cands)} candidates", file=sys.stderr)


def cmd_waterfall(args):
    from vlite_fast_tpu_torch.analysis.waterfall import (render_png,
                                                         waterfall_from_fil)
    wf, meta = waterfall_from_fil(args.fil)
    # splitext, never str.replace: a name without ".fil" must not make
    # out == the input (render_png would overwrite the data file)
    out = args.out or os.path.splitext(args.fil)[0] + ".png"
    render_png(wf, meta, out)
    print(out)


def cmd_unwrap(args):
    from vlite_fast_tpu_torch.analysis.unwrap import unwrap_file
    rep = unwrap_file(args.vdif)
    print(json.dumps({"nframes": rep.nframes, "clean": rep.clean,
                      "corrupted": rep.corrupted,
                      "wrap_frame": rep.wrap_frame,
                      "discontinuities": list(rep.discontinuities)}))
    if rep.corrupted:
        sys.exit(1)


def cmd_join_dumps(args):
    """Join per-event dump segments into one time-ordered stream (the
    scripts/join_dumps.py role; ref scripts/join_dumps.py:1-40)."""
    from vlite_fast_tpu_torch.analysis.unwrap import join_dumps
    rep = join_dumps(args.vdif, args.out, frames_per_sec=args.frames_per_sec)
    print(json.dumps({"out": args.out, "nframes": rep.nframes,
                      "clean": rep.clean, "corrupted": rep.corrupted,
                      "discontinuities": list(rep.discontinuities)}))
    if rep.corrupted:
        sys.exit(1)


def cmd_localize(args):
    """Offline localization from a directory of voltage dumps: dataset ->
    per-baseline phase-slope delays (correlations on --device) -> chi^2
    grid fit (the loc_step0-3 pipeline, ref analysis/loc_step*.py).

    Two frames:
    - --antprop ANTPROP.XML: the production path (loc_step3 end product).
      Antenna ITRS positions come from the VLA antprop document, optional
      per-antenna instrumental delays from --clock-delays
      (vliteantennas.in format), and the fit is an RA/Dec sky grid + zoom
      at the event's Earth-rotation angle -> prints ra/dec degrees.
    - --positions POS.JSON: abstract ENU frame {station: [x,y,z] m},
      plane-wave (az, el) fit (lab/synthetic geometries).
    """
    from vlite_fast_tpu_torch.analysis import baseband as bb
    from vlite_fast_tpu_torch.analysis import localization as loc
    from vlite_fast_tpu_torch.analysis.dataset import load_dataset

    ds = load_dataset(args.dumps, sample_rate=args.sample_rate)
    dumps = ds.aligned()
    sids = ds.station_ids
    ut1_utc = 0.0
    if args.antprop:
        from vlite_fast_tpu_torch.runtime.vla_xml import (
            parse_antprop_document)
        with open(args.antprop) as fh:
            doc = parse_antprop_document(fh.read())
        pos_map = loc.antprop_positions_itrs(doc)
        missing = [s for s in sids if s not in pos_map]
        if missing:
            raise SystemExit(f"antprop document has no positions for "
                             f"antennas {missing}")
        positions = np.array([pos_map[s] for s in sids])
        if doc.eops:
            ut1_utc = doc.eops[len(doc.eops) // 2].ut1_utc
    elif args.positions:
        with open(args.positions) as fh:
            pos_map = json.load(fh)
        positions = np.array([pos_map[str(s)] for s in sids], float)
    else:
        raise SystemExit("--antprop (sky frame) or --positions (ENU "
                         "frame) required")
    clock = None
    if args.clock_delays:
        table = loc.parse_correlator_delays(args.clock_delays)
        clock = np.array([table.get(s, 0.0) for s in sids])
    pairs = [(i, j) for i in range(len(sids))
             for j in range(i + 1, len(sids))]
    delays = []
    for i, j in pairs:
        d, coh, snr = bb.baseline_delay_precise(dumps[i], dumps[j],
                                                nfft=args.nfft,
                                                device=args.device)
        delays.append(d)
        print(f"baseline {sids[i]}-{sids[j]}: delay {d*1e9:.1f} ns "
              f"coherence {coh:.3f} lag-S/N {snr:.0f}")
    if args.antprop:
        fit = loc.fit_sky(positions, pairs, np.array(delays),
                          t0=dumps[0].start_time,
                          sigma=args.sigma_ns * 1e-9,
                          clock_offsets=clock, ut1_utc=ut1_utc)
        print(json.dumps({"ra_deg": round(fit.ra_deg, 4),
                          "dec_deg": round(fit.dec_deg, 4),
                          "err_arcmin": round(fit.err_arcmin, 2),
                          "chi2": round(fit.chi2, 2),
                          "stations": sids,
                          "n_baselines": len(pairs)}))
    else:
        fit = loc.fit_tdoa(positions, pairs, np.array(delays),
                           sigma=args.sigma_ns * 1e-9,
                           clock_offsets=clock)
        print(json.dumps({"az_rad": round(fit.az, 5),
                          "el_rad": round(fit.el, 5),
                          "chi2": round(fit.chi2, 2),
                          "stations": sids,
                          "n_baselines": len(pairs)}))


def cmd_send_cmd(args):
    from vlite_fast_tpu_torch.runtime.control import (Command,
                                                ObservationDocument)
    # validates + prints the message (publishing rides the leader's
    # manual telnet port; see `launch --manual-port`)
    od = None
    if args.name:
        od = ObservationDocument(name=args.name, scan_no=2)
    print(json.dumps({"cmd": Command(args.cmd).value,
                      "od": od.to_json() if od else None}))


def cmd_merge_cands(args):
    """Merge per-beam candidate files into one sorted list
    (the scripts/merge_candidates.py role)."""
    from vlite_fast_tpu_torch.ops.dedisperse import Candidate
    cands = []
    for path in args.files:
        with open(path) as fp:
            for line in fp:
                line = line.strip()
                if line and not line.startswith("#"):
                    cands.append((path, Candidate.from_line(line)))
    cands.sort(key=lambda pc: -pc[1].snr)
    for path, c in cands[:args.top or len(cands)]:
        print(f"{c.to_line()}\t{path}")


def cmd_disk_usage(args):
    """Report product-directory usage (the scripts/disk_utilization role)."""
    out = {}
    for d in args.dirs:
        total = 0
        nfiles = 0
        for root, _, files in os.walk(d):
            for f in files:
                try:
                    total += os.path.getsize(os.path.join(root, f))
                    nfiles += 1
                except OSError:
                    pass
        out[d] = {"bytes": total, "files": nfiles,
                  "gb": round(total / 1e9, 3)}
    print(json.dumps(out))


def cmd_print_obsdoc(args):
    """Parse + pretty-print VLA XML documents
    (the print_obsdocs/print_antprop role)."""
    from dataclasses import asdict
    from vlite_fast_tpu_torch.runtime import vla_xml
    with open(args.xml) as fp:
        doc = vla_xml.parse_scaninfo(fp.read())
    if hasattr(doc, "to_json"):
        print(doc.to_json())
    else:
        print(json.dumps(asdict(doc), default=str, indent=2))


def cmd_find_obs(args):
    """Search archived obsinfo XML for scans near a sky position
    (the scripts/search_logs_pos.py role, against the messenger's XML
    archive instead of scraping writer logs)."""
    import glob
    from vlite_fast_tpu_torch.runtime import vla_xml
    from vlite_fast_tpu_torch.runtime.control import ObservationDocument, \
        angular_distance
    hits = []
    for path in sorted(glob.glob(os.path.join(args.archive, "*obsinfo*"))):
        try:
            with open(path) as fp:
                od = vla_xml.parse_obs_document(fp.read())
        except Exception:
            continue
        dist = angular_distance(args.ra, args.dec, od.ra, od.dec)
        if dist <= args.radius:
            hits.append({"file": os.path.basename(path), "name": od.name,
                         "ra": od.ra, "dec": od.dec, "scan": od.scan_no,
                         "dist_rad": round(dist, 6)})
    print(json.dumps(hits, indent=2))


def cmd_clean(args):
    """Age-based product cleanup (the scripts/clear_files role).
    Dry-run by default; --delete to actually remove."""
    cutoff = time.time() - args.days * 86400
    removed, kept_bytes = [], 0
    for d in args.dirs:
        for root, _, files in os.walk(d):
            for f in files:
                p = os.path.join(root, f)
                try:
                    st = os.stat(p)
                except OSError:
                    continue
                if st.st_mtime < cutoff:
                    removed.append(p)
                    if args.delete:
                        os.unlink(p)
                else:
                    kept_bytes += st.st_size
    print(json.dumps({"candidates" if not args.delete else "deleted":
                      len(removed), "kept_bytes": kept_bytes,
                      "files": removed[:50]}))


def cmd_scrub_ring(args):
    """Rebuild a wedged shm ring (the scripts/scrub_dada role): recreate
    the segment fresh; exit code distinguishes created vs replaced."""
    from vlite_fast_tpu_torch.runtime.ring import RingBuffer
    existed = os.path.exists(f"/dev/shm{args.name}")
    rb = RingBuffer(args.name, bufsz=args.bufsz, nbufs=args.nbufs,
                    create=True)
    rb.close(unlink=False)
    print(json.dumps({"ring": args.name, "bufsz": args.bufsz,
                      "nbufs": args.nbufs, "replaced": existed}))


def cmd_launch(args):
    """One-command array bring-up (ref scripts/launch:5-12 +
    scripts/start_single + config/hosts): the CLI process becomes the
    leader (command bus + coincidencer + trigger fanout) and each antenna
    row of the config gets a station-daemon subprocess.

    --fake runs one fake observation (FAKE_START, the writer.c:195-214
    no-VLA test path) and shuts the array down 3 s after the first
    trigger, once every local file: station has replayed its file (the
    CLI passes on each local daemon's log and reads the line that ends
    its observation), or after --fake-duration; without it the array
    stays up until Ctrl-C or a QUIT on the manual port.  The summary
    lists every trigger, each with the seconds after the start of the
    observation (FAKE_START) at which the coincidencer raised it.
    """
    import subprocess
    import threading

    from vlite_fast_tpu_torch.config import ArrayConfig
    from vlite_fast_tpu_torch.runtime.leader_main import Leader
    from vlite_fast_tpu_torch.runtime.station_main import SUMMARY

    acfg = ArrayConfig.load(args.config)
    out = args.out_dir

    def station_cmd(a, python, leader_addr):
        cmd = [python, "-m", "vlite_fast_tpu_torch.runtime.station_main",
               "--station", str(a.station_id),
               "--config", args.config,
               "--source", a.source,
               "--out-dir", out,
               "--leader", leader_addr,
               "--command-port", str(acfg.command_port),
               "--coincidencer",
               f"{leader_addr}:{acfg.coincidencer_port}",
               "--trigger-port",
               str(acfg.trigger_port_base + a.station_id),
               "--device", args.device]
        return cmd

    local = ("", "localhost", "127.0.0.1")
    remote_ants = [a for a in acfg.antennas if a.host not in local]
    if args.print_remote:
        # the scripts/launch:5-12 ssh fan-out, as an explicit plan (one
        # line per remote station; a deployment pipes this to sh)
        for a in remote_ants:
            print(" ".join(["ssh", a.host, "nohup"]
                           + station_cmd(a, "python3", args.leader_addr)
                           + ["</dev/null", ">/dev/null", "2>&1", "&"]))
        return
    leader = Leader(acfg, out, manual_port=args.manual_port,
                    obsinfo_port=args.obsinfo_port,
                    waterfall=args.waterfall)
    fired = []              # (trigger, time.time() when raised)
    fan_out = leader.coincidencer.on_trigger
    leader.coincidencer.on_trigger = \
        lambda t: (fired.append((t, time.time())), fan_out(t))
    ended = [0] * len(acfg.antennas)    # observations each has ended

    def relay(i, pipe):
        for line in pipe:
            sys.stderr.write(line)
            if SUMMARY in line:
                ended[i] += 1
    t_start = time.time()
    procs, relays = [], []
    try:
        for i, a in enumerate(acfg.antennas):
            if a.host not in local:
                procs.append(subprocess.Popen(
                    ["ssh", a.host, "nohup"]
                    + station_cmd(a, "python3", args.leader_addr)))
            else:
                procs.append(subprocess.Popen(
                    station_cmd(a, sys.executable, "127.0.0.1"),
                    stderr=subprocess.PIPE, text=True))
                relays.append(threading.Thread(
                    target=relay, args=(i, procs[-1].stderr), daemon=True))
                relays[-1].start()
        if not leader.wait_for_stations(len(procs),
                                        timeout=args.startup_timeout):
            raise RuntimeError(
                f"only {leader.n_stations_connected}/{len(procs)} "
                "stations connected")
        print(f"array up: {len(procs)} stations connected")
        if args.fake:
            files = [i for i, a in enumerate(acfg.antennas)
                     if a.host in local and a.source.startswith("file:")]
            t_start = time.time()
            leader.fake_observation()
            deadline = time.time() + args.fake_duration
            while time.time() < deadline and \
                    all(pr.poll() is None for pr in procs):
                if leader.coincidencer.triggers and \
                        all(ended[i] for i in files):
                    time.sleep(3.0)   # let fan-out + dumps settle
                    break
                time.sleep(0.5)
            leader.stop_observation()
            time.sleep(2.0)
        else:
            while leader._running and all(pr.poll() is None
                                          for pr in procs):
                time.sleep(0.5)
    except KeyboardInterrupt:
        pass
    finally:
        leader.shutdown()
        for pr in procs:
            try:
                pr.wait(timeout=15)
            except subprocess.TimeoutExpired:
                pr.terminate()
                try:
                    pr.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    pr.kill()
        for th in relays:
            th.join(timeout=5)
    ntrig = len(leader.coincidencer.triggers)
    print(json.dumps({
        "stations": len(procs), "triggers": ntrig,
        "trigger_list": [dict(sn=t.sn, dm=t.dm, width=t.width, t0=t.t0,
                              t1=t.t1, peak_time=t.peak_time, meta=t.meta,
                              fired_s=at - t_start) for t, at in fired],
        "exit_codes": [pr.returncode for pr in procs]}))


def cmd_bench(args):
    from vlite_fast_tpu_torch import bench
    bench.main(["--device", args.device])


def main(argv=None):
    p = argparse.ArgumentParser(prog="vlite_fast_tpu_torch")
    device_help = ("torch device of process, search, localize, bench and "
                   "launch's stations (default 'cuda'; 'cpu' for tiny test "
                   "geometries)")
    p.add_argument("--device", default="cuda", help=device_help)
    # the same option after the command; unset there, the one above holds
    on_device = argparse.ArgumentParser(add_help=False)
    on_device.add_argument("--device", default=argparse.SUPPRESS,
                           help=device_help)
    out_dir = os.path.join(tempfile.gettempdir(), "vfast")
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser("synth", help="synthetic baseband (genbase role)")
    s.add_argument("-t", "--seconds", type=float, default=5.0)
    s.add_argument("-d", "--dm", type=float, default=30.0)
    s.add_argument("-p", "--period", type=float, default=0.5)
    s.add_argument("-k", "--skip", type=int, default=1)
    s.add_argument("-a", "--amp", type=float, default=0.05)
    s.add_argument("-r", "--seed", type=int, default=42)
    s.add_argument("-f", "--rfi", action="store_true")
    s.add_argument("--rate", type=int, default=128_000_000)
    s.add_argument("--freq-bot", type=float, default=320.0)
    s.add_argument("--bandwidth", type=float, default=64.0)
    s.add_argument("--buflen", type=int, default=0)
    s.add_argument("--station", type=int, default=1)
    s.add_argument("-o", "--out", required=True)
    s.set_defaults(fn=cmd_synth)

    s = sub.add_parser("process", help="DSP chain over a .vdif file",
                       parents=[on_device])
    s.add_argument("vdif")
    s.add_argument("--rate", type=int, default=128_000_000)
    s.add_argument("--freq-top", type=float, default=384.0)
    s.add_argument("--bandwidth", type=float, default=64.0)
    s.add_argument("-b", "--nbit", type=int, default=2)
    s.add_argument("-r", "--rfi-mode", type=int, default=2)
    s.add_argument("-i", "--inject", action="store_true")
    s.add_argument("--dm-max", type=float, default=600.0)
    s.add_argument("--ndm", type=int, default=64)
    s.add_argument("--name", default="replay")
    s.add_argument("--station", type=int, default=1)
    s.add_argument("-o", "--out-dir", default=out_dir)
    s.set_defaults(fn=cmd_process)

    s = sub.add_parser("search", help="single-pulse search of a .fil",
                       parents=[on_device])
    s.add_argument("fil")
    s.add_argument("--dm-min", type=float, default=2.0)
    s.add_argument("--dm-max", type=float, default=1000.0)
    s.add_argument("--ndm", type=int, default=None,
                   help="fixed linear DM-trial count; omit for the "
                        "production tolerance-driven grid")
    s.add_argument("--gulp", type=int, default=30720)
    s.add_argument("--boxcar", type=int, default=64)
    s.add_argument("--snr", type=float, default=6.0)
    s.set_defaults(fn=cmd_search)

    s = sub.add_parser("waterfall", help="render .fil waterfall PNG")
    s.add_argument("fil")
    s.add_argument("-o", "--out")
    s.set_defaults(fn=cmd_waterfall)

    s = sub.add_parser("unwrap", help="check/repair dump continuity")
    s.add_argument("vdif")
    s.set_defaults(fn=cmd_unwrap)

    s = sub.add_parser("join-dumps", help="join dump segments in time order")
    s.add_argument("vdif", nargs="+")
    s.add_argument("-o", "--out", required=True)
    s.add_argument("--frames-per-sec", type=int,
                   default=C.FRAMES_PER_SEC)
    s.set_defaults(fn=cmd_join_dumps)

    s = sub.add_parser("send-cmd", help="publish a control command")
    s.add_argument("cmd", choices=[c for c in "SCQEFG"])
    s.add_argument("--name", default="")
    s.set_defaults(fn=cmd_send_cmd)

    s = sub.add_parser("merge-cands", help="merge per-beam candidate files")
    s.add_argument("files", nargs="+")
    s.add_argument("--top", type=int, default=0)
    s.set_defaults(fn=cmd_merge_cands)

    s = sub.add_parser("disk-usage", help="product directory usage")
    s.add_argument("dirs", nargs="+")
    s.set_defaults(fn=cmd_disk_usage)

    s = sub.add_parser("print-obsdoc", help="parse + print a VLA XML doc")
    s.add_argument("xml")
    s.set_defaults(fn=cmd_print_obsdoc)

    s = sub.add_parser("find-obs", help="search obsinfo archive by position")
    s.add_argument("archive")
    s.add_argument("--ra", type=float, required=True)
    s.add_argument("--dec", type=float, required=True)
    s.add_argument("--radius", type=float, default=0.01)
    s.set_defaults(fn=cmd_find_obs)

    s = sub.add_parser("clean", help="age-based product cleanup")
    s.add_argument("dirs", nargs="+")
    s.add_argument("--days", type=float, default=30.0)
    s.add_argument("--delete", action="store_true")
    s.set_defaults(fn=cmd_clean)

    s = sub.add_parser("scrub-ring", help="rebuild a wedged shm ring")
    s.add_argument("name")
    s.add_argument("--bufsz", type=int, required=True)
    s.add_argument("--nbufs", type=int, default=8)
    s.set_defaults(fn=cmd_scrub_ring)

    s = sub.add_parser("localize", help="TDOA localization from dumps "
                                        "(loc_step pipeline)",
                       parents=[on_device])
    s.add_argument("dumps", help="dump directory / glob / file list")
    s.add_argument("--antprop", help="VLA antprop XML -> ITRS positions; "
                                     "fit RA/Dec on the sky (loc_step3)")
    s.add_argument("--clock-delays",
                   help="vliteantennas.in correlator/pipeline delay table")
    s.add_argument("--positions", help="JSON {station_id: [x,y,z] m} "
                                       "(abstract ENU az/el fit)")
    s.add_argument("--nfft", type=int, default=2500)
    s.add_argument("--sigma-ns", type=float, default=20.0)
    s.add_argument("--sample-rate", type=int, default=128_000_000)
    s.set_defaults(fn=cmd_localize)

    s = sub.add_parser("launch", help="start leader + N station daemons "
                                      "from one array config",
                       parents=[on_device])
    s.add_argument("config", help="ArrayConfig JSON (config/hosts role)")
    s.add_argument("--out-dir", default=out_dir)
    s.add_argument("--fake", action="store_true",
                   help="run one FAKE_START observation, then shut down")
    s.add_argument("--fake-duration", type=float, default=10.0)
    s.add_argument("--startup-timeout", type=float, default=90.0)
    s.add_argument("--manual-port", type=int, default=None)
    s.add_argument("--obsinfo-port", type=int, default=None)
    s.add_argument("--waterfall", action="store_true",
                   help="render a waterfall PNG of each .fil in the "
                        "output directory (the leader's watcher)")
    s.add_argument("--leader-addr", default="127.0.0.1",
                   help="address remote stations dial back to "
                        "(this host, as seen from the antenna hosts)")
    s.add_argument("--print-remote", action="store_true",
                   help="print the ssh fan-out commands for stations "
                        "with a remote host: set, then exit "
                        "(scripts/launch role as an explicit plan)")
    s.set_defaults(fn=cmd_launch)

    s = sub.add_parser("bench", help="headline benchmark",
                       parents=[on_device])
    s.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
