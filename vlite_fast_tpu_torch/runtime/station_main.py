"""Per-host station daemon: the production process for one antenna stream.

Replaces the reference's per-node process set (writer + process_baseband +
heimdall_stream + dumper, launched by scripts/start_* via config/hosts):
one long-running program that

  * polls the leader's CommandBus for START/STOP/QUIT + observation docs,
  * captures VDIF (UDP) or replays a file into the baseband history ring,
  * runs the DSP chain + gulp search per completed second,
  * streams candidate batches to the central coincidencer,
  * listens for Trigger structs and serves voltage dumps.

Run: python -m vlite_fast_tpu_torch.runtime.station_main --station 5 \
       --leader localhost --source udp:20000 [--device cpu]

The port's copy of vlite_fast_tpu/runtime/station_main.py.  What differs:
the pipeline runs on `--device` (default 'cuda'; without a card the
daemon raises at start), where the JAX daemon took a jax platform; each
observation ends with one log line, "observation summary {json}": its
seconds, wall, real-time factor, candidate count, the kernel launches it
made, peak device memory, the median and the largest of the host's ms a
second by part, the gulps' in-program latency (p50, p95, and the p95 of
the gulps with and without an injected second), its mean by part, the
mean stall of the card after a gulp's fetch and the mean rows clustered
(utils/spans.gulp_summary) and, from a live source, the capture's
counters; and a
live observation ends after ~20 s in which no datagram came, where the
JAX daemon counted every poll that completed no second, so that at the
reference rate (200 polls of 256 frames a second) it ended before its
first second was whole.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import threading
import time
from typing import Iterator, Optional

import torch

from vlite_fast_tpu_torch import launches
from vlite_fast_tpu_torch.config import PipelineConfig, SearchConfig
from vlite_fast_tpu_torch.runtime import capture as cap
from vlite_fast_tpu_torch.runtime.candidate_server import CandidateClient
from vlite_fast_tpu_torch.runtime.control import Command, CommandClient, \
    ObservationDocument
from vlite_fast_tpu_torch.runtime.dumper import TriggeredDumper
from vlite_fast_tpu_torch.runtime.pipeline import StationPipeline
from vlite_fast_tpu_torch.runtime.trigger import TriggerReceiver
from vlite_fast_tpu_torch.utils import spans
from vlite_fast_tpu_torch.utils.log import make_logger

# the log line that ends each observation (`launch --fake` waits for it)
SUMMARY = "observation summary"


class StationDaemon:
    def __init__(self, station_id: int, cfg: PipelineConfig,
                 scfg: SearchConfig, out_dir: str,
                 leader_host: str = "127.0.0.1",
                 command_port: Optional[int] = 20001,
                 coincidencer: Optional[tuple] = ("127.0.0.1", 27555),
                 trigger_port: Optional[int] = 20003,
                 device="cuda"):
        self.station_id = station_id
        self.log = make_logger(f"station{station_id:02d}")
        self.pipeline = StationPipeline(station_id, cfg, scfg,
                                        out_dir=out_dir, device=device)
        self.summary: Optional[dict] = None    # the last observation's
        self._capture = None                   # the live source, if any
        self._abort: Optional[str] = None
        self.cmd: Optional[CommandClient] = None
        if command_port is not None:
            self.cmd = CommandClient(host=leader_host, port=command_port)
        self.cands = (CandidateClient(*coincidencer)
                      if coincidencer else None)
        self.dumper = TriggeredDumper(self.pipeline.ring,
                                      out_dir + "/dumps",
                                      station_id=station_id)
        self.trig_rx = (TriggerReceiver(port=trigger_port)
                        if trigger_port is not None else None)
        self._stop = threading.Event()
        self._shutdown_done = False
        self._pending_cmds: list = []
        self._trigger_thread = None
        if self.trig_rx is not None:
            self._trigger_thread = threading.Thread(
                target=self._trigger_loop, daemon=True)
            self._trigger_thread.start()

    def _poll_cmds(self) -> list:
        """Leader commands: anything deferred from a previous batch first
        (a STOP and the next scan's START often arrive in ONE poll — the
        repointing cascade; dropping the batch tail would stall the
        daemon forever)."""
        cmds = self._pending_cmds
        self._pending_cmds = []
        if self.cmd is not None:
            cmds = cmds + self.cmd.poll()
        return cmds

    def _manual_event_dump(self):
        """Dump every second currently resident in the history ring."""
        from vlite_fast_tpu_torch.runtime.trigger import Trigger
        lo, hi = self.pipeline.ring.resident()
        if hi <= lo:
            return None
        t0 = self.pipeline.ring.slot_timestamp(lo)
        t1 = self.pipeline.ring.slot_timestamp(hi - 1) + 1.0
        rec = self.dumper.dump(Trigger(t0=t0, t1=t1, sn=0.0, dm=0.0,
                                       width=0.0, peak_time=t0,
                                       meta="manual EVENT"))
        if rec:
            self.log.info("EVENT dump %s (%d bytes)", rec.path, rec.nbytes)
        return rec

    def _trigger_loop(self):
        while not self._stop.is_set():
            for t in self.trig_rx.poll():
                rec = self.dumper.dump(t)
                if rec:
                    self.log.info("dumped %s (%d bytes)", rec.path,
                                  rec.nbytes)

    def _ship_candidates(self, cands, od: ObservationDocument) -> None:
        """Send a candidate batch to the coincidencer NOW (gulp-bound
        latency, the heimdall->trigger.py streaming path — waiting for
        observation end would make trigger latency observation-bound and
        the event's voltages would long be overwritten).

        Batches are keyed by a COMMON utc (the observation document's
        start when it carries one) and candidate sample indices are
        rebased to it: stations whose capture locked onto different
        seconds would otherwise land in different coincidence groups and
        never trigger."""
        if self.cands is None or not cands:
            return
        t0 = self.pipeline._t0_unix or 0.0
        base = od.start_time if od.start_time else t0
        dsec = t0 - base
        if abs(dsec) > 120.0:
            # the OD's epoch doesn't describe this data (fake/replay
            # observations of recorded files): fall back to the data's
            # own start.  Real capture-lock skew between stations is a
            # second or two, far inside this guard.
            base, dsec = t0, 0.0
        if abs(dsec) > 1e-9:
            shift = int(round(dsec / self.pipeline.cfg.tsamp))
            cands = [c._replace(peak_idx=c.peak_idx + shift,
                                i0=c.i0 + shift, i1=c.i1 + shift,
                                peak_time=c.peak_time + dsec)
                     for c in cands]
        try:
            self.cands.send(f"{base:.0f}", self.station_id, cands)
        except OSError as e:
            self.log.warning("coincidencer unreachable: %s", e)

    def run_observation(self, seconds: Iterator, od: ObservationDocument):
        """Process one observation's seconds, shipping candidate batches
        as each gulp completes (not at observation end)."""
        pipe = self.pipeline
        pipe.begin_observation(od)
        on_card = pipe.device.type == "cuda"
        if on_card:
            torch.cuda.reset_peak_memory_stats(pipe.device)
        before = launches.counts()
        t0 = time.perf_counter()
        shipped = 0
        for sec, buf in seconds:
            fresh = pipe.feed_second(sec, buf)
            if fresh:
                self._ship_candidates(fresh, od)
                shipped += len(fresh)
        prod = pipe.end_observation()
        self._ship_candidates(prod.candidates[shipped:], od)
        wall = time.perf_counter() - t0
        self.summary = self._summarize(od, prod, wall,
                                       launches.since(before), on_card)
        self.log.info("%s %s", SUMMARY, json.dumps(self.summary))
        return prod

    def _summarize(self, od, prod, wall, launched, on_card) -> dict:
        """The observation's readings, as the summary line prints them."""
        pipe = self.pipeline
        out = {"station": self.station_id, "name": od.name,
               "seconds": prod.seconds, "wall_s": wall,
               "wall_per_data_s": wall / max(prod.seconds, 1),
               "rt_factor": prod.rt_factor,
               "candidates": len(prod.candidates),
               "fil": prod.fil_path, "dropped": prod.dropped,
               "launches": {k: v for k, v in launched.items() if v},
               "peak_device_gib": (torch.cuda.max_memory_allocated(
                   pipe.device) / 2 ** 30 if on_card else None),
               "host_ms_median": {k: 1e3 * statistics.median(v)
                                  for k, v in pipe.host_seconds.items() if v},
               "host_ms_max": {k: 1e3 * max(v)
                               for k, v in pipe.host_seconds.items() if v},
               "gulp": spans.gulp_summary(pipe.records.gulps)}
        if self._capture is not None:
            st = self._capture.asm.stats
            out["capture"] = {"frames": st.frames, "skipped": st.skipped,
                              "anomalous": st.anomalous,
                              "seconds": st.seconds,
                              "clock_skew_s": st.clock_skew_s,
                              "rcvbuf": self._capture.rcvbuf,
                              "abort_reason": self._abort}
        return out

    def serve(self, source: str, poll_s: float = 0.1,
              max_observations: Optional[int] = None):
        """Main loop: wait for START, run the observation from `source`
        ('udp:PORT', 'raw:IFACE:PORT' or 'file:PATH'), repeat until
        QUIT."""
        nobs = 0
        try:
            while not self._stop.is_set():
                od = None
                for cmd, cmd_od in self._poll_cmds():
                    if cmd == Command.QUIT:
                        return
                    if cmd == Command.EVENT:
                        # manual event: dump the ring's current window
                        # (CMD_EVENT role, ref def.h:7 / event_to_file)
                        self._manual_event_dump()
                    if cmd in (Command.START, Command.FAKE_START):
                        od = cmd_od or ObservationDocument(name="manual",
                                                           scan_no=2)
                if od is None:
                    time.sleep(poll_s)
                    continue
                self.log.info("observation start: %s", od.name)
                self._capture = None
                if source.startswith("file:"):
                    secs = ((s, b) for s, b, _ in cap.replay_file(
                        source[5:],
                        sample_rate=self.pipeline.cfg.sample_rate))
                else:
                    secs = self._live_seconds(source)
                self.run_observation(secs, od)
                nobs += 1
                if max_observations and nobs >= max_observations:
                    return
        finally:
            # every exit path (QUIT mid-observation included) releases
            # the shm ring and joins the trigger thread — a stale
            # /vfast_bb_NN segment wedges the next daemon on this host
            self.shutdown()

    def _live_seconds(self, source: str):
        """Live second stream from 'udp:PORT' or 'raw:IFACE:PORT' (the
        transport switch — ref src/utils.c:345-407 raw vs test UDP)."""
        udp = cap.open_capture(source,
                               sample_rate=self.pipeline.cfg.sample_rate,
                               wallclock_check=True)
        self._capture, self._abort = udp, None
        try:
            idle = 0
            st = udp.asm.stats
            while not self._stop.is_set():
                heard = st.frames + st.anomalous
                done = udp.poll()
                # fail fast: the escalating capture counters end the
                # observation (writer.c:616-727 abort semantics)
                reason = st.abort_reason()
                if reason is not None:
                    self.log.error("aborting observation: %s", reason)
                    self._abort = reason
                    return
                if not done:
                    # only a poll that heard nothing counts as silence: a
                    # second of the reference rate takes 200 polls of 256
                    # frames to assemble
                    idle = idle + 1 if st.frames + st.anomalous == heard \
                        else 0
                    if idle > 100:   # ~20 s of silence ends the obs
                        return
                    continue
                idle = 0
                for sec, buf in done:
                    yield sec, buf
                # NB no ring-full abort here: the history ring writes
                # with overwrite=True by DESIGN (it is the dump-history
                # buffer, not a consumer queue — the DSP feed is
                # synchronous and cannot fall behind it), so writer.c's
                # ring-full abort (:719-727) has no analogue; a trigger
                # whose window was already overwritten is handled by the
                # dumper returning None.
                # STOP/QUIT between seconds; commands AFTER a stop in the
                # same batch (the repointing STOP+START cascade) are
                # deferred to the serve loop, not dropped
                batch = self._poll_cmds()
                for i, (cmd, _) in enumerate(batch):
                    if cmd in (Command.STOP, Command.QUIT,
                               Command.FAKE_STOP):
                        if cmd == Command.QUIT:
                            self._stop.set()
                        self._pending_cmds = batch[i + 1:]
                        return
        finally:
            udp.close()

    def shutdown(self):
        if self._shutdown_done:
            return
        self._shutdown_done = True
        self._stop.set()
        # join the trigger thread BEFORE tearing down its ring/socket — a
        # dump in flight must finish or the viewer reads freed shm
        if self._trigger_thread is not None:
            self._trigger_thread.join(timeout=5)
        if self.trig_rx:
            self.trig_rx.close()
        if self.cmd:
            self.cmd.close()
        self.pipeline.close()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--station", type=int, required=True)
    p.add_argument("--leader", default="127.0.0.1")
    p.add_argument("--command-port", type=int, default=20001)
    p.add_argument("--coincidencer", default="127.0.0.1:27555")
    p.add_argument("--trigger-port", type=int, default=20003)
    p.add_argument("--source", default="udp:20000")
    p.add_argument("--out-dir", default=os.path.join(
        tempfile.gettempdir(), "vfast"))
    p.add_argument("--config", default=None,
                   help="array.json: geometry/search from ArrayConfig "
                        "(the config/hosts row role)")
    p.add_argument("--tiny", action="store_true",
                   help="shrunken geometry (testing)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the pipeline ('cpu' for tiny "
                        "test geometries; default: the card)")
    args = p.parse_args(argv)
    if args.config:
        from vlite_fast_tpu_torch.config import ArrayConfig
        acfg = ArrayConfig.load(args.config)
        cfg, scfg = acfg.pipeline, acfg.search
    elif args.tiny:
        cfg, scfg = PipelineConfig.tiny(), SearchConfig.tiny()
    else:
        cfg, scfg = PipelineConfig(), SearchConfig()
    host, port = args.coincidencer.split(":")
    d = StationDaemon(args.station, cfg, scfg, args.out_dir,
                      leader_host=args.leader,
                      command_port=args.command_port,
                      coincidencer=(host, int(port)),
                      trigger_port=args.trigger_port,
                      device=args.device)
    try:
        d.serve(args.source)
    except KeyboardInterrupt:
        d.shutdown()


if __name__ == "__main__":
    main()
