"""Cluster leader process: messenger + coincidencer + trigger fanout.

One process carrying the reference's central roles (launched on the head
node by scripts/launch:5-12): the Messenger (VLA XML in -> START/STOP over
the command bus, ref src/messenger.c), the candidate coincidencer
(ref src/trigger.py:87-176), UDP trigger fanout to every station's dumper
(ref trigger.py:75-84 multicast -> per-station unicast), an optional
manual control port (messenger -m, ref messenger.c:389-414), and an
optional waterfall watcher (make_plots role).

Run standalone:  python -m vlite_fast_tpu_torch.runtime.leader_main \
                    --config array.json --out-dir OUT
or embedded by `python -m vlite_fast_tpu_torch.cli launch`, which also
spawns the station daemons.

The port's copy of vlite_fast_tpu/runtime/leader_main.py, on the port's
runtime; the waterfall watcher renders with the port's analysis/waterfall.
"""

from __future__ import annotations

import argparse
import os
import socket
import tempfile
import threading
import time
from typing import Optional

from vlite_fast_tpu_torch.config import ArrayConfig
from vlite_fast_tpu_torch.runtime.candidate_server import CoincidencerServer
from vlite_fast_tpu_torch.runtime.control import Command, ObservationDocument
from vlite_fast_tpu_torch.runtime.messenger import Messenger, MessengerConfig
from vlite_fast_tpu_torch.runtime.trigger import TriggerSender
from vlite_fast_tpu_torch.utils.log import make_logger


class Leader:
    """The head-node process: bus + XML ingest + coincidencer + fanout."""

    def __init__(self, acfg: ArrayConfig, out_dir: str,
                 manual_port: Optional[int] = None,
                 obsinfo_port: Optional[int] = None,
                 waterfall: bool = False):
        self.acfg = acfg
        self.log = make_logger("leader")
        local = ("", "localhost", "127.0.0.1")
        multi_host = any(a.host not in local for a in acfg.antennas)
        bind = "0.0.0.0" if multi_host else "127.0.0.1"
        self.messenger = Messenger(MessengerConfig(
            obsinfo_port=obsinfo_port,
            command_port=acfg.command_port,
            bind_host=bind,
            archive_dir=out_dir + "/obsinfo"))
        # trigger fanout dials each station on ITS host (config/hosts
        # column; local stations stay on loopback)
        endpoints = [(a.host if a.host not in local else "127.0.0.1",
                      acfg.trigger_port_base + a.station_id)
                     for a in acfg.antennas]
        self.sender = TriggerSender(endpoints)
        self.coincidencer = CoincidencerServer(
            port=acfg.coincidencer_port, tsamp=acfg.pipeline.tsamp,
            tcfg=acfg.trigger, on_trigger=self.sender.send,
            host=bind)
        self._manual_srv = None
        self._running = True
        if manual_port is not None:
            self._manual_srv = socket.socket(socket.AF_INET,
                                             socket.SOCK_STREAM)
            self._manual_srv.setsockopt(socket.SOL_SOCKET,
                                        socket.SO_REUSEADDR, 1)
            self._manual_srv.bind(("127.0.0.1", manual_port))
            self._manual_srv.listen(4)
            self._manual_srv.settimeout(0.3)
            threading.Thread(target=self._manual_loop, daemon=True).start()
        self._wf_thread = None
        if waterfall:
            self._wf_thread = threading.Thread(
                target=self._waterfall_loop, args=(out_dir,), daemon=True)
            self._wf_thread.start()

    # -- manual telnet-style control (messenger.c:389-414) ---------------
    def _manual_loop(self):
        while self._running:
            try:
                conn, _ = self._manual_srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                conn.settimeout(2)
                data = conn.recv(64).decode(errors="replace").strip()
                if data:
                    self.messenger.manual(Command(data[0]))
                    self.log.info("manual command %r", data[0])
                    if data[0] == Command.QUIT.value:
                        self._running = False
            except Exception as e:
                self.log.warning("bad manual command: %s", e)
            finally:
                conn.close()

    def _waterfall_loop(self, out_dir: str):
        from vlite_fast_tpu_torch.analysis import waterfall as wf
        while self._running:
            try:
                wf.watch_and_render(out_dir, poll_s=2.0, max_iterations=1)
            except Exception as e:
                self.log.warning("waterfall: %s", e)
            time.sleep(5)

    @property
    def n_stations_connected(self) -> int:
        return len(self.messenger.bus._clients)

    def wait_for_stations(self, n: int, timeout: float = 60.0) -> bool:
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self.n_stations_connected >= n:
                return True
            time.sleep(0.2)
        return False

    def fake_observation(self, settle_s: float = 1.0) -> None:
        """FAKE_START to the whole array (the writer.c:195-214 fake-OD
        multi-node test path: an observation without the VLA)."""
        self.messenger.manual(Command.FAKE_START, ObservationDocument(
            name="FAKE", scan_no=2, start_time=time.time()))
        time.sleep(settle_s)

    def stop_observation(self) -> None:
        self.messenger.manual(Command.FAKE_STOP)

    def shutdown(self):
        self._running = False
        self.messenger.shutdown(settle_s=0.5)
        self.coincidencer.close()
        self.sender.close()
        if self._manual_srv:
            self._manual_srv.close()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--out-dir", default=os.path.join(
        tempfile.gettempdir(), "vfast"))
    p.add_argument("--manual-port", type=int, default=None)
    p.add_argument("--obsinfo-port", type=int, default=None)
    p.add_argument("--waterfall", action="store_true")
    args = p.parse_args(argv)
    acfg = ArrayConfig.load(args.config)
    leader = Leader(acfg, args.out_dir, manual_port=args.manual_port,
                    obsinfo_port=args.obsinfo_port,
                    waterfall=args.waterfall)
    try:
        while leader._running:
            time.sleep(0.5)
    except KeyboardInterrupt:
        pass
    leader.shutdown()


if __name__ == "__main__":
    main()
