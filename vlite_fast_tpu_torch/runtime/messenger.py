"""The cluster leader: VLA documents in, commands out (messenger role).

Re-design of src/messenger.c:73-429: subscribe to the VLA Executor's
obsinfo/antprop/alert streams, archive every document, drive the scan
state machine, and fan commands out to all nodes.  TPU hosts cannot join
the VLA multicast groups, so inputs arrive over plain UDP (one XML
document per datagram, same payloads) or are injected programmatically;
the output side is the TCP CommandBus (runtime/control.py).  Shutdown
preserves the reference's QUIT cascade ordering: consumers (readers)
first, then capture (writers) (ref messenger.c:426-429).

The port's copy of vlite_fast_tpu/runtime/messenger.py, on the port's
control, vla_xml and sources.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from vlite_fast_tpu_torch.runtime import vla_xml
from vlite_fast_tpu_torch.runtime.control import (Command, CommandBus,
                                            ObservationDocument,
                                            ScanStateMachine)
from vlite_fast_tpu_torch.utils.log import Metrics, make_logger


@dataclass
class MessengerConfig:
    obsinfo_port: Optional[int] = None    # UDP XML in (None = injected only)
    command_port: Optional[int] = None    # TCP CommandBus out
    bind_host: str = "127.0.0.1"          # "0.0.0.0" for multi-host arrays
    archive_dir: Optional[str] = None     # obsinfo/antprop file archive
    pointing_tol: float = 0.00873
    max_integration: float = 480.0
    sources_file: Optional[str] = None    # SourceWhitelist JSON override
    notify: Optional[object] = None       # callable(subject, body) for
                                          # source-of-interest alerts (the
                                          # send_email role, util.c:154)


class Messenger:
    def __init__(self, cfg: MessengerConfig = MessengerConfig()):
        self.cfg = cfg
        self.log = make_logger("messenger")
        self.metrics = Metrics()
        self.sm = ScanStateMachine(pointing_tol=cfg.pointing_tol,
                                   max_integration=cfg.max_integration)
        from vlite_fast_tpu_torch.runtime.sources import SourceWhitelist
        self.sources = (SourceWhitelist.load(cfg.sources_file)
                        if cfg.sources_file else SourceWhitelist())
        self.bus = CommandBus(port=cfg.command_port, bind_host=cfg.bind_host)
        self.last_antprop: Optional[vla_xml.AntPropDocument] = None
        self.alerts: List[vla_xml.AlertDocument] = []
        self._sock = None
        self._thread = None
        self._running = False
        if cfg.archive_dir:
            os.makedirs(cfg.archive_dir, exist_ok=True)
        if cfg.obsinfo_port is not None:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._sock.bind(("0.0.0.0", cfg.obsinfo_port))
            self._sock.settimeout(0.5)
            self._running = True
            self._thread = threading.Thread(target=self._listen, daemon=True)
            self._thread.start()

    # ------------------------------------------------------------------
    def _archive(self, kind: str, text: str) -> None:
        """Obsinfo/antprop archiving (ref messenger.c:249-261,353-363)."""
        if not self.cfg.archive_dir:
            return
        ts = time.strftime("%Y%m%d_%H%M%S")
        path = os.path.join(self.cfg.archive_dir, f"{ts}_{kind}.xml")
        with open(path, "w") as fp:
            fp.write(text)

    def _listen(self):
        while self._running:
            try:
                pkt, _ = self._sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                self.feed_xml(pkt.decode(errors="replace"))
            except Exception as e:  # malformed docs must not kill the leader
                self.log.warning("bad document: %s", e)
                self.metrics.inc("vfast_messenger_bad_docs")

    # ------------------------------------------------------------------
    def feed_xml(self, xml_text: str) -> List[Command]:
        """Parse one document, update state, publish any commands."""
        doc = vla_xml.parse_scaninfo(xml_text)
        if isinstance(doc, ObservationDocument):
            self._archive("obsinfo", xml_text)
            self.metrics.inc("vfast_messenger_obsinfo")
            return self.feed_observation(doc)
        if isinstance(doc, vla_xml.AntPropDocument):
            self._archive("antprop", xml_text)
            self.last_antprop = doc
            self.metrics.inc("vfast_messenger_antprop")
            return []
        # alert
        self.alerts.append(doc)
        if len(self.alerts) > 1000:
            self.alerts = self.alerts[-1000:]
        self.metrics.inc("vfast_messenger_alerts")
        return []

    def feed_observation(self, od: ObservationDocument) -> List[Command]:
        cmds = self.sm.feed(od)
        for c in cmds:
            self.log.info("command %s (scan %s, src %s)", c.name,
                          od.scan_no, od.name)
            self.bus.publish(c, od if c == Command.START else None)
        if Command.START in cmds:
            why = self.sources.check_observation(od)
            if why:
                # source-of-interest: flag for extra products + alert
                # (the check_name/check_id/check_coords + send_email
                # path, ref src/util.c:91-181)
                self.log.info("SOURCE OF INTEREST: %s", why)
                self.metrics.inc("vfast_messenger_source_of_interest")
                if self.cfg.notify:
                    try:
                        self.cfg.notify(
                            f"VLITE-fast observing {od.name}",
                            f"{why}; scan {od.scan_no} at "
                            f"({od.ra:.4f}, {od.dec:.4f})")
                    except Exception as e:
                        self.log.warning("notify failed: %s", e)
        return cmds

    def manual(self, cmd: Command,
               od: Optional[ObservationDocument] = None) -> None:
        """Manual control (the messenger -m telnet port role,
        ref messenger.c:389-414)."""
        self.bus.publish(cmd, od)

    def antenna_positions(self) -> Dict[int, tuple]:
        """Latest antprop positions for the localization pipeline."""
        if self.last_antprop is None:
            return {}
        return {n: (a.X, a.Y, a.Z)
                for n, a in self.last_antprop.antennas.items()}

    def shutdown(self, settle_s: float = 0.0) -> None:
        """QUIT cascade: readers first, then writers
        (ref messenger.c:426-429)."""
        self.bus.publish(Command.QUIT)          # consumers act on QUIT
        if settle_s:
            time.sleep(settle_s)
        self.bus.publish(Command.QUIT)          # capture stages
        self._running = False
        if self._sock:
            self._sock.close()
        self.bus.close()
