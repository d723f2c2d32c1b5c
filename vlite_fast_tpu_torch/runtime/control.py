"""Control plane: observation documents, the scan state machine, and the
command bus.

The port's copy of vlite_fast_tpu/runtime/control.py (standard library
only), held equal to it by tests/test_torch_config.py.

Replaces the reference's messenger + executor-XML parse stack
(src/messenger.c:73-429, src/executor.c, SURVEY.md section 3.3).  TPU hosts
cannot join the VLA's UDP multicast fan-out, so the leader/worker command
bus is an explicit TCP service with the same latest-wins, at-least-once
semantics as get_cmds (ref src/utils.c:185-220): workers poll and act on the
most recent command.
"""

from __future__ import annotations

import json
import math
import socket
import threading
import time
from dataclasses import dataclass, asdict
from enum import Enum
from typing import Callable, Dict, List, Optional


class Command(str, Enum):
    """1-byte command chars of the reference (ref src/def.h:4-10)."""

    START = "S"
    STOP = "C"
    QUIT = "Q"
    EVENT = "E"
    NONE = "N"
    FAKE_START = "F"
    FAKE_STOP = "G"


@dataclass
class ObservationDocument:
    """Scan metadata (ref ObservationDocument, src/executor.h:63-111)."""

    name: str = ""
    ra: float = 0.0              # radians
    dec: float = 0.0             # radians
    start_time: float = 0.0      # unix seconds
    scan_no: int = 0
    subscan_no: int = 0
    datasetId: str = ""
    finishes: bool = False       # scan intent FINISH

    def to_json(self) -> str:
        return json.dumps(asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "ObservationDocument":
        return cls(**json.loads(s))

    def to_ascii_header(self, station_id: int = 0) -> str:
        """The baseband-ring observation header (ref write_psrdada_header,
        src/process_baseband.cu:136-200 field set)."""
        return (f"STATIONID {station_id}\nNAME {self.name}\n"
                f"RA {self.ra:.8f}\nDEC {self.dec:.8f}\n"
                f"SCANSTART {self.start_time:.6f}\nSCAN {self.scan_no}\n")


# pointing-continuity threshold (radians) and max integration before
# forcing a break (ref src/messenger.c:263-330); ScanStateMachine takes
# these as defaults
POINTING_TOL_RAD = 0.00873
MAX_INTEGRATION_S = 480.0


def angular_distance(ra1, dec1, ra2, dec2) -> float:
    """Great-circle distance in radians."""
    s = (math.sin(0.5 * (dec2 - dec1)) ** 2
         + math.cos(dec1) * math.cos(dec2)
         * math.sin(0.5 * (ra2 - ra1)) ** 2)
    return 2 * math.asin(min(1.0, math.sqrt(s)))


class ScanStateMachine:
    """The messenger decision logic (ref src/messenger.c:246-331).

    feed(od) returns the list of commands to broadcast:
      - FINISH intent          -> [STOP]
      - scanNo == 1 (dummy)    -> []
      - pointing within tol and integration < 480 s -> [] (keep integrating)
      - otherwise              -> [STOP, START] with the new OD
    """

    def __init__(self, pointing_tol: float = POINTING_TOL_RAD,
                 max_integration: float = MAX_INTEGRATION_S):
        self.current: Optional[ObservationDocument] = None
        self.obs_start_time: float = 0.0
        self.pointing_tol = pointing_tol
        self.max_integration = max_integration
        self.recording = False

    def feed(self, od: ObservationDocument,
             now: Optional[float] = None) -> List[Command]:
        now = time.time() if now is None else now
        if od.finishes or od.name.upper() == "FINISH":
            self.recording = False
            self.current = None
            return [Command.STOP]
        if od.scan_no == 1:
            return []  # dummy scan at the start of an SB
        if self.recording and self.current is not None:
            dist = angular_distance(self.current.ra, self.current.dec,
                                    od.ra, od.dec)
            integ = now - self.obs_start_time
            if dist < self.pointing_tol and integ < self.max_integration:
                self.current = od     # keep integrating, update metadata
                return []
            self.current = od
            self.obs_start_time = now
            return [Command.STOP, Command.START]
        self.current = od
        self.obs_start_time = now
        self.recording = True
        return [Command.START]

    def quit(self) -> List[Command]:
        self.recording = False
        return [Command.QUIT]


class CommandBus:
    """In-process latest-wins command distribution with optional TCP fanout.

    Local subscribers get every command (callbacks); remote workers connect
    to the leader's TCP port and receive JSON lines
    {"cmd": "S", "od": {...}} — the multicast-group replacement.
    """

    def __init__(self, port: Optional[int] = None,
                 bind_host: str = "127.0.0.1"):
        # bind_host "0.0.0.0" for multi-host arrays (remote stations
        # dial the leader's command bus; see cli launch --leader-addr)
        self._subs: List[Callable] = []
        self._clients: List[socket.socket] = []
        self._lock = threading.Lock()
        self._server = None
        self._thread = None
        self.last_command: Optional[Command] = None
        if port is not None:
            self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._server.bind((bind_host, port))
            self._server.listen(32)
            self._server.settimeout(0.2)
            self._running = True
            self._thread = threading.Thread(target=self._accept_loop,
                                            daemon=True)
            self._thread.start()

    def _accept_loop(self):
        while self._running:
            try:
                c, _ = self._server.accept()
                with self._lock:
                    self._clients.append(c)
            except socket.timeout:
                continue
            except OSError:
                break

    def subscribe(self, fn: Callable) -> None:
        self._subs.append(fn)

    def publish(self, cmd: Command,
                od: Optional[ObservationDocument] = None) -> None:
        self.last_command = cmd
        for fn in self._subs:
            fn(cmd, od)
        line = (json.dumps({"cmd": cmd.value,
                            "od": asdict(od) if od else None}) + "\n").encode()
        with self._lock:
            dead = []
            for c in self._clients:
                try:
                    c.sendall(line)
                except OSError:
                    dead.append(c)
            for c in dead:
                self._clients.remove(c)

    def close(self):
        if self._server:
            self._running = False
            self._server.close()
        with self._lock:
            for c in self._clients:
                c.close()


class CommandClient:
    """Worker-side: connect to the leader bus and poll commands
    (latest-wins like get_cmds, ref src/utils.c:185-220)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 20000):
        self.sock = socket.create_connection((host, port), timeout=5)
        self.sock.settimeout(0.1)
        self._buf = b""

    def poll(self) -> List[tuple]:
        try:
            data = self.sock.recv(65536)
            if data:
                self._buf += data
        except socket.timeout:
            pass
        out = []
        while b"\n" in self._buf:
            line, self._buf = self._buf.split(b"\n", 1)
            msg = json.loads(line)
            od = (ObservationDocument(**msg["od"])
                  if msg.get("od") else None)
            out.append((Command(msg["cmd"]), od))
        return out

    def close(self):
        self.sock.close()
