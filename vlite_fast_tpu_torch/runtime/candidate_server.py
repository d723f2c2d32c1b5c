"""Cross-host candidate streaming + the central coincidencer service.

The reference's searches push candidate text batches over TCP to a single
coincidencer (heimdall's -coincidencer flag -> trigger.py's server on port
27555, ref src/trigger.py:37-43,87-176).  Same topology here: each host's
search stages send batches for their beams; the server groups by
observation UTC, coincidences across beams, applies the trigger cuts, and
hands Triggers to a callback (which the array runtime fans out to dumpers).

Wire format (newline-delimited text, one batch per connection):
  line 0: "<utc> beam <beam_number>"      (batch header)
  line 1+: candidate lines (Candidate.to_line tab-separated fields,
           heimdall-ordered: snr peak_idx peak_time tfilt dmi dm ngiant
           i0 i1 — ref src/candidate.py:3-24)

The port's copy of vlite_fast_tpu/runtime/candidate_server.py, on the
port's config, trigger and Candidate.
"""

from __future__ import annotations

import socket
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

from vlite_fast_tpu_torch.config import TriggerConfig
from vlite_fast_tpu_torch.ops.dedisperse import Candidate
from vlite_fast_tpu_torch.runtime import trigger as trig
from vlite_fast_tpu_torch.utils.log import make_logger


def format_batch(utc: str, beam: int, cands: List[Candidate]) -> bytes:
    lines = [f"{utc} beam {beam}"]
    lines += [c.to_line() for c in cands]
    return ("\n".join(lines) + "\n").encode()


def parse_batch(payload: bytes) -> tuple:
    lines = [ln for ln in payload.decode().splitlines() if ln.strip()]
    if not lines:
        raise ValueError("empty candidate batch")
    toks = lines[0].split()
    utc, beam = toks[0], int(toks[2])
    cands = [Candidate.from_line(ln) for ln in lines[1:]]
    return utc, beam, cands


class CandidateClient:
    """Search-side: push one batch per connection (heimdall's pattern)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 27555):
        self.addr = (host, port)

    def send(self, utc: str, beam: int, cands: List[Candidate]) -> None:
        with socket.create_connection(self.addr, timeout=5) as s:
            s.sendall(format_batch(utc, beam, cands))
            s.shutdown(socket.SHUT_WR)


class CoincidencerServer:
    """The trigger.py service: accept batches, coincidence, trigger.

    on_trigger(trigger) is called for each NEW trigger (deduplicated per
    UTC like utc_sent_triggers, ref src/trigger.py:91,147-153).
    """

    def __init__(self, port: int = 27555, tsamp: float = 1.0 / 1280,
                 tcfg: TriggerConfig = TriggerConfig(),
                 on_trigger: Optional[Callable] = None,
                 host: str = "127.0.0.1"):
        self.tsamp = tsamp
        self.tcfg = tcfg
        self.on_trigger = on_trigger or (lambda t: None)
        self.log = make_logger("coincidencer")
        self.utc_groups: Dict[str, Dict[int, List[Candidate]]] = \
            defaultdict(lambda: defaultdict(list))
        self.sent: Dict[str, set] = defaultdict(set)
        self.triggers: List[trig.Trigger] = []
        self._lock = threading.Lock()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(32)
        self._srv.settimeout(0.3)
        self._running = True
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True)
        self._thread.start()

    def _accept_loop(self):
        while self._running:
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                chunks = []
                conn.settimeout(5)
                while True:
                    b = conn.recv(65536)
                    if not b:
                        break
                    chunks.append(b)
                self.ingest(b"".join(chunks))
            except Exception as e:
                self.log.warning("bad candidate batch: %s", e)
            finally:
                conn.close()

    def ingest(self, payload: bytes) -> List[trig.Trigger]:
        """Process one batch; returns any new triggers."""
        utc, beam, cands = parse_batch(payload)
        with self._lock:
            self.utc_groups[utc][beam].extend(cands)
            per_beam = {b: list(cs)
                        for b, cs in self.utc_groups[utc].items()}
            # a weeks-long service must not accrue every observation's
            # groups: keep the most recent few (one group per obs UTC)
            while len(self.utc_groups) > 64:
                oldest = next(iter(self.utc_groups))
                del self.utc_groups[oldest]
                self.sent.pop(oldest, None)
        coincided = trig.coincidence(per_beam, self.tsamp,
                                     delta_dm=self.tcfg.delta_dm,
                                     delta_w=self.tcfg.delta_w)
        utc_start = _parse_utc(utc)
        new = []
        made = trig.make_triggers(coincided, utc_start, self.tcfg)
        with self._lock:
            for t in made:
                key = (round(t.t0, 3), round(t.dm, 2))
                if key in self.sent[utc]:
                    continue
                self.sent[utc].add(key)
                self.triggers.append(t)
                new.append(t)
        for t in new:
            self.log.info("TRIGGER sn=%.1f dm=%.1f window=%.2f-%.2f",
                          t.sn, t.dm, t.t0, t.t1)
            self.on_trigger(t)
        return new

    def close(self):
        self._running = False
        self._srv.close()


def _parse_utc(utc: str) -> float:
    """'%Y-%m-%d-%H:%M:%S' -> unix seconds (ref trigger.py:169-171);
    numeric strings pass through."""
    try:
        return float(utc)
    except ValueError:
        import calendar
        t = time.strptime(utc, "%Y-%m-%d-%H:%M:%S")
        return float(calendar.timegm(t))
