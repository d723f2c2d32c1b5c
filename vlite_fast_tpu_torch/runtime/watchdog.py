"""Failure detection: escalating counters, stall detection, node checks.

The reference's philosophy is fail fast, restart the observation
(SURVEY.md section 5 "Failure detection"): escalating packet/skip counters
in the writer (writer.c:32-37), ring-full aborts, plus external watchdogs
(scripts/check_nodes.py ping+email, monitor_processes.py log-matching).
This module centralizes those behaviors as in-process monitors with
callback actions instead of log scraping.

The port's copy of vlite_fast_tpu/runtime/watchdog.py (standard library
only).
"""

from __future__ import annotations

import subprocess
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


@dataclass
class EscalatingCounter:
    """Warn at `warn`, trip at `abort` (ref writer.c anomalous/skip
    counters :32-37,616-672)."""

    name: str
    warn: int
    abort: int
    count: int = 0
    warned: bool = False

    def add(self, n: int = 1) -> Optional[str]:
        """Returns 'warn' or 'abort' when a threshold is first crossed."""
        self.count += n
        if self.count >= self.abort:
            return "abort"
        if self.count >= self.warn and not self.warned:
            self.warned = True
            return "warn"
        return None

    def reset(self):
        self.count = 0
        self.warned = False


@dataclass
class StallDetector:
    """Heartbeat monitor (the monitor_processes.py intent,
    ref src/monitor_processes.py:1-93, without the log scraping):
    a stage calls beat() as it makes progress; check() reports stages
    whose last beat is older than `timeout`."""

    timeout: float = 30.0
    _beats: Dict[str, float] = field(default_factory=dict)

    def beat(self, stage: str, now: Optional[float] = None) -> None:
        self._beats[stage] = time.monotonic() if now is None else now

    def check(self, now: Optional[float] = None) -> List[str]:
        now = time.monotonic() if now is None else now
        return [s for s, t in self._beats.items() if now - t > self.timeout]


def ping(host: str, timeout_s: float = 2.0) -> bool:
    """Node liveness (ref scripts/check_nodes.py:44-69)."""
    try:
        r = subprocess.run(["ping", "-c", "1", "-W",
                            str(int(timeout_s)), host],
                           capture_output=True, timeout=timeout_s + 2)
        return r.returncode == 0
    except Exception:
        return False


def email_notifier(to_addrs: List[str], from_addr: str = "vfast@localhost",
                   smtp_host: str = "localhost",
                   subject: str = "VLITE-Fast alert") -> Callable[[str], None]:
    """Alert delivery hook (the send_email role, ref src/util.c:154-181,
    src/send_email.py).  Returns a notify(msg) callable; failures to send
    are swallowed (alerts must never crash the pipeline)."""
    def notify(msg: str) -> None:
        try:
            import smtplib
            from email.message import EmailMessage
            em = EmailMessage()
            em["From"] = from_addr
            em["To"] = ", ".join(to_addrs)
            em["Subject"] = subject
            em.set_content(msg)
            with smtplib.SMTP(smtp_host, timeout=10) as s:
                s.send_message(em)
        except Exception:
            pass
    return notify


def check_nodes(hosts: List[str],
                notify: Optional[Callable[[str], None]] = None) -> Dict[str, bool]:
    """Ping every host; call notify(msg) for down nodes (the email role
    of check_nodes.py / util.c send_email, without hardcoded sendmail)."""
    status = {h: ping(h) for h in hosts}
    down = [h for h, ok in status.items() if not ok]
    if down and notify:
        notify(f"nodes down: {', '.join(down)}")
    return status
