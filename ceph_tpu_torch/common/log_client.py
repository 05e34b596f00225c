"""LogClient: a daemon's channel into the mon cluster log (ref:
src/common/LogClient.cc — queue locally, flush batches to the mon, trim
on MLogAck, resend un-acked on the next flush so entries survive mon
failover).

The port's copy of `ceph_tpu.common.log_client`.
"""
from __future__ import annotations

import time
from typing import Callable

from .lockdep import make_lock


class LogClient:
    """`clog` on every daemon (ref: LogClient.h LogChannel).

    `send_fn(msg)` delivers to the daemon's CURRENT mon (re-resolved
    per call, so a mon failover just redirects the next flush); acks
    arrive via `handle_ack`.  Entries carry a per-daemon monotone seq
    — the mon dedups resends on it."""

    def __init__(self, name: str, send_fn: Callable):
        self.name = name
        self._send = send_fn
        self._lock = make_lock(f"log_client.{name}")
        self._seq = 0
        self._buf: list[dict] = []      # un-acked, ascending seq

    # ------------------------------------------------------- producers
    def log(self, level: str, text: str) -> None:
        with self._lock:
            self._buf.append({"seq": self._seq, "stamp": time.time(),
                              "name": self.name, "level": level,
                              "text": text})
            self._seq += 1

    def debug(self, text: str) -> None:
        self.log("debug", text)

    def info(self, text: str) -> None:
        self.log("info", text)

    def warn(self, text: str) -> None:
        self.log("warn", text)

    def error(self, text: str) -> None:
        self.log("error", text)

    # ------------------------------------------------------- transport
    def flush(self) -> None:
        """Send everything un-acked (idempotent: the mon dedups by
        seq, so resending the whole window is the simple-and-correct
        retransmit after a lost ack or a mon failover)."""
        from ..msg.messages import MLog
        with self._lock:
            if not self._buf:
                return
            entries = [dict(e) for e in self._buf]
        self._send(MLog(entries=entries))

    def handle_ack(self, msg) -> None:
        if msg.name != self.name:
            return
        with self._lock:
            self._buf = [e for e in self._buf
                         if e["seq"] > msg.last_seq]

    def pending(self) -> int:
        with self._lock:
            return len(self._buf)
