"""LogMonitor: the cluster log replicated through the mon quorum
(ref: src/mon/LogMonitor.cc persisting LogEntry batches through paxos;
src/common/LogEntry.h).

Every daemon's LogClient batches entries (`{seq, stamp, name, level,
text}`) into MLog messages; the leader stages them here, commits them
like any map mutation (so `log last` answers identically across mon
failover), acks the sender's high-water seq, and keeps a bounded
recent ring plus per-severity counters for health/prometheus.

The port's copy of `ceph_tpu.mon.log_monitor`.
"""
from __future__ import annotations

from ..msg import encoding as wire
from .paxos import Paxos, PaxosService
from .store import StoreTransaction

_EINVAL = 22

#: severity order for `log last <n> <level>` filtering
LEVELS = ("debug", "info", "warn", "error")


def _lvl(level: str) -> int:
    try:
        return LEVELS.index(level)
    except ValueError:
        return 1


class LogMonitor(PaxosService):
    """(ref: src/mon/LogMonitor.h)."""

    #: committed ring bound (the reference trims its summary the same
    #: way; ref: LogMonitor.cc log keeping a tail)
    MAX_ENTRIES = 500

    def __init__(self, paxos: Paxos):
        super().__init__("logm", paxos)
        #: committed: {"entries": [...], "last_by_name": {name: seq},
        #:             "counts": {level: n}}
        self.summary: dict = {"entries": [], "last_by_name": {},
                              "counts": {}}
        self.pending: list[dict] = []

    # ------------------------------------------------------- paxos hooks
    def create_initial(self) -> None:
        self.pending = []
        self._bootstrap = True

    def encode_pending(self, tx: StoreTransaction) -> None:
        if getattr(self, "_bootstrap", False):
            self._bootstrap = False
            self.put_version(tx, "v_1", wire.encode(self.summary))
            self.put_version(tx, "last_committed", 1)
            self.put_version(tx, "first_committed", 1)
            return
        if not self.pending:
            return
        new = {"entries": list(self.summary["entries"]),
               "last_by_name": dict(self.summary["last_by_name"]),
               "counts": dict(self.summary["counts"])}
        for e in self.pending:
            last = new["last_by_name"].get(e["name"], -1)
            if e["seq"] <= last:
                continue            # resend of an already-committed entry
            new["last_by_name"][e["name"]] = e["seq"]
            new["entries"].append(e)
            new["counts"][e["level"]] = \
                new["counts"].get(e["level"], 0) + 1
        new["entries"] = new["entries"][-self.MAX_ENTRIES:]
        v = self.get_last_committed() + 1
        self.put_version(tx, f"v_{v}", wire.encode(new))
        self.put_version(tx, "last_committed", v)

    def update_from_paxos(self) -> None:
        v = self.get_last_committed()
        if v:
            blob = self.get_version(f"v_{v}")
            if blob is not None:
                self.summary = wire.decode(blob)

    def create_pending(self) -> None:
        self.pending = []

    def _is_pending_empty(self) -> bool:
        return not self.pending

    # ------------------------------------------------------- staging
    def stage_entries(self, entries: list[dict]) -> bool:
        """Queue daemon entries for the next proposal; returns True if
        anything new was staged (dup seqs are dropped here too so a
        resend storm doesn't force empty proposals)."""
        staged = False
        pend_last: dict[str, int] = {}
        for e in self.pending:
            pend_last[e["name"]] = max(pend_last.get(e["name"], -1),
                                       e["seq"])
        for e in entries:
            name = str(e.get("name", "?"))
            seq = int(e.get("seq", 0))
            last = max(self.summary["last_by_name"].get(name, -1),
                       pend_last.get(name, -1))
            if seq <= last:
                continue
            pend_last[name] = seq
            self.pending.append({
                "seq": seq, "stamp": float(e.get("stamp", 0.0)),
                "name": name,
                "level": str(e.get("level", "info")),
                "text": str(e.get("text", ""))})
            staged = True
        return staged

    def last_seq_for(self, name: str) -> int:
        return self.summary["last_by_name"].get(name, -1)

    # ------------------------------------------------------- commands
    def preprocess_command(self, cmdmap: dict):
        prefix = cmdmap.get("prefix", "")
        if prefix == "log last":
            n = int(cmdmap.get("num", 20))
            floor = _lvl(str(cmdmap.get("level", "debug")))
            out = [e for e in self.summary["entries"]
                   if _lvl(e["level"]) >= floor]
            return 0, "", out[-n:]
        if prefix == "log counts":
            return 0, "", dict(self.summary["counts"])
        if prefix == "log":
            if not cmdmap.get("logtext"):
                return -_EINVAL, "usage: log <text>", None
            return None                     # stage it
        return NotImplemented

    def prepare_command(self, cmdmap: dict):
        """Operator-injected entry (ref: `ceph log <text>` ->
        LogMonitor::prepare_command)."""
        text = str(cmdmap.get("logtext", ""))
        name = str(cmdmap.get("who", "client.admin"))
        seq = self.last_seq_for(name) + 1 + len(
            [e for e in self.pending if e["name"] == name])
        self.pending.append({"seq": seq, "stamp": 0.0, "name": name,
                             "level": str(cmdmap.get("level", "info")),
                             "text": text})
        return 0, "logged", None
