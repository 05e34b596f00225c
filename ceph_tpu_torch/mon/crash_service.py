"""CrashService: the cluster crash table replicated through the mon
quorum (ref: src/pybind/mgr/crash/module.py — the reference's mgr crash module
persists crash metadata in the mon KV store; here the table IS a
PaxosService so `crash ls` answers identically across mon failover,
like the cluster log).

Daemons (or their spool-drain on next boot) post crash-metadata dicts
via `crash post`; ingestion dedups by crash_id, so a report delivered
both live and from the spool lands exactly once.  `crash
archive[-all]` marks reports seen — the mgr crash module stops
counting archived reports toward RECENT_CRASH — and `crash prune`
drops old archived reports.

The port's copy of `ceph_tpu.mon.crash_service`, whole: its committed
table encodes to the reference's bytes.
"""
from __future__ import annotations

import time

from ..msg import encoding as wire
from .paxos import Paxos, PaxosService
from .store import StoreTransaction

_EINVAL = 22
_ENOENT = 2

#: table bound: oldest reports fall off past this (ref: the reference
#: keeps a year and prunes; a bounded table keeps proposals small)
MAX_CRASHES = 500

#: meta fields `crash post` requires (ref: crash/module.py validation)
REQUIRED_FIELDS = ("crash_id", "timestamp", "entity_name", "backtrace")


class CrashService(PaxosService):
    """(ref: the crash table mgr/crash keeps under its mon-store
    prefix; commands src/pybind/mgr/crash/module.py CLICommand)."""

    def __init__(self, paxos: Paxos):
        super().__init__("crash", paxos)
        #: committed: crash_id -> meta dict (meta["archived"] is the
        #: archive stamp or None)
        self.crashes: dict[str, dict] = {}
        #: staged ops: ("post", meta) | ("archive", id, stamp) |
        #: ("archive_all", stamp) | ("prune", keep_secs, now)
        self.pending: list[tuple] = []

    # ------------------------------------------------------- paxos hooks
    def create_initial(self) -> None:
        self.pending = []
        # bootstrap commits an initial empty table: an empty encode
        # would fork paxos history on revived mons (the fsmap lesson)
        self._bootstrap = True

    def encode_pending(self, tx: StoreTransaction) -> None:
        if getattr(self, "_bootstrap", False):
            self._bootstrap = False
            self.put_version(tx, "v_1", wire.encode({}))
            self.put_version(tx, "last_committed", 1)
            self.put_version(tx, "first_committed", 1)
            return
        if not self.pending:
            return
        new = {cid: dict(meta) for cid, meta in self.crashes.items()}
        for op in self.pending:
            kind = op[0]
            if kind == "post":
                meta = op[1]
                new.setdefault(meta["crash_id"], dict(meta))
            elif kind == "archive":
                _kind, cid, stamp = op
                if cid in new and not new[cid].get("archived"):
                    new[cid]["archived"] = stamp
            elif kind == "archive_all":
                for meta in new.values():
                    if not meta.get("archived"):
                        meta["archived"] = op[1]
            elif kind == "prune":
                _kind, keep_secs, now = op
                new = {cid: m for cid, m in new.items()
                       if not m.get("archived")
                       or now - m.get("stamp", 0.0) <= keep_secs}
        if len(new) > MAX_CRASHES:
            oldest = sorted(new, key=lambda c: new[c].get("stamp", 0.0))
            for cid in oldest[:len(new) - MAX_CRASHES]:
                del new[cid]
        v = self.get_last_committed() + 1
        self.put_version(tx, f"v_{v}", wire.encode(new))
        self.put_version(tx, "last_committed", v)

    def update_from_paxos(self) -> None:
        v = self.get_last_committed()
        if v:
            blob = self.get_version(f"v_{v}")
            if blob is not None:
                self.crashes = wire.decode(blob)

    def create_pending(self) -> None:
        self.pending = []

    def _is_pending_empty(self) -> bool:
        return not self.pending

    # --------------------------------------------------------- queries
    def ls(self, new_only: bool = False) -> list[dict]:
        out = [dict(m) for m in self.crashes.values()
               if not (new_only and m.get("archived"))]
        out.sort(key=lambda m: (m.get("stamp", 0.0), m["crash_id"]))
        return out

    # -------------------------------------------------------- commands
    def preprocess_command(self, cmdmap: dict):
        prefix = cmdmap.get("prefix", "")
        if prefix in ("crash ls", "crash ls-new"):
            out = self.ls(new_only=prefix == "crash ls-new")
            lines = [f"{m['crash_id']}  {m['entity_name']}"
                     + ("" if m.get("archived") else "  *")
                     for m in out]
            return 0, "\n".join(lines), out
        if prefix == "crash info":
            cid = str(cmdmap.get("id", ""))
            meta = self.crashes.get(cid)
            if meta is None:
                return -_ENOENT, f"crash {cid!r} not found", None
            return 0, "", dict(meta)
        if prefix == "crash stat":
            new = sum(1 for m in self.crashes.values()
                      if not m.get("archived"))
            return 0, (f"{len(self.crashes)} crashes recorded, "
                       f"{new} unarchived"), \
                {"total": len(self.crashes), "new": new}
        if prefix in ("crash post", "crash archive",
                      "crash archive-all", "crash prune"):
            return None                      # writes: stage them
        return -_EINVAL, f"unknown crash command {prefix!r}", None

    def prepare_command(self, cmdmap: dict):
        prefix = cmdmap.get("prefix", "")
        now = time.time()
        if prefix == "crash post":
            meta = cmdmap.get("meta")
            if not isinstance(meta, dict):
                return -_EINVAL, "crash post wants a meta dict", None
            missing = [f for f in REQUIRED_FIELDS if not meta.get(f)]
            if missing:
                return -_EINVAL, \
                    f"crash meta missing fields: {missing}", None
            cid = str(meta["crash_id"])
            staged = {m["crash_id"] for op in self.pending
                      if op[0] == "post" for m in (op[1],)}
            if cid in self.crashes or cid in staged:
                # spool+post double delivery: exactly-once by crash_id
                return 0, "already reported", None
            keep = dict(meta)
            keep["archived"] = None
            self.pending.append(("post", keep))
            return 0, "", None
        if prefix == "crash archive":
            cid = str(cmdmap.get("id", ""))
            meta = self.crashes.get(cid)
            if meta is None:
                return -_ENOENT, f"crash {cid!r} not found", None
            if meta.get("archived"):
                return 0, "already archived", None
            self.pending.append(("archive", cid, now))
            return 0, "", None
        if prefix == "crash archive-all":
            if all(m.get("archived") for m in self.crashes.values()):
                return 0, "", None           # nothing new: no proposal
            self.pending.append(("archive_all", now))
            return 0, "", None
        if prefix == "crash prune":
            keep_days = float(cmdmap.get("keep", 0))
            if keep_days < 0:
                return -_EINVAL, "keep must be >= 0 days", None
            self.pending.append(("prune", keep_days * 86400.0, now))
            return 0, "", None
        return -_EINVAL, f"unknown crash command {prefix!r}", None
