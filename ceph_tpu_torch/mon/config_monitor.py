"""ConfigMonitor: centralized configuration replicated through the mon
quorum (ref: src/mon/ConfigMonitor.cc; ConfigMap sections
src/mon/ConfigMap.h).

`config set/rm` stage into a pending change list, commit through paxos
like any map mutation, and push to subscribed daemons as MConfig —
the reference's `ceph config set osd.3 debug_osd 10` flow
(ConfigMonitor::prepare_command -> encode_pending ->
check_all_subs/send_config).

Sections: "global", a daemon type ("osd", "mon", "client"), or a
specific entity ("osd.3") — most-specific wins at the daemon
(ConfigMap::generate_entity_map precedence).

The port's copy of `ceph_tpu.mon.config_monitor`.
"""
from __future__ import annotations

from ..msg import encoding as wire
from .paxos import Paxos, PaxosService
from .store import StoreTransaction

_ENOENT, _EINVAL = 2, 22


class ConfigMonitor(PaxosService):
    """(ref: src/mon/ConfigMonitor.h:13)."""

    def __init__(self, paxos: Paxos):
        super().__init__("config", paxos)
        #: committed state: section -> {option: value}
        self.config: dict[str, dict[str, str]] = {}
        #: staged deltas: list of (section, name, value|None)
        self.pending: list[tuple] = []

    # ------------------------------------------------------- paxos hooks
    def create_initial(self) -> None:
        self.pending = []
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
        new = {k: dict(v) for k, v in self.config.items()}
        for section, name, value in self.pending:
            if value is None:
                new.get(section, {}).pop(name, None)
                if not new.get(section):
                    new.pop(section, None)
            else:
                new.setdefault(section, {})[name] = str(value)
        e = self.get_last_committed() + 1
        self.put_version(tx, f"v_{e}", wire.encode(new))
        self.put_version(tx, "last_committed", e)

    def update_from_paxos(self) -> None:
        e = self.get_last_committed()
        if e:
            blob = self.get_version(f"v_{e}")
            if blob is not None:
                self.config = wire.decode(blob)

    def create_pending(self) -> None:
        self.pending = []

    def _is_pending_empty(self) -> bool:
        return not self.pending

    # -------------------------------------------------------- commands
    def preprocess_command(self, cmdmap: dict):
        """Read-only commands answered from committed state; None
        means a write that must stage (ref: ConfigMonitor.cc
        preprocess_command)."""
        prefix = cmdmap.get("prefix", "")
        if prefix == "config dump":
            return 0, "", {k: dict(v)
                           for k, v in sorted(self.config.items())}
        if prefix == "config get":
            who = cmdmap["who"]
            name = cmdmap.get("name") or cmdmap.get("key")
            merged = self.entity_config(who)
            if name:
                if name not in merged:
                    return -_ENOENT, f"{name} not set for {who}", None
                return 0, "", merged[name]
            return 0, "", merged
        if prefix in ("config set", "config rm"):
            if not cmdmap.get("who") or not (
                    cmdmap.get("name") or cmdmap.get("key")):
                return -_EINVAL, "usage: config set <who> <name> " \
                    "<value>", None
            return None                     # stage it
        return None if prefix.startswith("config") else NotImplemented

    def prepare_command(self, cmdmap: dict):
        """(ref: ConfigMonitor.cc prepare_command)."""
        prefix = cmdmap.get("prefix", "")
        who = cmdmap["who"]
        name = cmdmap.get("name") or cmdmap.get("key")
        if prefix == "config set":
            if "value" not in cmdmap:
                return -_EINVAL, "missing value", None
            self.pending.append((who, name, str(cmdmap["value"])))
            return 0, f"set {who}/{name}", None
        if prefix == "config rm":
            self.pending.append((who, name, None))
            return 0, f"removed {who}/{name}", None
        return -_EINVAL, f"unknown config command {prefix}", None

    # ----------------------------------------------------- entity view
    def entity_config(self, entity: str) -> dict[str, str]:
        """Merged options for one daemon, least- to most-specific:
        global < type < entity (ref: ConfigMap::generate_entity_map)."""
        out: dict[str, str] = {}
        etype = entity.split(".", 1)[0]
        for section in ("global", etype, entity):
            out.update(self.config.get(section, {}))
        return out
