"""ceph-monstore-tool: offline inspection/repair of a mon's durable
store (ref: src/tools/ceph_monstore_tool.cc; VERDICT r3 #7).

Operates on a STOPPED mon's KV directory (the LogDB the durable
MonitorStore sits on):

    dump                         every (prefix, key) with value sizes
    show-versions                per-service first/last committed +
                                 paxos bounds
    get --prefix P --key K       decode one value (JSON-ish repr)
    get-osdmap [--epoch N]       summarize a committed full OSDMap
    rebuild --out DIR            rewrite the store into a fresh,
                                 compacted LogDB (drops any torn WAL
                                 tail; the recovery flow for a store
                                 whose log grew or was truncated)

The port's copy of `ceph_tpu.tools.monstore_tool`, whole: the same
verbs and text output on a store either package wrote (`python -m
ceph_tpu_torch.tools.monstore_tool DIR show-versions`).
"""
from __future__ import annotations

import argparse
import json
import sys

from ..kv import LogDB
from ..mon.store import MonitorStore
from ..msg import encoding as wire


def _load(path: str) -> MonitorStore:
    return MonitorStore(LogDB(path))


def dump(store: MonitorStore) -> list[str]:
    out = []
    for (prefix, key), value in sorted(store._data.items()):
        size = len(repr(value))
        out.append(f"{prefix}/{key}: {type(value).__name__} "
                   f"({size} bytes repr)")
    return out


def show_versions(store: MonitorStore) -> dict:
    services: dict[str, dict] = {}
    for (prefix, key) in store._data:
        svc = services.setdefault(prefix, {"keys": 0,
                                           "first_version": None,
                                           "last_version": None})
        svc["keys"] += 1
        if key.isdigit():
            v = int(key)
            if svc["first_version"] is None or v < svc["first_version"]:
                svc["first_version"] = v
            if svc["last_version"] is None or v > svc["last_version"]:
                svc["last_version"] = v
    return services


def get_osdmap(store: MonitorStore, epoch: int = 0) -> dict:
    """Summarize a committed full map (ref: the tool's get osdmap).
    The osdmap paxos service stores `full_<e>` =
    wire((OSDMap, CrushWrapper)) under its service prefix."""
    versions = [int(k[5:]) for k in store.keys("osdmap")
                if k.startswith("full_") and k[5:].isdigit()]
    if not versions:
        raise KeyError("no committed full osdmaps")
    epoch = epoch or max(versions)
    blob = store.get("osdmap", f"full_{epoch}")
    if blob is None:
        raise KeyError(f"no full osdmap at epoch {epoch}")
    m = wire.decode(blob)
    if isinstance(m, tuple):
        m = m[0]
    elif isinstance(m, list):
        m = m[0]
    return {"epoch": getattr(m, "epoch", epoch),
            "max_osd": getattr(m, "max_osd", None),
            "pools": {pid: {"pg_num": p.pg_num, "pgp_num": p.pgp_num,
                            "size": p.size}
                      for pid, p in getattr(m, "pools", {}).items()},
            "up": [o for o in range(getattr(m, "max_osd", 0))
                   if m.is_up(o)],
            "pg_temp": {str(k): v for k, v in
                        getattr(m, "pg_temp", {}).items()},
            "available_epochs": sorted(versions)}


def rebuild(src, out_path: str) -> int:
    """Write a fresh compacted store with the same contents.  `src`
    is an open MonitorStore or a path (a path is loaded and closed
    here; an open store is left to the caller)."""
    own = isinstance(src, str)
    store = _load(src) if own else src
    try:
        out = LogDB(out_path)
        txn = out.transaction()
        n = 0
        for (prefix, key), value in sorted(store._data.items()):
            txn.set(prefix, key, value)
            n += 1
        out.submit_transaction(txn)
        out.close()
        return n
    finally:
        if own:
            store.db.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ceph-tpu-torch-monstore-tool")
    ap.add_argument("path", help="the STOPPED mon's KV directory")
    ap.add_argument("op", choices=["dump", "show-versions", "get",
                                   "get-osdmap", "rebuild"])
    ap.add_argument("--prefix", default="")
    ap.add_argument("--key", default="")
    ap.add_argument("--epoch", type=int, default=0)
    ap.add_argument("--out", default="", help="(rebuild) target dir")
    a = ap.parse_args(argv)
    store = _load(a.path)
    try:
        if a.op == "dump":
            for line in dump(store):
                print(line)
        elif a.op == "show-versions":
            print(json.dumps(show_versions(store), indent=1))
        elif a.op == "get":
            v = store.get(a.prefix, a.key)
            if v is None:
                print("not found", file=sys.stderr)
                return 1
            print(repr(v))
        elif a.op == "get-osdmap":
            print(json.dumps(get_osdmap(store, a.epoch), indent=1))
        elif a.op == "rebuild":
            if not a.out:
                print("rebuild requires --out", file=sys.stderr)
                return 1
            n = rebuild(store, a.out)
            print(f"rebuilt {n} keys into {a.out}")
        return 0
    except KeyError as ex:
        print(f"error: {ex}", file=sys.stderr)
        return 1
    finally:
        if store.db is not None:
            store.db.close()


if __name__ == "__main__":
    sys.exit(main())
