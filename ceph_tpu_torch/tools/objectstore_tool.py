"""ceph-objectstore-tool: offline surgery on a stopped OSD's store
(ref: src/tools/ceph_objectstore_tool.cc; VERDICT r3 #7).

Operates directly on the data directory of a DOWN OSD (BlueStore
layout: `block` + `kv/`):

    --op list                     list PG collections (or objects
                                  with --pgid)
    --op info    --pgid P         object count + durable log bounds
    --op fsck                     BlueStore checksum/reference fsck
    --op export  --pgid P --file F   serialize the whole PG: objects
                                  (data, attrs, omap, snap clones) +
                                  the pgmeta omap (durable pg_log)
    --op import  --file F         restore an exported PG into this
                                  (possibly different) OSD's store —
                                  the disk-swap / PG-rescue flow the
                                  reference tool exists for
    --op remove  --pgid P         delete a PG collection outright
    --op list-snaps --pgid P      per-object snapshot state: clone
                                  tags, covered snapids, presence
    --op dump-snap-index --pgid P the durable snaptrim state: the
                                  snap->clone index awaiting trim (the
                                  crash-resume cursor) + purged_snaps

The export blob uses the typed wire codec, so it round-trips the
exact ObjectIds (snap clones included) and the pg_log omap that
peering reads — an imported PG peers from real history instead of
backfilling.

The port's copy of `ceph_tpu.tools.objectstore_tool`: the same verbs,
text output and export blob, byte for byte, on a store either package
wrote (`python -m ceph_tpu_torch.tools.objectstore_tool --data-path
DIR --op list`).  `--op info` reads the durable log through the EC
shard's loader, which is the replicated shard's.
"""
from __future__ import annotations

import argparse
import json
import sys

from ..msg import encoding as wire
from ..osd.ec_backend import OI_ATTR, ECPGShard, pg_cid
from ..osd.snap_mapper import SnapMapper
from ..osd.types import PG
from ..store import BlueStore, ObjectId, StoreError, Transaction

EXPORT_VERSION = 1


def _open_store(path: str) -> BlueStore:
    st = BlueStore(path)
    st.mount()
    return st


def _parse_pgid(s: str) -> PG:
    pool, ps = s.split(".", 1)
    return PG(int(pool), int(ps, 16))


def _pg_cid(pg: PG) -> str:
    return pg_cid(pg)


def list_pgs(store) -> list[str]:
    out = []
    for cid in store.list_collections():
        if cid.startswith("pg_"):
            out.append(cid[3:])
    return sorted(out)


def list_objects(store, pg: PG) -> list[str]:
    cid = _pg_cid(pg)
    if not store.collection_exists(cid):
        raise StoreError("ENOENT", f"pg {pg}")
    return [repr(o) for o in sorted(store.collection_list(cid),
                                    key=lambda o: (o.name, o.snap))]


def pg_info(store, pg: PG) -> dict:
    cid = _pg_cid(pg)
    if not store.collection_exists(cid):
        raise StoreError("ENOENT", f"pg {pg}")
    shard = ECPGShard(pg, 0, store, 0, 0, create=False)
    head, tail = shard.log_info()
    objs = [o for o in store.collection_list(cid)
            if o.name != "pgmeta"]
    return {"pgid": str(pg), "objects": len(objs),
            "log_head": str(head), "log_tail": str(tail),
            "log_entries": len(shard.pg_log.log)}


def export_pg(store, pg: PG) -> bytes:
    """Serialize a whole PG — every object (head + snap clones) with
    data/attrs/omap, plus pgmeta's omap (the durable pg_log)."""
    cid = _pg_cid(pg)
    if not store.collection_exists(cid):
        raise StoreError("ENOENT", f"pg {pg}")
    objects = []
    for oid in sorted(store.collection_list(cid),
                      key=lambda o: (o.name, o.snap)):
        objects.append({
            "oid": oid,
            "data": bytes(store.read(cid, oid, 0, 0)),
            "attrs": dict(store.getattrs(cid, oid)),
            "omap": dict(store.omap_get(cid, oid)),
        })
    return wire.encode({"version": EXPORT_VERSION, "pgid": pg,
                        "objects": objects})


def import_pg(store, blob: bytes, force: bool = False) -> PG:
    """Restore an exported PG.  Refuses to clobber an existing
    collection unless forced (ref: the tool's same guard)."""
    rec = wire.decode(blob)
    if not isinstance(rec, dict) or \
            rec.get("version") != EXPORT_VERSION:
        raise StoreError("EINVAL", "not a PG export blob")
    pg = rec["pgid"]
    cid = _pg_cid(pg)
    if store.collection_exists(cid):
        if not force:
            raise StoreError("EEXIST", f"pg {pg} already present "
                                       "(--force to overwrite)")
        txn = Transaction()
        for oid in store.collection_list(cid):
            txn.remove(cid, oid)
        txn.remove_collection(cid)
        store.queue_transaction(txn)
    txn = Transaction()
    txn.create_collection(cid)
    for ent in rec["objects"]:
        oid = ent["oid"]
        txn.touch(cid, oid)
        if ent["data"]:
            txn.write(cid, oid, 0, ent["data"])
        if ent["attrs"]:
            txn.setattrs(cid, oid, ent["attrs"])
        if ent["omap"]:
            txn.omap_setkeys(cid, oid, ent["omap"])
    store.queue_transaction(txn)
    return pg


def remove_pg(store, pg: PG) -> int:
    cid = _pg_cid(pg)
    if not store.collection_exists(cid):
        raise StoreError("ENOENT", f"pg {pg}")
    objs = store.collection_list(cid)
    txn = Transaction()
    for oid in objs:
        txn.remove(cid, oid)
    txn.remove_collection(cid)
    store.queue_transaction(txn)
    return len(objs)


def list_snaps(store, pg: PG) -> list[dict]:
    """Per-object snapshot state: head snap_seq, clone tags + the
    snapids each clone covers, and whether the clone object actually
    exists — the offline view of the SnapSet scrub compares."""
    cid = _pg_cid(pg)
    if not store.collection_exists(cid):
        raise StoreError("ENOENT", f"pg {pg}")
    out = []
    for oid in sorted(store.collection_list(cid),
                      key=lambda o: (o.name, o.snap)):
        if oid.name == "pgmeta" or oid.snap != -2:
            continue
        try:
            oi = dict(store.getattr(cid, oid, OI_ATTR))
        except StoreError:
            continue
        clones = {int(t): list(c)
                  for t, c in oi.get("clones", {}).items()}
        if not clones and not oi.get("snap_seq"):
            continue
        out.append({
            "oid": oid.name,
            "snap_seq": oi.get("snap_seq", 0),
            "whiteout": bool(oi.get("whiteout")),
            "clones": {
                str(t): {"covers": c,
                         "present": store.exists(
                             cid, ObjectId(oid.name, snap=t))}
                for t, c in sorted(clones.items())},
        })
    return out


def dump_snap_index(store, pg: PG) -> dict:
    """The durable snaptrim state: the snap->clone index entries still
    awaiting trim (the resume cursor) + the purged_snaps interval set
    — what a promoted primary would act on."""
    cid = _pg_cid(pg)
    if not store.collection_exists(cid):
        raise StoreError("ENOENT", f"pg {pg}")
    sm = SnapMapper(store, cid)
    return {"pgid": str(pg), "index": sm.dump(),
            "purged_snaps": sm.purged_snaps().to_list()}


def remove_pg(store, pg: PG) -> int:
    cid = _pg_cid(pg)
    if not store.collection_exists(cid):
        raise StoreError("ENOENT", f"pg {pg}")
    objs = store.collection_list(cid)
    txn = Transaction()
    for oid in objs:
        txn.remove(cid, oid)
    txn.remove_collection(cid)
    store.queue_transaction(txn)
    return len(objs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ceph-tpu-torch-objectstore-tool")
    ap.add_argument("--data-path", required=True,
                    help="the STOPPED OSD's store directory")
    ap.add_argument("--op", required=True,
                    choices=["list", "info", "fsck", "export",
                             "import", "remove", "list-snaps",
                             "dump-snap-index"])
    ap.add_argument("--pgid", default="",
                    help="pg id as <pool>.<ps-hex>")
    ap.add_argument("--file", default="", help="export/import blob")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--repair", action="store_true",
                    help="(fsck) placeholder — errors are reported; "
                         "repair rides scrub in a live cluster")
    a = ap.parse_args(argv)
    store = _open_store(a.data_path)
    try:
        if a.op == "list":
            if a.pgid:
                for line in list_objects(store, _parse_pgid(a.pgid)):
                    print(line)
            else:
                for p in list_pgs(store):
                    print(p)
        elif a.op == "info":
            print(json.dumps(pg_info(store, _parse_pgid(a.pgid))))
        elif a.op == "fsck":
            errors = store.fsck()
            for e in errors:
                print(e)
            print(f"fsck: {len(errors)} error(s)")
            return 1 if errors else 0
        elif a.op == "export":
            blob = export_pg(store, _parse_pgid(a.pgid))
            with open(a.file, "wb") as f:
                f.write(blob)
            print(f"exported {a.pgid}: {len(blob)} bytes")
        elif a.op == "import":
            with open(a.file, "rb") as f:
                pg = import_pg(store, f.read(), force=a.force)
            print(f"imported {pg}")
        elif a.op == "remove":
            n = remove_pg(store, _parse_pgid(a.pgid))
            print(f"removed {a.pgid}: {n} object(s)")
        elif a.op == "list-snaps":
            for ent in list_snaps(store, _parse_pgid(a.pgid)):
                print(json.dumps(ent))
        elif a.op == "dump-snap-index":
            print(json.dumps(dump_snap_index(store,
                                             _parse_pgid(a.pgid))))
        return 0
    except StoreError as ex:
        print(f"error: {ex}", file=sys.stderr)
        return 1
    finally:
        store.umount()


if __name__ == "__main__":
    sys.exit(main())
