"""dencoder: encode/decode/round-trip any registered wire struct.

The ceph-dencoder analogue (ref: src/tools/ceph-dencoder/ — `list`,
`type X encode`, `decode`, `dump_json`, used with ceph-object-corpus to
pin wire encodings across releases).  Here it drives the typed codec in
the port's `msg.encoding` and provides deterministic per-type samples
(the same samples, so the same bytes, as `ceph_tpu.tools.dencoder`'s,
which tests/fixtures/wire_corpus.json pins).

Usage: `python -m ceph_tpu_torch.tools.dencoder list | encode TYPE |
decode TYPE [HEX] | roundtrip TYPE`.  The port's copy of
`ceph_tpu.tools.dencoder`; it registers every wire struct of the port,
`mon.fsmap` included, before it lists.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

from ..msg import encoding as wire

# make sure every wire struct in the tree is registered before listing
from ..crush import wrapper as _crush_wrapper    # noqa: F401
from ..mon import fsmap as _fsmap                # noqa: F401
from ..msg import messages as _messages          # noqa: F401
from ..osd import osdmap as _osdmap              # noqa: F401
from ..osd import pg_types as _pg_types          # noqa: F401
from ..osd import types as _osd_types            # noqa: F401
from ..store import objectstore as _objectstore  # noqa: F401


# --------------------------------------------------- sample generation

def _sample_value(name: str, tp) -> object:
    """Deterministic value for a field — derived from the field name so
    every type gets a stable, non-trivial corpus entry.  Annotations
    are strings (PEP 563), so match on the leading type name."""
    if not isinstance(tp, str):
        tp = getattr(tp, "__name__", str(tp))
    tp = tp.split("|")[0].strip()
    if tp.startswith("int"):
        return len(name) * 3 + 1
    if tp.startswith("float"):
        return float(len(name)) / 2
    if tp.startswith("str"):
        return f"s_{name}"
    if tp.startswith("bytes"):
        return name.encode()
    if tp.startswith("bool"):
        return len(name) % 2 == 0
    if tp.startswith(("list", "set", "frozenset")):
        return [len(name), f"i_{name}"]
    if tp.startswith("dict"):
        return {f"k_{name}": len(name)}
    if tp.startswith("tuple"):
        return (len(name), f"t_{name}")
    return None


def generic_sample(cls: type):
    """Field-derived sample for a registered dataclass."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if not f.init:
            continue
        kwargs[f.name] = _sample_value(f.name, f.type)
    return cls(**kwargs)


def _rich_samples() -> dict[str, object]:
    """Hand-built samples exercising nested structs/deep payloads."""
    from ..crush.wrapper import CrushWrapper
    from ..msg.messages import ECSubWrite, MMap, OSDOp
    from ..osd.osdmap import OSDMap
    from ..osd.pg_types import EVersion, PGLogEntry
    from ..osd.types import PG, PGPool
    from ..store.objectstore import ObjectId, Transaction

    m = OSDMap()
    m.build_simple(n_osd=4)
    txn = (Transaction()
           .write("coll", ObjectId("obj", shard=2), 64, b"payload")
           .setattrs("coll", ObjectId("obj"), {"k": b"v"})
           .omap_setkeys("coll", ObjectId("obj"), {"ok": b"ov"}))
    return {
        "OSDMap": m,
        "CrushWrapper": CrushWrapper.build_flat(3),
        "Transaction": txn,
        "PGPool": PGPool(type=3, size=5, min_size=4, pg_num=128,
                         pgp_num=128,
                         erasure_code_profile="p"),
        "PGLogEntry": PGLogEntry(op="modify", soid="o1",
                                 version=EVersion(3, 7),
                                 prior_version=EVersion(3, 6),
                                 reqid="client.1:42"),
        "PG": PG(1, 12),
        "MMap": MMap(full_map=m, first=1, last=1),
        "ECSubWrite": ECSubWrite(pgid=PG(2, 3), tid=9, txn=txn,
                                 shard=1,
                                 at_version=EVersion(4, 1)),
        "OSDOp": OSDOp(pgid=PG(0, 5), oid="x", op="write", tid=7,
                       epoch=3, offset=0, length=3, data=b"abc",
                       args={"snapc": (5, [3, 2])}),
    }


def sample(name: str):
    """The canonical corpus sample for a registered type."""
    rich = _rich_samples()
    if name in rich:
        return rich[name]
    cls = wire.registered_types().get(name)
    if cls is None:
        raise KeyError(f"unknown wire type {name!r}")
    if not dataclasses.is_dataclass(cls):
        raise KeyError(f"{name} has no generic sample (adapter type)")
    return generic_sample(cls)


def sample_names() -> list[str]:
    """Types with corpus samples: every registered dataclass + the
    hand-built adapter samples."""
    names = set(_rich_samples())
    for name, cls in wire.registered_types().items():
        if dataclasses.is_dataclass(cls):
            names.add(name)
    return sorted(names)


# ----------------------------------------------------------------- CLI

def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="dencoder",
        description="wire struct encode/decode tool (ceph-dencoder "
                    "analogue)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="list registered wire types")
    p = sub.add_parser("encode", help="encode the canonical sample")
    p.add_argument("type")
    p = sub.add_parser("decode", help="decode hex from stdin/arg")
    p.add_argument("type", help="expected type (checked)")
    p.add_argument("hex", nargs="?")
    p = sub.add_parser("roundtrip",
                       help="encode sample, decode, compare")
    p.add_argument("type")
    a = ap.parse_args(argv)

    if a.cmd == "list":
        for name in sample_names():
            print(name)
        return 0
    if a.cmd == "encode":
        print(wire.encode(sample(a.type)).hex())
        return 0
    if a.cmd == "decode":
        blob = bytes.fromhex(a.hex or sys.stdin.read().strip())
        obj = wire.decode(blob)
        got = type(obj).__name__
        if got != a.type:
            print(f"error: decoded {got}, expected {a.type}",
                  file=sys.stderr)
            return 1
        print(repr(obj))
        return 0
    if a.cmd == "roundtrip":
        obj = sample(a.type)
        blob = wire.encode(obj)
        back = wire.decode(blob)
        blob2 = wire.encode(back)
        if blob != blob2:
            print("FAIL: re-encode differs", file=sys.stderr)
            return 1
        print(f"{a.type}: {len(blob)} bytes ok")
        return 0
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
