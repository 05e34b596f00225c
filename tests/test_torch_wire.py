"""The port's wire encoding held to the reference's corpus.

Every struct the port registers has an entry in
tests/fixtures/wire_corpus.json (the reference's pinned encodings of its
dencoder samples).  For each: the reference's sample carried across to
the port's classes by attribute encodes to the corpus bytes; the port
decodes the corpus bytes into its own classes and re-encodes them
unchanged; and each package decodes the other's bytes to an equal
value.  The port also frames messages as the reference does, and holds
the codec's guards (compat, truncation, depth, unknown names).
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest

from ceph_tpu.msg import encoding as ref_wire
from ceph_tpu.tools import dencoder
from ceph_tpu_torch.msg import encoding as wire
from ceph_tpu_torch.msg import messages
from ceph_tpu_torch.osd import pg_types
from ceph_tpu_torch.store import objectstore

wire.ensure_registered()
CORPUS = json.loads((pathlib.Path(__file__).parent / "fixtures" /
                     "wire_corpus.json").read_text())
PORT_NAMES = sorted(n for n in wire.registered_types() if n in CORPUS)


def value_eq(a, b) -> bool:
    """Equality by value, also for registered classes that keep the
    default identity `==` (OSDMap, CrushWrapper)."""
    if type(a) is not type(b):
        return False
    if dataclasses.is_dataclass(a):
        return all(value_eq(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a) if f.compare)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(value_eq, a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(value_eq(a[k], b[k])
                                            for k in a)
    if type(a).__eq__ is object.__eq__:
        return value_eq(vars(a), vars(b))
    return a == b


def carry(obj):
    """A reference value rebuilt from the port's registered classes:
    structs by wire name and field list, containers element by element."""
    if isinstance(obj, (list, tuple, set, frozenset)):
        return type(obj)(carry(v) for v in obj)
    if isinstance(obj, dict):
        return {carry(k): carry(v) for k, v in obj.items()}
    info = ref_wire._by_cls.get(type(obj))
    if info is None:
        return obj
    port = wire._by_name[info.name]
    return port.from_fields([carry(v) for v in info.to_fields(obj)])


def test_port_registers_the_data_plane_structs():
    assert set(wire.registered_types()) == {
        "EVersion", "PGShard", "PGLogEntry", "MissingItem", "ObjectId",
        "Transaction", "_Object", "PG", "Message", "ECSubWrite",
        "ECSubWriteReply", "ECSubRead", "ECSubReadReply",
        # the cluster's maps and messages
        "PGPool", "CrushBucket", "CrushRuleStep", "CrushRuleMask",
        "CrushRule", "ChooseArg", "CrushMap", "CrushWrapper",
        "Incremental", "OSDMap", "PGScan", "PGScanReply", "PGQuery",
        "PGNotify", "PGLogReq", "PGLogPush", "BackfillReserve",
        "PGRemove", "MOSDPGTemp", "PGPush", "OSDOp", "OSDOpReply",
        "MPGStats", "MMap", "MMonCommand", "MMonCommandAck",
        "MMonSubscribe", "MOSDBoot", "MOSDFailure", "MPaxosBegin",
        "MPaxosAccept", "MPaxosCommit", "MPaxosStoreSync", "Ping",
        "PingReply",
        # the cephx handshake
        "MAuthRequest", "MAuthReply",
        # the scrub
        "ScrubReserve", "ScrubMapRequest", "ScrubMapReply",
        # the replicated pools
        "RepOpWrite", "RepOpReply", "PGMissingReply", "PGPull",
        # the mgr's command proxy
        "MMgrCommand", "MMgrCommandReply",
        # the multi-mon quorum: election, leases, forwarding, catch-up
        "MMonElection", "MMonLease", "MMonLeaseAck", "MMonForward",
        "MPaxosSyncReq"}
    ref_schema = ref_wire.registered_schema()
    for name, schema in wire.registered_schema().items():
        assert schema == ref_schema[name], name


@pytest.mark.parametrize("name", PORT_NAMES)
def test_port_encodes_the_corpus_bytes(name):
    sample = dencoder.sample(name)
    assert ref_wire.encode(sample).hex() == CORPUS[name]
    ported = carry(sample)
    assert type(ported).__module__.startswith("ceph_tpu_torch.")
    assert wire.encode(ported).hex() == CORPUS[name]


@pytest.mark.parametrize("name", PORT_NAMES)
def test_each_package_decodes_the_others_bytes(name):
    blob = bytes.fromhex(CORPUS[name])
    got = wire.decode(blob)
    assert type(got) is wire._by_name[name].cls
    assert wire.encode(got) == blob
    assert value_eq(got, carry(dencoder.sample(name)))
    back = ref_wire.decode(wire.encode(got))
    assert value_eq(back, dencoder.sample(name))


def test_log_entry_omap_value_round_trips_between_packages():
    """The durable log's omap values: a PGLogEntry and its tail EVersion
    written by either package decode in the other."""
    e = pg_types.PGLogEntry(pg_types.MODIFY, "obj", pg_types.EVersion(3, 9),
                            pg_types.EVersion(3, 4), reqid="client.4:1")
    ref_e = ref_wire.decode(wire.encode(e))
    assert (ref_e.op, ref_e.soid, ref_e.version.epoch, ref_e.version.version,
            ref_e.prior_version.version, ref_e.reqid) == \
        ("modify", "obj", 3, 9, 4, "client.4:1")
    assert wire.decode(ref_wire.encode(ref_e)) == e


def test_message_frame_equals_the_references():
    txn = (objectstore.Transaction()
           .write("pg_1.0", objectstore.ObjectId("o", shard=2), 0, b"chunk")
           .setattrs("pg_1.0", objectstore.ObjectId("o", shard=2),
                     {"_": {"size": 5, "version": (1, 3)}}))
    msg = messages.ECSubWrite(pgid="1.0", tid=7, txn=txn, shard=2,
                              log_entries=[pg_types.PGLogEntry(
                                  "modify", "o", pg_types.EVersion(1, 3))],
                              oid="o", guard_version=(1, 3))
    frame = wire.encode_message(msg)
    ref_msg = ref_wire.decode_message(frame)
    assert type(ref_msg).__module__ == "ceph_tpu.msg.messages"
    assert ref_wire.encode_message(ref_msg) == frame
    assert wire.decode_message(frame) == msg
    bad = bytearray(frame)
    bad[12] ^= 1
    with pytest.raises(wire.WireError, match="crc"):
        wire.decode_message(bytes(bad))


@pytest.mark.parametrize("value", [
    None, True, False, 0, -1, 2 ** 70, -(2 ** 70), 1.5, "sé", b"\0\1",
    [1, (2, 3)], {3, 1, 2}, frozenset({"a"}), {"k": [b"v", None]},
    np.arange(6, dtype=np.uint16).reshape(2, 3)])
def test_primitives_equal_the_references(value):
    blob = wire.encode(value)
    assert blob == ref_wire.encode(value)
    got = wire.decode(blob)
    if isinstance(value, np.ndarray):
        assert got.dtype == value.dtype and (got == value).all()
    else:
        assert got == value


def test_guards_reject_like_the_reference():
    v = pg_types.EVersion(1, 2)
    blob = bytearray(wire.encode(v))
    blob[len(b"\x0d\x08EVersion") + 1] = 9       # compat beyond ours
    for codec in (wire, ref_wire):
        with pytest.raises(codec.WireError, match="requires decoder"):
            codec.decode(bytes(blob))
        with pytest.raises(codec.WireError, match="overruns"):
            codec.decode(wire.encode(v)[:-1])
        with pytest.raises(codec.WireError, match="truncated"):
            codec.decode(wire.encode(v)[:5])
        with pytest.raises(codec.WireError, match="unknown wire struct"):
            codec.decode(b"\x0d\x04Nope\x01\x01\x00\x00\x00\x01\x00")
    deep = [[]]
    for _ in range(wire.MAX_DEPTH + 2):
        deep = [deep]
    with pytest.raises(wire.WireError, match="too deep"):
        wire.encode(deep)
    with pytest.raises(wire.WireError, match="not wire-registered"):
        wire.encode(object())
