"""Object classes on the port's cluster, held to the reference's.

Every case of tests/test_cls.py, tests/test_cls_log.py and
tests/test_cls_numops.py runs on one module-wide
`ceph_tpu.testing.MiniCluster(threaded=False)` and one
`ceph_tpu_torch.testing.MiniCluster(device="cpu", threaded=False)` (4
OSDs, a replicated pool `meta` and a `tpu` k=2 m=1 pool `ecm`, pg_num 8
each); each records what the client saw (every call's output or errno,
omap values) and what every acting replica holds, and the port's record
must equal the reference's at tolerance 0.  The racing adds of
`numops` go out as 32 `aio_exec` calls at once.  Then every method of
every ported class is called directly on a `MethodContext` of each
package over one in-memory object, through a scenario of good and bad
inputs, and each call's output, errno and queued mutations must be
equal; and the bucket-index class `rgw` runs `obj_store` through
`exec` on both clusters with equal output and replicas.
(tests/test_torch_cls_rgw.py holds every `rgw` method to the reference
over many more inputs.)
"""
import json

import pytest

from ceph_tpu import cls as ref_cls
from ceph_tpu.client import RadosError as RefRadosError
from ceph_tpu.testing import MiniCluster as RefCluster
from ceph_tpu_torch import cls as port_cls
from ceph_tpu_torch.client import RadosError as PortRadosError
from ceph_tpu_torch.testing import MiniCluster as PortCluster

ERRORS = (RefRadosError, PortRadosError)
KINDS = ("ref", "port")


class Side:
    """One package's cluster and client."""

    def __init__(self, kind):
        self.kind = kind
        self.c = RefCluster(n_osd=4, threaded=False) if kind == "ref" \
            else PortCluster(n_osd=4, threaded=False, device="cpu")
        self.c.pump()
        self.c.wait_all_up()
        self.r = self.c.rados()
        self.r.pool_create("meta", pg_num=8)
        self.r.mon_command({"prefix": "osd erasure-code-profile set",
                            "name": "k2m1",
                            "profile": {"plugin": "tpu", "k": "2",
                                        "m": "1",
                                        "crush-failure-domain": "osd"}})
        self.r.pool_create("ecm", pg_num=8, pool_type="erasure",
                           erasure_code_profile="k2m1")
        self.c.pump()
        self.io = self.r.open_ioctx("meta")

    def replicas(self, oid):
        """(osd, xattrs, omap) of every acting replica of `oid`."""
        pid = self.r.pool_lookup("meta")
        m = self.r.objecter.osdmap
        raw = m.object_locator_to_pg(oid, pid)
        pg = m.pools[pid].raw_pg_to_pg(raw)
        out = []
        for osd in m.pg_to_up_acting_osds(raw)[2]:
            shard = self.c.osds[osd].pgs[pg].shard
            out.append((osd, shard.getxattrs(oid), shard.omap_get(oid)))
        return out


@pytest.fixture(scope="module")
def sides():
    out = {kind: Side(kind) for kind in KINDS}
    yield out
    for s in out.values():
        s.c.shutdown()


def attempt(fn, *a, **kw):
    """("ok", value) or ("err", errno name)."""
    try:
        return ("ok", fn(*a, **kw))
    except ERRORS as e:
        return ("err", e.errno_name)


def run_both(sides, case):
    got = {kind: case(side) for kind, side in sides.items()}
    assert got["port"] == got["ref"]
    return got["port"]


def calls(side, steps):
    """Run (oid, cls, method, indata) steps; every output or errno."""
    return [attempt(side.io.exec, *step) for step in steps]


# ------------------------------------------------------------ test_cls

def test_unknown_class_or_method(sides):
    got = run_both(sides, lambda s: calls(s, [("o", "nope", "x", None),
                                              ("o", "lock", "nope", None)]))
    assert got == [("err", "EOPNOTSUPP")] * 2


def test_exec_rejected_on_ec_pool(sides):
    got = run_both(sides, lambda s: attempt(
        s.r.open_ioctx("ecm").exec, "o", "lock", "get_info",
        {"name": "l"}))
    assert got == ("err", "EOPNOTSUPP")


def c_lock_exclusive_lifecycle(side):
    oid = "locked"
    lk = {"name": "owner", "type": "exclusive"}
    out = calls(side, [
        (oid, "lock", "lock", dict(lk, client="client.A", cookie="c1",
                                   desc="test"))])
    out.append(side.io.stat(oid))
    out += calls(side, [
        (oid, "lock", "get_info", {"name": "owner"}),
        (oid, "lock", "lock", dict(lk, client="client.B", cookie="c2")),
        (oid, "lock", "lock", dict(lk, client="client.A", cookie="c1")),
        (oid, "lock", "unlock", {"name": "owner", "client": "client.A",
                                 "cookie": "c1"}),
        (oid, "lock", "lock", dict(lk, client="client.B", cookie="c2")),
        (oid, "lock", "unlock", {"name": "owner", "client": "client.A",
                                 "cookie": "c1"})])
    return out, side.replicas(oid)


def test_lock_exclusive_lifecycle(sides):
    out, _ = run_both(sides, c_lock_exclusive_lifecycle)
    assert out[1] == {"size": 0}
    info = out[2][1]
    assert info["type"] == "exclusive"
    assert [l["client"] for l in info["lockers"]] == ["client.A"]
    assert out[3] == ("err", "EBUSY") and out[4][0] == "ok"
    assert out[7] == ("err", "ENOENT")


def c_lock_shared_and_break(side):
    oid = "shlock"
    steps = [(oid, "lock", "lock", {"name": "s", "type": "shared",
                                    "client": cl, "cookie": "k"})
             for cl in ("client.A", "client.B")]
    steps += [
        (oid, "lock", "get_info", {"name": "s"}),
        (oid, "lock", "lock", {"name": "s", "type": "exclusive",
                               "client": "client.C", "cookie": "k"}),
        (oid, "lock", "break_lock", {"name": "s", "locker": "client.A",
                                     "cookie": "k"}),
        (oid, "lock", "get_info", {"name": "s"}),
        (oid, "lock", "list_locks", {})]
    return calls(side, steps), side.replicas(oid)


def test_lock_shared_and_break(sides):
    out, _ = run_both(sides, c_lock_shared_and_break)
    assert len(out[2][1]["lockers"]) == 2
    assert out[3] == ("err", "EBUSY")
    assert [l["client"] for l in out[5][1]["lockers"]] == ["client.B"]
    assert out[6] == ("ok", ["s"])


def c_refcount_lifecycle(side):
    oid = "refobj"
    side.io.write_full(oid, b"shared data")
    out = calls(side, [(oid, "refcount", "get", {"tag": "t1"}),
                       (oid, "refcount", "get", {"tag": "t2"}),
                       (oid, "refcount", "read", {}),
                       (oid, "refcount", "put", {"tag": "t1"}),
                       (oid, "refcount", "read", {}),
                       (oid, "refcount", "put", {"tag": "t2"})])
    return out, attempt(side.io.read, oid)


def test_refcount_lifecycle(sides):
    out, last = run_both(sides, c_refcount_lifecycle)
    assert out[2][1]["refs"] == ["t1", "t2"]
    assert out[4][1]["refs"] == ["t2"]
    assert last == ("err", "ENOENT")


def c_version_gating(side):
    oid = "ver"
    side.io.write_full(oid, b"v")
    return calls(side, [
        (oid, "version", "set", {"ver": 5}),
        (oid, "version", "read", {}),
        (oid, "version", "inc", {}),
        (oid, "version", "read", {}),
        (oid, "version", "check", {"ver": 6, "cond": "eq"}),
        (oid, "version", "check", {"ver": 7, "cond": "eq"}),
        (oid, "version", "inc", {"ver": 6, "cond": "eq"}),
        (oid, "version", "inc", {"ver": 6, "cond": "eq"}),
        (oid, "version", "read", {})])


def test_version_gating(sides):
    out = run_both(sides, c_version_gating)
    assert out[1][1]["ver"] == 5 and out[3][1]["ver"] == 6
    assert out[5] == ("err", "ECANCELED") and out[7] == ("err", "ECANCELED")
    assert out[8][1]["ver"] == 7


def c_cls_mutations_replicated(side):
    oid = "replock"
    side.io.exec(oid, "lock", "lock", {"name": "n", "type": "exclusive",
                                       "client": "x", "cookie": ""})
    return [(osd, list(json.loads(attrs["lock.n"])["lockers"]))
            for osd, attrs, _ in side.replicas(oid)]


def test_cls_mutations_are_atomic_and_replicated(sides):
    got = run_both(sides, c_cls_mutations_replicated)
    assert len(got) == 3 and all(l == ["x/"] for _, l in got)


# -------------------------------------------------------- test_cls_log

def log_add(oid, ts, name, data="", section="s"):
    return (oid, "log", "add", {"entries": [
        {"timestamp": ts, "section": section, "name": name,
         "data": data}]})


def names(res):
    return [e["name"] for e in res[1]["entries"]]


def test_add_list_time_order(sides):
    def case(side):
        oid = "log1"
        out = calls(side, [log_add(oid, 30.0, "c"), log_add(oid, 10.0, "a"),
                           log_add(oid, 20.0, "b"),
                           (oid, "log", "list", {})])
        return out, side.io.stat(oid), side.replicas(oid)
    out, stat, _ = run_both(sides, case)
    assert names(out[3]) == ["a", "b", "c"] and not out[3][1]["truncated"]
    assert stat["size"] == 0


def test_same_timestamp_entries_all_kept(sides):
    def case(side):
        oid = "log-dup"
        return calls(side, [
            (oid, "log", "add", {"entries": [
                {"timestamp": 5.0, "name": f"e{i}"} for i in range(4)]}),
            (oid, "log", "list", {}), (oid, "log", "info", {})])
    out = run_both(sides, case)
    assert names(out[1]) == ["e0", "e1", "e2", "e3"]
    assert out[2][1]["counter"] == 4 and out[2][1]["entries"] == 4


def test_list_window_and_marker_pagination(sides):
    def case(side):
        oid = "log2"
        out = calls(side, [log_add(oid, float(i), f"n{i}")
                           for i in range(10)])
        out += calls(side, [
            (oid, "log", "list", {"from_time": 3.0, "to_time": 7.0}),
            (oid, "log", "list", {"max_entries": 4})])
        out += calls(side, [(oid, "log", "list",
                             {"marker": out[-1][1]["marker"]})])
        return out[10:]
    window, page1, page2 = run_both(sides, case)
    assert names(window) == ["n3", "n4", "n5", "n6"]
    assert page1[1]["truncated"] and len(page1[1]["entries"]) == 4
    assert names(page2) == [f"n{i}" for i in range(4, 10)]
    assert not page2[1]["truncated"] and page2[1]["marker"] == ""


def test_trim_by_time_and_marker(sides):
    def case(side):
        oid = "log3"
        calls(side, [log_add(oid, float(i), f"n{i}") for i in range(6)])
        out = calls(side, [(oid, "log", "trim", {"to_time": 3.0}),
                           (oid, "log", "list", {})])
        mark = out[1][1]["entries"][1]["id"]
        out += calls(side, [(oid, "log", "trim", {"to_marker": mark}),
                            (oid, "log", "list", {}),
                            (oid, "log", "trim", {"to_marker": mark})])
        return out, side.replicas(oid)
    out, _ = run_both(sides, case)
    assert out[0][1]["trimmed"] == 3 and names(out[1]) == ["n3", "n4", "n5"]
    assert out[2][1]["trimmed"] == 2 and names(out[3]) == ["n5"]
    assert out[4][1]["trimmed"] == 0


def test_subsecond_rollover_keeps_time_order(sides):
    def case(side):
        oid = "log-round"
        return calls(side, [log_add(oid, 1.9999996, "almost2"),
                            log_add(oid, 1.2, "early"),
                            (oid, "log", "list", {}),
                            (oid, "log", "trim", {"to_time": 1.5}),
                            (oid, "log", "list", {})])
    out = run_both(sides, case)
    assert names(out[2]) == ["early", "almost2"]
    assert out[3][1]["trimmed"] == 1 and names(out[4]) == ["almost2"]


def test_bad_input_rejected(sides):
    got = run_both(sides, lambda s: calls(s, [
        ("log4", "log", "add", {"entries": []}),
        ("log4", "log", "add", {"entries": [{"name": "no-stamp"}]}),
        ("log4", "log", "trim", {}),
        ("log4", "log", "list", {"max_entries": 0})]))
    assert got == [("err", "EINVAL")] * 4


def test_info_and_trim_survive_restart_counter(sides):
    def case(side):
        oid = "log5"
        return calls(side, [log_add(oid, 1.0, "a"), log_add(oid, 1.0, "b"),
                            (oid, "log", "trim", {"to_time": 2.0}),
                            log_add(oid, 1.0, "c"),
                            (oid, "log", "list", {}),
                            (oid, "log", "info", {})])
    out = run_both(sides, case)
    assert names(out[4]) == ["c"] and out[5][1]["counter"] == 3


# ----------------------------------------------------- test_cls_numops

def omap(side, oid):
    return dict(side.io.get_omap_vals(oid)[0])


def test_add_creates_counter_and_accumulates(sides):
    def case(side):
        oid = "n-acc"
        return calls(side, [(oid, "numops", "add", {"key": "hits",
                                                    "value": v})
                            for v in (3, 4)]), omap(side, oid)
    out, vals = run_both(sides, case)
    assert out[0] == ("ok", {"key": "hits", "value": 3})
    assert out[1][1]["value"] == 7 and vals["hits"] == b"7"


def test_sub_mul_div_roundtrip(sides):
    def case(side):
        oid = "n-ops"
        out = calls(side, [(oid, "numops", "add", {"key": "k", "value": 10}),
                           (oid, "numops", "sub", {"key": "k", "value": 4}),
                           (oid, "numops", "mul", {"key": "k", "value": 3}),
                           (oid, "numops", "div", {"key": "k", "value": 4})])
        mid = omap(side, oid)
        out += calls(side, [(oid, "numops", "mul", {"key": "k",
                                                    "value": 2})])
        return out, mid, omap(side, oid)
    out, mid, end = run_both(sides, case)
    assert [v[1]["value"] for v in out] == [10, 6, 18, 4.5, 9]
    assert mid["k"] == b"4.5" and end["k"] == b"9"


def test_keys_are_independent(sides):
    def case(side):
        oid = "n-multi"
        calls(side, [(oid, "numops", "add", {"key": k, "value": v})
                     for k, v in (("a", 1), ("b", 2), ("a", 1))])
        return omap(side, oid)
    vals = run_both(sides, case)
    assert vals["a"] == b"2" and vals["b"] == b"2"


def test_missing_key_counts_as_zero(sides):
    out = run_both(sides, lambda s: calls(s, [
        ("n-zero", "numops", "sub", {"key": "fresh", "value": 5}),
        ("n-zero", "numops", "mul", {"key": "fresh2", "value": 5})]))
    assert out[0][1]["value"] == -5 and out[1][1]["value"] == 0


def test_non_numeric_input_is_einval(sides):
    def case(side):
        oid = "n-badin"
        steps = [(oid, "numops", "add", {"key": "k", "value": bad})
                 for bad in ("three", None, [1], True)]
        steps += [(oid, "numops", "add", {"value": 1}),
                  (oid, "numops", "add", {"key": "k"})]
        return calls(side, steps), attempt(side.io.stat, oid)
    out, stat = run_both(sides, case)
    assert out == [("err", "EINVAL")] * 6 and stat == ("err", "ENOENT")


def test_non_numeric_stored_value_is_einval_not_clobbered(sides):
    def case(side):
        oid = "n-badstore"
        side.io.set_omap(oid, {"blob": b"not a number"})
        return calls(side, [(oid, "numops", "add", {"key": "blob",
                                                    "value": 1})]), \
            omap(side, oid)
    out, vals = run_both(sides, case)
    assert out == [("err", "EINVAL")] and vals["blob"] == b"not a number"


def test_div_by_zero_is_einval_and_atomic(sides):
    def case(side):
        oid = "n-div0"
        return calls(side, [(oid, "numops", "add", {"key": "k", "value": 9}),
                            (oid, "numops", "div", {"key": "k",
                                                    "value": 0})]), \
            omap(side, oid)
    out, vals = run_both(sides, case)
    assert out[1] == ("err", "EINVAL") and vals["k"] == b"9"


def test_concurrent_adds_all_land(sides):
    """32 adds in flight at once are serialized inside the OSD: none is
    lost to a read-modify-write race."""
    def case(side):
        oid = "n-race"
        futs = [side.io.aio_exec(oid, "numops", "add",
                                 {"key": "c", "value": 1})
                for _ in range(32)]
        outs = sorted(side.io._wait(f).attrs["out"]["value"] for f in futs)
        return outs, omap(side, oid), side.replicas(oid)
    outs, vals, reps = run_both(sides, case)
    assert outs == list(range(1, 33)) and vals["c"] == b"32"
    assert all(o["c"] == b"32" for _, _, o in reps)


# ------------------------------------------------ methods, one by one

class StubShard:
    """One object in memory, behind the reads a MethodContext makes;
    `apply` commits a context's queued mutations as the OSD would."""

    def __init__(self, store_error):
        self.err = store_error
        self.obj = None         # (data, xattrs, omap, header) or None

    def exists(self, oid):
        return self.obj is not None

    def object_size(self, oid):
        return len(self._get()[0])

    def _get(self):
        if self.obj is None:
            raise self.err("ENOENT", "stub")
        return self.obj

    def read(self, oid, off, length):
        data = self._get()[0]
        return bytes(data[off:off + length] if length else data[off:])

    def getxattr(self, oid, name):
        attrs = self._get()[1]
        if name not in attrs:
            raise self.err("ENODATA", name)
        return attrs[name]

    def getxattrs(self, oid):
        return dict(self._get()[1])

    def omap_get(self, oid):
        return dict(self._get()[2])

    def omap_get_header(self, oid):
        return self._get()[3]

    def apply(self, mutations):
        for m in mutations:
            if m[0] == "delete":
                self.obj = None
                continue
            if self.obj is None:
                self.obj = [bytearray(), {}, {}, b""]
            data, attrs, om, _ = self.obj
            if m[0] == "write":
                off, buf = m[1], m[2]
                data[len(data):] = bytes(max(0, off - len(data)))
                data[off:off + len(buf)] = buf
            elif m[0] == "writefull":
                data[:] = m[1]
            elif m[0] == "truncate":
                del data[m[1]:]
            elif m[0] == "setxattrs":
                attrs.update(m[1])
            elif m[0] == "rmxattr":
                attrs.pop(m[1], None)
            elif m[0] == "omap_setkeys":
                om.update(m[1])
            elif m[0] == "omap_rmkeys":
                for k in m[1]:
                    om.pop(k, None)
            elif m[0] == "omap_clear":
                om.clear()
            elif m[0] == "omap_setheader":
                self.obj[3] = m[1]


LOCK = {"name": "l", "type": "exclusive", "client": "c.A", "cookie": "k"}
SCENARIOS = {
    "lock": [("lock", LOCK), ("lock", dict(LOCK, client="c.B")),
             ("lock", dict(LOCK, type="bogus")), ("get_info", {"name": "l"}),
             ("list_locks", {}), ("unlock", {"name": "l", "client": "c.B",
                                             "cookie": "k"}),
             ("break_lock", {"name": "l", "locker": "c.A", "cookie": "k"}),
             ("unlock", {"name": "l", "client": "c.A", "cookie": "k"}),
             ("get_info", {"name": "none"}), ("lock", {})],
    "refcount": [("read", {}), ("get", {"tag": "a"}), ("get", {"tag": "a"}),
                 ("get", {"tag": "b"}), ("set", {"refs": ["x", "y"]}),
                 ("read", {}), ("put", {"tag": "nope"}),
                 ("put", {"tag": "x"}), ("put", {"tag": "y"}),
                 ("get", {})],
    "version": [("read", {}), ("inc", {}), ("set", {"ver": 9}),
                ("check", {"ver": 9, "cond": "eq"}),
                ("check", {"ver": 3, "cond": "gt"}),
                ("check", {"ver": 10, "cond": "lt"}),
                ("inc", {"ver": 1, "cond": "eq"}), ("read", {}),
                ("set", {})],
    "log": [("info", {}), ("add", {"entries": [
        {"timestamp": float(t), "name": f"e{t}", "section": "s",
         "data": {"t": t}} for t in (5, 1, 3, 1)]}),
        ("list", {}), ("list", {"max_entries": 2}),
        ("list", {"from_time": 2.0, "to_time": 4.0}),
        ("trim", {"to_time": 2.0}), ("info", {}),
        ("trim", {"from_time": 4.0, "to_time": 9.0}), ("list", {}),
        ("add", {"entries": [{"name": "x"}]}), ("trim", {})],
    "numops": [("add", {"key": "k", "value": 2}),
               ("mul", {"key": "k", "value": 1.5}),
               ("sub", {"key": "k", "value": 10}),
               ("div", {"key": "k", "value": 4}),
               ("div", {"key": "k", "value": 0}),
               ("add", {"key": "k", "value": "x"}), ("add", {"value": 1})],
    "queue": [("list", {}), (None, "create"),
              ("enqueue", {"entries": ["a", "b", "c"]}),
              ("list", {"max": 2}), ("remove", {"upto": 1}),
              ("list", {}), ("enqueue", {"entries": [{"d": 1}]}),
              ("list", {"start": 2}), ("remove", {"upto": 9}),
              ("list", {}), ("remove", {})],
    "rgw": [(None, "create"),
            ("obj_store", {"key": "k", "mode": "enabled", "vid": "v1",
                           "obj": "b/k@v1", "size": 2, "etag": "e",
                           "mtime": "2026-01-01T00:00:01.000Z"}),
            ("obj_store", {"key": "p", "obj": "b/p#1", "size": 1,
                           "etag": "f", "mtime": "2026-01-01T00:00:02.000Z",
                           "log": {"trace": ["z"]}}),
            ("obj_delete_marker", {"key": "k", "vid": "m1",
                                   "mtime": "2026-01-01T00:00:03.000Z"}),
            ("obj_delete_version", {"key": "k", "vid": "m1"}),
            ("obj_delete_version", {"key": "k", "vid": "nope"}),
            ("obj_delete_plain", {"key": "p",
                                  "mtime": "2026-01-01T00:00:04.000Z"}),
            ("obj_sync_apply", {"key": "p", "op": "put", "mode": "plain",
                                "obj": "b/p#2", "size": 1, "etag": "g",
                                "mtime": "2026-01-01T00:00:05.000Z"}),
            ("obj_sync_apply", {"key": "p", "op": "bogus", "mtime": ""}),
            ("obj_trim_noncurrent", {"key": "k", "now": 1.8e9,
                                     "max_age_s": 0}),
            ("dl_list", {"marker": 0}), ("dl_trim", {"upto": 1}),
            ("dl_list", {}), ("obj_store", {})],
}


def run_scenario(pkg, store_error, cls_name):
    shard = StubShard(store_error)
    out = []
    for method, indata in SCENARIOS[cls_name]:
        if method is None:      # the queue's object exists beforehand
            shard.apply([(indata,)])
            continue
        ctx = pkg.MethodContext(shard, "obj")
        try:
            _, fn = pkg.class_handler.resolve(cls_name, method)
            res = ("ok", fn(ctx, json.loads(json.dumps(indata))))
        except pkg.ClsError as e:
            res = ("err", e.errno_name)
        except Exception as e:
            res = ("raised", type(e).__name__)
        if res[0] == "ok":
            shard.apply(ctx.mutations)
        out.append((method, res, ctx.mutations))
    return out


@pytest.mark.parametrize("cls_name", sorted(SCENARIOS))
def test_methods_equal_on_a_method_context(cls_name):
    from ceph_tpu.store import StoreError as RefStoreError
    from ceph_tpu_torch.store import StoreError as PortStoreError
    ref = run_scenario(ref_cls, RefStoreError, cls_name)
    port = run_scenario(port_cls, PortStoreError, cls_name)
    assert port == ref
    assert any(res[0] == "ok" for _, res, _ in port)
    # every registered method of the class was called
    methods = {m for (c, m) in ref_cls.class_handler._methods
               if c == cls_name}
    assert methods <= {m for m, _ in SCENARIOS[cls_name] if m}
    assert {m for (c, m) in port_cls.class_handler._methods
            if c == cls_name} == methods


def c_rgw_obj_store(side):
    steps = [("idx", "rgw", "obj_store",
              {"key": "k", "mode": mode, "vid": vid, "obj": f"b/k{n}",
               "size": n, "etag": f"e{n}",
               "mtime": f"2026-01-01T00:00:0{n}.000Z"})
             for n, (mode, vid) in enumerate([("plain", ""),
                                              ("plain", ""),
                                              ("enabled", "v2")])]
    side.io.create("idx")
    out = calls(side, steps)
    out += calls(side, [("idx", "rgw", "bucket_list", {})])
    out.append(side.io.get_omap_vals("idx")[0])
    out.append(side.replicas("idx"))
    return out


def test_rgw_class_runs_obj_store_like_the_reference(sides):
    """`rgw` resolves to the port's class, and `obj_store` (plain, an
    overwrite, then a version) runs through `exec` equal to the
    reference: outputs, omap and every replica; a method the class lacks
    is EOPNOTSUPP."""
    _, fn = port_cls.class_handler.resolve("rgw", "obj_store")
    assert fn.__module__ == "ceph_tpu_torch.cls.rgw"
    got = run_both(sides, c_rgw_obj_store)
    assert got[:4] == [("ok", {"vid": None, "removed": []}),
                       ("ok", {"vid": None, "removed": ["b/k0"]}),
                       ("ok", {"vid": "v2", "removed": []}),
                       ("err", "EOPNOTSUPP")]
