"""The bucket-index class `rgw` of the port (`ceph_tpu_torch.cls.rgw`)
held to the reference's (`ceph_tpu.cls.rgw`) at tolerance 0.

Every method of the class (`obj_store` in its three modes,
`obj_delete_marker` with and without its guards, `obj_delete_version`,
`obj_delete_plain`, `obj_sync_apply` over each of its conflict rules,
`dl_list`, `dl_trim` and `obj_trim_noncurrent`) is called on a
`MethodContext` of each package over one in-memory index object
(tests/test_torch_cls.py's `StubShard`), through scenarios of good and
bad inputs, each once without and once with a datalog (`log`).  Each
call's output, errno (or the exception's type) and queued mutations
must be equal, and so must the object's omap at the end.  `time.time`
in both modules is one clock that moves one millisecond per call from
the same instant (`now_str` stamps a plain delete that carries no
mtime); nothing is masked.  The helpers `now_str`, `parse_mtime`,
`dl_key`, `is_dl_key` and `is_tomb` are compared on their own.
"""
import json
import time

import pytest

import ceph_tpu.cls.rgw as ref_rgw
import ceph_tpu_torch.cls.rgw as port_rgw
from ceph_tpu import cls as ref_cls
from ceph_tpu.store import StoreError as RefStoreError
from ceph_tpu_torch import cls as port_cls
from ceph_tpu_torch.store import StoreError as PortStoreError
from test_torch_cls import StubShard
from test_torch_rgw import BASE_MS, Clock


def T(sec: float) -> str:
    """An index mtime `sec` seconds after BASE_MS."""
    t = BASE_MS / 1000.0 + sec
    return time.strftime(ref_rgw.MTIME_FMT, time.gmtime(t)) + \
        ".%03dZ" % int(round(t % 1 * 1000) % 1000)


def put(key, mode, vid, obj, sec, size=3, etag="e", **kw):
    return ("obj_store", dict(key=key, mode=mode, vid=vid, obj=obj,
                              mtime=T(sec), size=size, etag=etag,
                              plain_obj=f"b/{key}", **kw))


def sync(key, op, sec, vid=None, mode="plain", obj=None, etag="e",
         size=3):
    return ("obj_sync_apply", dict(key=key, op=op, vid=vid, mode=mode,
                                   obj=obj, mtime=T(sec), etag=etag,
                                   size=size))


SCENARIOS = {
    "plain": [
        put("k", "plain", "", "b/k#1", 1),
        put("k", "plain", "", "b/k#2", 2),
        put("k", "plain", "", "b/k#3", 2),          # same stamp: bumped
        put("k", "plain", "", "b/k#3", 3),          # same object
        ("obj_delete_plain", {"key": "k", "plain_obj": "b/k",
                              "if_mtime": "stale"}),
        ("obj_delete_plain", {"key": "k", "plain_obj": "b/k",
                              "mtime": T(4)}),
        ("obj_delete_plain", {"key": "k", "plain_obj": "b/k",
                              "mtime": T(5)}),       # a tombstone stays
        put("k", "plain", "", "b/k#4", 6),           # over the tombstone
        ("obj_delete_plain", {"key": "k", "plain_obj": "b/k"}),  # clock
        ("obj_delete_plain", {"key": "gone", "plain_obj": "b/gone"}),
        put("k2", "bogus", "", "b/k2#1", 7),
        ("obj_store", {"mode": "plain"}),           # no key
        ("obj_delete_version", {"key": "k", "vid": "null"}),
        ("obj_delete_version", {"key": "none", "vid": "x"}),
        ("obj_trim_noncurrent", {"key": "k2", "now": 1.0,
                                 "max_age_s": 0}),
    ],
    "versioned": [
        put("v", "plain", "", "b/v#0", 1),           # the null version
        put("v", "enabled", "a1", "b/v@a1", 2),
        put("v", "enabled", "a2", "b/v@a2", 3),
        put("v", "enabled", "a0", "b/v@a0", 3),      # same stamp: bumped
        put("v", "plain", "", "b/v#9", 4),           # ECANCELED
        ("obj_delete_marker", {"key": "v", "vid": "m1", "mtime": T(5),
                               "if_head_vid": "a1"}),
        ("obj_delete_marker", {"key": "v", "vid": "m1", "mtime": T(5),
                               "if_head_vid": "a0", "if_mtime": "x"}),
        ("obj_delete_marker", {"key": "v", "vid": "m1", "mtime": T(5),
                               "plain_obj": "b/v"}),
        ("obj_delete_plain", {"key": "v", "plain_obj": "b/v",
                              "mtime": T(6)}),       # ECANCELED
        ("obj_delete_version", {"key": "v", "vid": "m1",
                                "plain_obj": "b/v"}),
        ("obj_delete_version", {"key": "v", "vid": "zz"}),
        ("obj_delete_version", {"key": "v", "vid": "null",
                                "plain_obj": "b/v"}),
        put("v", "suspended", "null", "b/v@null.1", 7),
        put("v", "suspended", "null", "b/v@null.2", 8),
        ("obj_delete_marker", {"key": "v", "vid": "null", "mtime": T(9),
                               "replace_null": True, "plain_obj": "b/v"}),
        ("obj_trim_noncurrent", {"key": "v", "now": BASE_MS / 1000 + 60,
                                 "max_age_s": 55}),
        ("obj_trim_noncurrent", {"key": "v", "now": BASE_MS / 1000 + 60,
                                 "max_age_s": 0}),
        ("obj_trim_noncurrent", {"key": "absent", "now": 0,
                                 "max_age_s": 0}),
        ("obj_delete_version", {"key": "v", "vid": "null"}),
        ("obj_delete_version", {"key": "v", "vid": "a2"}),
    ],
    "sync_plain": [
        sync("p", "put", 5, obj="b/p#1", etag="e1"),
        sync("p", "put", 5, obj="b/p#1", etag="e1"),   # replay: skipped
        sync("p", "put", 4, obj="b/p#2", etag="e2"),   # older: skipped
        sync("p", "put", 5, obj="b/p#3", etag="e3"),   # tie, newer etag
        sync("p", "del", 4),                           # a local write won
        sync("p", "del", 5),                           # the tie: deleted
        sync("p", "del", 5),                           # replay
        sync("p", "put", 5, obj="b/p#4", etag="e9"),   # tie with the delete
        sync("p", "put", 6, obj="b/p#5", etag="e4"),   # after it
        sync("q", "del", 3),                           # absent: tombstone
        sync("p", "bogus", 7),
        put("vv", "enabled", "x1", "b/vv@x1", 1),
        sync("vv", "put", 9, obj="b/vv#1"),            # versioned: skipped
        sync("vv", "del", 9),                          # versioned: skipped
    ],
    "sync_versioned": [
        sync("s", "put", 2, vid="v1", mode="enabled", obj="b/s@v1"),
        sync("s", "put", 2, vid="v1", mode="enabled", obj="b/s@v1"),
        sync("s", "put", 1, vid="v0", mode="enabled", obj="b/s@v0"),
        sync("s", "dm", 3, vid="d1"),
        sync("s", "dm", 3, vid="d1"),                  # replay
        sync("s", "put", 4, vid="null", mode="suspended", obj="b/s@n1"),
        sync("s", "put", 4, vid="null", mode="suspended", obj="b/s@n1"),
        sync("s", "dm", 4, vid="null"),                # marker wins the tie
        sync("s", "put", 3, vid="null", mode="suspended", obj="b/s@n2"),
        sync("s", "put", 5, vid="null", mode="suspended", obj="b/s@n3"),
        sync("s", "rmver", 6, vid="v0"),
        sync("s", "rmver", 6, vid="v0"),               # absent: skipped
        sync("s", "rmver", 6, vid="d1"),
    ],
}


def run_scenario(pkg, store_error, steps, log):
    shard = StubShard(store_error)
    shard.apply([("create",)])
    out = []
    for method, indata in steps:
        ctx = pkg.MethodContext(shard, "idx")
        d = json.loads(json.dumps(indata))
        if log and method not in ("dl_list", "dl_trim"):
            d["log"] = {"trace": ["z1"]}
        try:
            _, fn = pkg.class_handler.resolve("rgw", method)
            res = ("ok", fn(ctx, d))
        except pkg.ClsError as e:
            res = ("err", e.errno_name)
        except Exception as e:
            res = ("raised", type(e).__name__)
        if res[0] == "ok":
            shard.apply(ctx.mutations)
        out.append((method, res, ctx.mutations))
    if log:
        for step in (("dl_list", {}), ("dl_list", {"marker": 2, "max": 3}),
                     ("dl_list", {"max": 0}), ("dl_trim", {"upto": 4}),
                     ("dl_list", {})):
            ctx = pkg.MethodContext(shard, "idx")
            _, fn = pkg.class_handler.resolve("rgw", step[0])
            res = fn(ctx, dict(step[1]))
            shard.apply(ctx.mutations)
            out.append((step[0], res, ctx.mutations))
    return out, dict(shard.obj[2])


@pytest.fixture()
def clocks(monkeypatch):
    """One clock per package, from the same instant."""
    monkeypatch.setattr(ref_rgw, "time", Clock())
    monkeypatch.setattr(port_rgw, "time", Clock())


@pytest.mark.parametrize("log", [False, True], ids=["nolog", "datalog"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equals_the_reference(clocks, name, log):
    ref = run_scenario(ref_cls, RefStoreError, SCENARIOS[name], log)
    port = run_scenario(port_cls, PortStoreError, SCENARIOS[name], log)
    assert port == ref
    assert any(res[0] == "ok" for _, res, _ in port[0][:len(
        SCENARIOS[name])])


def test_every_method_is_called():
    called = {m for steps in SCENARIOS.values() for m, _ in steps} | \
        {"dl_list", "dl_trim"}
    ref_cls.class_handler._load("rgw")
    port_cls.class_handler._load("rgw")
    want = {m for (c, m) in ref_cls.class_handler._methods if c == "rgw"}
    assert {m for (c, m) in port_cls.class_handler._methods
            if c == "rgw"} == want
    assert want <= called


def test_helpers_equal_the_reference(clocks):
    assert [port_rgw.now_str() for _ in range(5)] == \
        [ref_rgw.now_str() for _ in range(5)]
    for s in (T(0), T(86400.5), "2026-01-01T00:00:00Z", "junk", "",
              "2026-02-03T04:05:06.789Z"):
        assert port_rgw.parse_mtime(s) == ref_rgw.parse_mtime(s)
    for seq in (0, 1, 10 ** 15):
        assert port_rgw.dl_key(seq) == ref_rgw.dl_key(seq)
    for key in (".dl.0000000000000001", ".dlmeta", "k", ".upload.x"):
        assert port_rgw.is_dl_key(key) == ref_rgw.is_dl_key(key)
    for ent in (None, {}, {"tomb": True, "mtime": T(1)}, {"size": 1}):
        assert port_rgw.is_tomb(ent) == ref_rgw.is_tomb(ent)
    assert (port_rgw.DL_PREFIX, port_rgw.DL_META, port_rgw.MTIME_FMT) == \
        (ref_rgw.DL_PREFIX, ref_rgw.DL_META, ref_rgw.MTIME_FMT)
