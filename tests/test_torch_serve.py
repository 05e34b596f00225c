"""The port's paged artifact store (`ceph_tpu_torch.serve`) held to the
reference's (`ceph_tpu.serve`) at tolerance 0.

Every case of tests/test_serve.py runs on each package's module-scoped
cluster: `MiniCluster(n_osd=5, threaded=False)` with a `tpu` k=2 m=1
erasure pool of pg_num 8 (the port's on `device="cpu"`, where its EC
reads and degraded decodes run K1's plain version).  The same seeded
artifacts go through each package's `ArtifactStore`, and the test
compares what every call returned, the manifest bytes, the `stats` of
every handle, the `rados serve` verbs' output, and, after each case,
the name and sha256 of every object shard in every OSD's store.  The
reference's own assertions run on both.  The port's librados has no
object listing, so the epoch-flip case checks the old epoch's objects
gone with `stat` (ENOENT) in both packages, and the store walk shows
them gone.  The degraded-read case is last, as in the reference: it
kills an OSD of each cluster.
"""
import hashlib
import io as _io
import json
import random

import pytest

import ceph_tpu.client as ref_client
import ceph_tpu.osdc.striper as ref_striper
import ceph_tpu.serve as ref_serve
import ceph_tpu.serve.manifest as ref_manifest
import ceph_tpu.tools.rados_cli as ref_cli
import ceph_tpu_torch.client as port_client
import ceph_tpu_torch.osdc.striper as port_striper
import ceph_tpu_torch.serve as port_serve
import ceph_tpu_torch.serve.manifest as port_manifest
import ceph_tpu_torch.tools.rados_cli as port_cli
from ceph_tpu.testing import MiniCluster as RefCluster
from ceph_tpu_torch.testing import MiniCluster as PortCluster

KINDS = ("ref", "port")
SERVE = {"ref": ref_serve, "port": port_serve}
MANIFEST = {"ref": ref_manifest, "port": port_manifest}
STRIPER = {"ref": ref_striper, "port": port_striper}
CLI = {"ref": ref_cli, "port": port_cli}
RADOS_ERROR = (ref_client.RadosError, port_client.RadosError)
PAGE = 4096


def layout(kind):
    return STRIPER[kind].StripeLayout(stripe_unit=4 * PAGE, stripe_count=2,
                                      object_size=16 * PAGE)


def both(fn, *args):
    """Run `fn(kind, *args)` for each package; the results must be
    equal, and are returned."""
    out = {kind: fn(kind, *args) for kind in KINDS}
    assert out["port"] == out["ref"]
    return out["port"]


# ------------------------------------------------- manifest (pure)

def paginate_and_shard_from_pages(kind):
    m = MANIFEST[kind]
    assert m.paginate(b"", PAGE) == (1, 0, {0: 0})
    assert m.paginate(b"x" * PAGE, PAGE) == (1, PAGE, {})
    assert m.paginate(b"x" * (PAGE + 7), PAGE) == (2, PAGE + 7, {1: 7})
    si = m.shard_from_pages([b"a" * PAGE, b"b" * 9, b""], PAGE)
    assert (si.n_pages, si.size) == (3, PAGE + 9)
    assert si.vlens == {1: 9, 2: 0}
    with pytest.raises(ValueError):
        m.shard_from_pages([b"x" * (PAGE + 1)], PAGE)
    return si.to_json()


def test_paginate_and_shard_from_pages():
    both(paginate_and_shard_from_pages)


def manifest_roundtrip(kind):
    mod = MANIFEST[kind]
    m = mod.ArtifactManifest(
        name="ck", epoch=3, page_size=PAGE, layout=layout(kind),
        shards={"s0": mod.ShardInfo(n_pages=5, size=4 * PAGE + 11,
                                    vlens={4: 11}),
                "kv": mod.ShardInfo(n_pages=2, size=PAGE, vlens={1: 0})})
    raw = m.to_json()
    assert mod.ArtifactManifest.from_json(raw) == m
    d = json.loads(raw)
    d["version"] = 99
    with pytest.raises(ValueError):
        mod.ArtifactManifest.from_json(json.dumps(d).encode())
    return raw


def test_manifest_json_roundtrip_and_versioning():
    raw = both(manifest_roundtrip)
    # each package parses the other's bytes
    assert port_manifest.ArtifactManifest.from_json(raw).to_json() == raw


def page_extents(kind):
    mod = MANIFEST[kind]
    m = mod.ArtifactManifest(
        name="ck", epoch=1, page_size=PAGE, layout=layout(kind),
        shards={"s": mod.ShardInfo(n_pages=3, size=2 * PAGE + 5,
                                   vlens={1: 0, 2: 5})})
    full = m.page_extents("s", 0)
    assert sum(e.length for e in full) == PAGE
    assert m.page_extents("s", 1) == []
    tail = m.page_extents("s", 2)
    assert sum(e.length for e in tail) == 5
    for bad in (3, -1):
        with pytest.raises(IndexError):
            m.page_extents("s", bad)
    return [(e.objectno, e.offset, e.length, e.logical_offset)
            for e in full + tail] + [m.data_oids()]


def test_manifest_page_extents_ragged_and_bounds():
    both(page_extents)


# -------------------------------------------------- cluster-backed

def _make(kind):
    c = RefCluster(n_osd=5, threaded=False) if kind == "ref" else \
        PortCluster(n_osd=5, threaded=False, device="cpu")
    c.pump()
    c.wait_all_up()
    r = c.rados()
    r.mon_command({"prefix": "osd erasure-code-profile set",
                   "name": "serve_t",
                   "profile": {"plugin": "tpu", "k": "2", "m": "1",
                               "crush-failure-domain": "host"}})
    r.pool_create("sv", pg_num=8, pool_type="erasure",
                  erasure_code_profile="serve_t")
    c.pump()
    return c, r


@pytest.fixture(scope="module")
def env():
    made = {}
    try:
        for kind in KINDS:
            c, r = _make(kind)
            made[kind] = {"c": c, "r": r, "io": r.open_ioctx("sv"),
                          "store": SERVE[kind].ArtifactStore(
                              r.open_ioctx("sv"), page_size=PAGE,
                              layout=layout(kind))}
        yield made
    finally:
        for e in made.values():
            e["c"].shutdown()


@pytest.fixture(autouse=True)
def stores_equal(request):
    """After each cluster-backed case: every object shard on every OSD
    has the same name and bytes in both clusters."""
    yield
    if "env" in request.fixturenames:
        e = request.getfixturevalue("env")
        assert stored("port", e) == stored("ref", e)


def stored(kind, e) -> dict:
    out = {}
    for osd, st in sorted(e[kind]["c"]._stores.items()):
        for cid in st.list_collections():
            for o in st.collection_list(cid):
                if o.name == "pgmeta":
                    continue
                out[(osd, cid, o.name, o.shard)] = hashlib.sha256(
                    st.read(cid, o, 0, 0)).hexdigest()
    return out


def manifest_bytes(kind, e, name) -> bytes:
    return e[kind]["io"].read(MANIFEST[kind].manifest_oid(name))


def put_get_both_policies(kind, e):
    store = e[kind]["store"]
    rng = random.Random(7)
    s0 = rng.randbytes(9 * PAGE + 321)
    s1 = rng.randbytes(PAGE)
    m = store.put("ckpt", shards={"s0": s0, "s1": s1, "s2": b""})
    assert m.epoch == 1 and m.shards["s0"].vlens == {9: 321}
    out = [manifest_bytes(kind, e, "ckpt")]
    for policy in ("checkpoint", "kvcache"):
        h = store.open("ckpt", policy=policy)
        assert h.read_shard("s0", chunk=3 * PAGE) == s0
        assert h.read_shard("s1") == s1
        assert h.read_shard("s2") == b""
        assert h.read("s0", 3 * PAGE - 5, 4 * PAGE) == \
            s0[3 * PAGE - 5:7 * PAGE - 5]
        out.append(dict(h.stats))
        h.close()
    h_ck = store.open("ckpt", policy="checkpoint")
    h_kv = store.open("ckpt", policy="kvcache")
    for h in (h_ck, h_kv):
        h.read_shard("s0", chunk=PAGE)
        out.append(dict(h.stats))
    assert h_ck.stats["readahead_pages"] > 0
    assert h_kv.stats["readahead_pages"] == 0
    h_ck.close()
    h_kv.close()
    return out


def test_put_get_byte_identical_both_policies(env):
    both(put_get_both_policies, env)


def put_validates_inputs(kind, e):
    store = e[kind]["store"]
    with pytest.raises(ValueError):
        store.put("nothing")
    with pytest.raises(ValueError):
        store.put("dup", shards={"a": b"x"}, pages={"a": [b"y"]})


def test_put_validates_inputs(env):
    both(put_validates_inputs, env)


def fetch_batched_equals_loop(kind, e):
    store = e[kind]["store"]
    rng = random.Random(23)
    kv = [rng.randbytes(rng.choice([PAGE, PAGE, 500, 0]))
          for _ in range(40)]
    m = store.put("kvpool", pages={"kv": kv})
    ids = [rng.randrange(len(kv)) for _ in range(25)] + [0, 0]
    want = [kv[i] for i in ids]
    assert store.fetch_pages("kvpool", "kv", ids) == want
    assert store.fetch_pages("kvpool", "kv", ids, batched=False) == want
    assert store.fetch_pages("kvpool", "kv", [], manifest=m) == []
    with pytest.raises(KeyError):
        store.fetch_pages("kvpool", "nope", [0])
    return [manifest_bytes(kind, e, "kvpool"), ids]


def test_fetch_pages_batched_equals_loop(env):
    both(fetch_batched_equals_loop, env)


def interior_ragged_refuses_streaming(kind, e):
    store = e[kind]["store"]
    store.put("ragged", pages={"kv": [b"a" * PAGE, b"b" * 5,
                                      b"c" * PAGE]})
    h = store.open("ragged", policy="kvcache")
    with pytest.raises(ValueError):
        h.read_shard("kv")
    assert h.get_pages("kv", [1, 0, 2]) == \
        [b"b" * 5, b"a" * PAGE, b"c" * PAGE]
    stats = dict(h.stats)
    h.close()
    return stats


def test_interior_ragged_shard_refuses_streaming(env):
    both(interior_ragged_refuses_streaming, env)


def pin_unpin_residency(kind, e):
    store = e[kind]["store"]
    rng = random.Random(31)
    kv = [rng.randbytes(PAGE) for _ in range(16)]
    store.put("pins", pages={"kv": kv})
    h = store.open("pins", policy="kvcache")
    ids = [3, 7, 3, 11]
    assert h.get_pages("kv", ids, pin=True) == [kv[i] for i in ids]
    pinned = h.cacher.pinned_bytes()
    assert pinned > 0
    misses = h.stats["miss"]
    assert h.get_pages("kv", ids) == [kv[i] for i in ids]
    assert h.stats["miss"] == misses
    h.unpin_pages("kv", ids)
    assert h.cacher.pinned_bytes() == 0
    with pytest.raises(ValueError):
        h.unpin_pages("kv", ids)
    stats = dict(h.stats)
    h.close()
    return pinned, stats


def test_get_pages_pin_unpin_residency(env):
    both(pin_unpin_residency, env)


def gone(kind, e, oid) -> bool:
    try:
        e[kind]["io"].stat(oid)
    except RADOS_ERROR as err:
        return err.errno_name == "ENOENT"
    return False


def epoch_flip(kind, e):
    store = e[kind]["store"]
    m1 = store.put("flip", shards={"w": b"v1" * PAGE})
    old_oids = m1.data_oids()
    assert old_oids and all(o.startswith("flip.e1.") for o in old_oids)
    m2 = store.put("flip", shards={"w": b"v2" * (2 * PAGE)})
    assert m2.epoch == 2
    h = store.open("flip")
    assert h.read_shard("w") == b"v2" * (2 * PAGE)
    h.close()
    assert all(gone(kind, e, o) for o in old_oids)
    assert not gone(kind, e, MANIFEST[kind].manifest_oid("flip"))
    stat = store.stat("flip")
    assert stat["epoch"] == 2
    new_oids = m2.data_oids()
    removed = store.delete("flip")
    assert gone(kind, e, MANIFEST[kind].manifest_oid("flip"))
    assert all(gone(kind, e, o) for o in new_oids)
    return old_oids, new_oids, stat, removed


def test_epoch_flip_replaces_objects_atomically(env):
    both(epoch_flip, env)


def stat_raggedness(kind, e):
    store = e[kind]["store"]
    store.put("st", shards={"a": b"z" * (2 * PAGE + 9)},
              pages={"kv": [b"q" * 100]})
    st = store.stat("st")
    assert st["epoch"] == 1 and st["page_size"] == PAGE
    assert st["shards"]["a"] == {"size": 2 * PAGE + 9, "n_pages": 3,
                                 "ragged_pages": 1}
    assert st["shards"]["kv"]["ragged_pages"] == 1
    assert st["bytes"] == 2 * PAGE + 9 + 100
    return st, manifest_bytes(kind, e, "st")


def test_stat_reports_shards_and_raggedness(env):
    both(stat_raggedness, env)


def cli_serve_verbs(kind, e, tmp_path):
    cli, r = CLI[kind], e[kind]["r"]
    rng = random.Random(41)
    payload = rng.randbytes(3 * PAGE + 17)
    src = tmp_path / f"{kind}.ckpt.bin"
    src.write_bytes(payload)
    outs = []

    def run(argv):
        out = _io.StringIO()
        rc = cli.main(argv, rados=r, out=out)
        outs.append((rc, out.getvalue()))
        return rc, out.getvalue()
    rc, text = run(["serve", "put", "sv", "cli-art", str(src),
                    "--page-size", str(PAGE)])
    assert rc == 0 and "epoch 1" in text
    dst = tmp_path / f"{kind}.back.bin"
    rc, _ = run(["serve", "get", "sv", "cli-art", str(dst),
                 "--page-size", str(PAGE), "--policy", "kvcache"])
    assert rc == 0 and dst.read_bytes() == payload
    rc, text = run(["serve", "stat", "sv", "cli-art",
                    "--page-size", str(PAGE)])
    assert rc == 0
    assert json.loads(text)["shards"]["shard0"]["size"] == len(payload)
    rc, text = run(["serve", "pages", "sv", "cli-art", "shard0", "0,3",
                    "--page-size", str(PAGE)])
    lines = text.splitlines()
    assert rc == 0 and lines[0].startswith(f"page 0: {PAGE} B sha256 ")
    assert lines[1].startswith("page 3: 17 B sha256 ")
    assert run(["serve", "put", "sv", "x"])[0] == 1
    assert run(["serve", "pages", "sv", "cli-art", "shard0",
                "1,zap"])[0] == 1
    return outs


def test_cli_serve_verbs(env, tmp_path):
    both(cli_serve_verbs, env, tmp_path)


# keep LAST in the module: kills an OSD of each module-scoped cluster
def degraded_reads(kind, e):
    store, c = e[kind]["store"], e[kind]["c"]
    rng = random.Random(53)
    ckpt = rng.randbytes(7 * PAGE + 99)
    kv = [rng.randbytes(rng.choice([PAGE, 640])) for _ in range(12)]
    store.put("deg", shards={"s0": ckpt}, pages={"kv": kv})
    c.kill_osd(0)
    e[kind]["r"].mon_command({"prefix": "osd down", "ids": [0]})
    c.pump()
    h = store.open("deg", policy="checkpoint")
    assert h.read_shard("s0") == ckpt            # reconstructed
    stats = dict(h.stats)
    h.close()
    ids = [rng.randrange(len(kv)) for _ in range(8)]
    assert store.fetch_pages("deg", "kv", ids) == [kv[i] for i in ids]
    return stats, ids, manifest_bytes(kind, e, "deg")


def test_degraded_ec_reads_byte_identical(env):
    both(degraded_reads, env)
