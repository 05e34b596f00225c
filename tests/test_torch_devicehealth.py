"""The port's devicehealth module and its feed held to the reference's.

Three cases, each run on `ceph_tpu` and on `ceph_tpu_torch` (clusters
on `device="cpu"`) and compared at tolerance 0:

* the feed itself: BlueStore counts a checksum mismatch in
  `media_errors` (tests/test_devicehealth.py's first case);
* the module end to end on a threaded cluster: healthy devices first,
  then media errors on osd.1's store raise DEVICE_HEALTH in `health`, a
  completed progress event, a warn line in `log last`, and the
  per-device gauges `ceph_device_health` and `ceph_device_media_errors`
  in the mgr's prometheus scrape (the second case);
* the OSD's stat report carrying the feed (`bluestore_csum_errors`,
  `bluestore_read_errors` in `osd perf dump` through the mon) after a
  real checksum mismatch: a pump-mode cluster of BlueStore OSDs writes
  an EC pool, one shard's blob is rotted with `corrupt_blob_bytes`, and
  the read decodes around it; then devicehealth, ticked on that mon,
  warns for exactly that device.

Stamps from the wall clock (a device record's, a log entry's) are the
only fields masked.
"""
import numpy as np
import pytest

from ceph_tpu.mgr import devicehealth as ref_dh
from ceph_tpu.store import BlueStore as RefBlueStore
from ceph_tpu.store import ObjectId as RefObjectId
from ceph_tpu.store import StoreError as RefStoreError
from ceph_tpu.store import Transaction as RefTransaction
from ceph_tpu.testing import MiniCluster as RefCluster
from ceph_tpu_torch.mgr import devicehealth as port_dh
from ceph_tpu_torch.store import BlueStore as PortBlueStore
from ceph_tpu_torch.store import ObjectId as PortObjectId
from ceph_tpu_torch.store import StoreError as PortStoreError
from ceph_tpu_torch.store import Transaction as PortTransaction
from ceph_tpu_torch.testing import MiniCluster as PortCluster

NS = {
    "ref": dict(cluster=RefCluster, bluestore=RefBlueStore,
                oid=RefObjectId, err=RefStoreError, tx=RefTransaction,
                dh=ref_dh, kw={}),
    "port": dict(cluster=PortCluster, bluestore=PortBlueStore,
                 oid=PortObjectId, err=PortStoreError, tx=PortTransaction,
                 dh=port_dh, kw={"device": "cpu"}),
}
PROFILE = {"plugin": "tpu", "k": "2", "m": "1",
           "crush-failure-domain": "host"}


def both(scenario):
    ref, port = scenario(NS["ref"]), scenario(NS["port"])
    assert port == ref
    return port


def unstamped(records):
    return [{k: v for k, v in r.items() if k != "stamp"} for r in records]


def test_bluestore_counts_media_errors(tmp_path):
    def s(ns):
        bs = ns["bluestore"](str(tmp_path / ns["dh"].__name__ / "bs"))
        bs.mkfs()
        bs.mount()
        try:
            oid = ns["oid"]("x")
            bs.queue_transaction(ns["tx"]().create_collection("c")
                                 .write("c", oid, 0, b"payload"))
            out = [bs.read("c", oid), dict(bs.media_errors)]
            bs.corrupt_blob_bytes("c", oid, b"ROT")
            with pytest.raises(ns["err"]):
                bs.read("c", oid)
            out.append(dict(bs.media_errors))
            return out
        finally:
            bs.umount()
    out = both(s)
    assert out == [b"payload", {"csum_errors": 0, "read_errors": 0},
                   {"csum_errors": 1, "read_errors": 0}]


def test_devicehealth_module_end_to_end():
    """Errors on an OSD's store surface as a DEVICE_HEALTH warning in
    `health`, a progress event and a cluster-log line."""
    def s(ns):
        c = ns["cluster"](n_osd=3, threaded=True, **ns["kw"])
        c.wait_all_up()
        r = c.rados()
        try:
            mgr = c.start_mgr()
            mgr.start_progress()
            dh = mgr.start_devicehealth()
            c.tick(10.0)
            mgr.devicehealth_tick()
            c.pump()
            healthy = unstamped(dh.ls())
            checks0 = sorted(r.mon_command({"prefix": "health"})[2][
                "checks"])
            # the counters set by hand, as the reference's case does:
            # its cluster runs on the default MemStore
            c.osds[1].store.media_errors = {"csum_errors": 3,
                                            "read_errors": 1}
            c.tick(20.0)
            c.pump()
            mgr.devicehealth_tick()
            c.pump()
            rec = dict(dh.get_health("osd.1-dev"))
            rec.pop("stamp")
            health = r.mon_command({"prefix": "health"})[2]
            events = [e["message"] for e in mgr.progress.history()]
            c.pump()
            warn = [(e["name"], e["level"], e["text"]) for e in
                    r.mon_command({"prefix": "log last", "num": 20,
                                   "level": "warn"})[2]]
            text = mgr.start_prometheus(port=0).collect()
            mgr.prometheus.shutdown()
            gauges = [ln for ln in text.splitlines()
                      if ln.startswith(("ceph_device_", "# HELP ceph_device",
                                        "# TYPE ceph_device"))]
            return (healthy, checks0, rec, health["checks"].get(
                "DEVICE_HEALTH"), events, warn, gauges)
        finally:
            c.shutdown()
    healthy, checks0, rec, check, events, warn, gauges = both(s)
    assert [d["health"] for d in healthy] == ["GOOD"] * 3
    assert "DEVICE_HEALTH" not in checks0
    assert rec["health"] == "WARNING" and rec["csum_errors"] == 3 \
        and rec["read_errors"] == 1
    assert check["severity"] == "HEALTH_WARN" and \
        check["summary"] == "1 devices reporting media errors"
    assert any("devicehealth" in e for e in events)
    assert ("mgr.devicehealth", "warn", "device osd.1-dev on osd.1 reports "
            "4 media errors, life expectancy <6w") in warn
    assert 'ceph_device_health{daemon="osd.1",device="osd.1-dev"} 1' \
        in gauges
    assert 'ceph_device_media_errors{daemon="osd.1",device="osd.1-dev"} 4' \
        in gauges


class _MonMgr:
    """The mgr surface DeviceHealth uses, answered by a mon in
    process (pump mode has no dispatch thread for the mgr's
    synchronous mon_command)."""

    def __init__(self, mon):
        self.mon = mon
        self.slices = {}

    def mon_command(self, cmd):
        return self.mon.handle_command(cmd)

    def set_health_checks(self, module, checks):
        self.slices[module] = checks


def test_osd_perf_dump_carries_bluestore_media_errors(tmp_path):
    """A real checksum mismatch under a degraded EC read reaches
    `osd perf dump` through the OSD's stat report, and devicehealth
    warns for exactly that device."""
    rng = np.random.default_rng(15)
    payload = rng.integers(0, 256, 9000, dtype=np.uint8).tobytes()

    def s(ns):
        root = tmp_path / ns["dh"].__name__
        c = ns["cluster"](n_osd=4, threaded=False, **ns["kw"])
        c.pump()
        for osd in range(4):
            c.kill_osd(osd)
            st = ns["bluestore"](str(root / f"osd{osd}"), min_alloc=512)
            st.mkfs()
            st.mount()
            c._stores[osd] = st
            c.start_osd(osd)
        c.pump()
        c.wait_all_up()
        try:
            r = c.rados()
            assert r.mon_command({"prefix": "osd erasure-code-profile set",
                                  "name": "ecp",
                                  "profile": dict(PROFILE)})[0] == 0
            r.pool_create("ec", pg_num=4, pool_type="erasure",
                          erasure_code_profile="ecp")
            c.pump()
            io = r.open_ioctx("ec")
            io.write_full("rotten", payload)
            c.pump()
            pid = r.pool_lookup("ec")
            m = c.mon.osdmap
            raw = m.object_locator_to_pg("rotten", pid)
            _, _, acting, primary = m.pg_to_up_acting_osds(raw)
            # a data shard the primary reads from a peer
            victim = acting[1] if acting[0] == primary else acting[0]
            st = c._stores[victim]
            cid = next(cc for cc in st.list_collections()
                       if any(o.name == "rotten"
                              for o in st.collection_list(cc)))
            obj = next(o for o in st.collection_list(cid)
                       if o.name == "rotten")
            st.corrupt_blob_bytes(cid, obj)
            read = io.read("rotten")
            c.tick(100.0)
            c.pump()
            perf = c.mon.handle_command({"prefix": "osd perf dump"})[2]
            feed = {d: {k: v for k, v in p.items()
                        if k.startswith("bluestore_")}
                    for d, p in sorted(perf.items())}
            mgr = _MonMgr(c.mon)
            dh = ns["dh"].DeviceHealth(mgr)
            dh.tick(200.0)
            return (read == payload, victim, feed, unstamped(dh.ls()),
                    mgr.slices, c.mon.handle_command(
                        {"prefix": "log last", "num": 5,
                         "level": "warn"})[2][-1]["text"])
        finally:
            c.shutdown()
            for st in c._stores.values():
                st.umount()
    ok, victim, feed, devices, slices, line = both(s)
    assert ok
    assert feed == {f"osd.{o}": {"bluestore_csum_errors": int(o == victim),
                                 "bluestore_read_errors": 0}
                    for o in range(4)}
    assert [d["device"] for d in devices if d["health"] != "GOOD"] == [
        f"osd.{victim}-dev"]
    assert slices["devicehealth"]["DEVICE_HEALTH"]["detail"] == [
        f"osd.{victim}-dev (osd.{victim}): 1 media errors, life "
        "expectancy <6w"]
    assert line == f"device osd.{victim}-dev on osd.{victim} reports 1 " \
        "media errors, life expectancy <6w"
