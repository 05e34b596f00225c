"""CrushWrapper equivalent: owns a CrushMap plus name/type maps and
build/modify/query helpers (ref: src/crush/CrushWrapper.{h,cc}).

Covers the surface the rest of the framework needs: bucket tree
construction (`add_bucket`, `insert_item`), simple-rule creation
(`add_simple_rule`, ref: CrushWrapper.h:1199), weight updates, device
classes, and `do_rule` dispatch through the scalar engine (ref:
CrushWrapper.h:1568).

The port's copy of `ceph_tpu.crush.wrapper`, without its wire
registration; `CrushWrapper.from_reference` carries a wrapper of another
package across by attribute.
"""
from __future__ import annotations

from . import mapper
from .types import (
    CRUSH_BUCKET_STRAW2, CRUSH_RULE_CHOOSELEAF_FIRSTN,
    CRUSH_RULE_CHOOSELEAF_INDEP, CRUSH_RULE_CHOOSE_FIRSTN,
    CRUSH_RULE_CHOOSE_INDEP, CRUSH_RULE_EMIT, CRUSH_RULE_TAKE,
    CrushBucket, CrushMap, CrushRule, CrushRuleMask, CrushRuleStep,
    crush_map_from_reference,
)

RULE_TYPE_REPLICATED = 1
RULE_TYPE_ERASURE = 3

DEFAULT_TYPES = {0: "osd", 1: "host", 2: "chassis", 3: "rack", 4: "row",
                 5: "pdu", 6: "pod", 7: "room", 8: "datacenter",
                 9: "zone", 10: "region", 11: "root"}


class CrushWrapper:
    def __init__(self) -> None:
        self.crush = CrushMap()
        self.type_map: dict[int, str] = dict(DEFAULT_TYPES)
        self.name_map: dict[int, str] = {}     # item id -> name
        self.class_map: dict[int, int] = {}    # device id -> class id
        self.class_name: dict[int, str] = {}   # class id -> name
        self.rule_name_map: dict[int, str] = {}

    @classmethod
    def from_reference(cls, obj) -> "CrushWrapper":
        """A CrushWrapper equal to `obj`, a CrushWrapper of another
        package with the same attributes: the map, type, item, class and
        rule names."""
        w = cls()
        w.crush = crush_map_from_reference(obj.crush)
        w.type_map = {int(k): str(v) for k, v in obj.type_map.items()}
        w.name_map = {int(k): str(v) for k, v in obj.name_map.items()}
        w.class_map = {int(k): int(v) for k, v in obj.class_map.items()}
        w.class_name = {int(k): str(v) for k, v in obj.class_name.items()}
        w.rule_name_map = {int(k): str(v)
                           for k, v in obj.rule_name_map.items()}
        return w

    # -- lookups -----------------------------------------------------------
    def get_type_id(self, name: str) -> int:
        for tid, tname in self.type_map.items():
            if tname == name:
                return tid
        return -1

    def get_item_id(self, name: str) -> int | None:
        for iid, iname in self.name_map.items():
            if iname == name:
                return iid
        return None

    def get_item_name(self, item: int) -> str | None:
        return self.name_map.get(item)

    def get_rule_id(self, name: str) -> int:
        for rid, rname in self.rule_name_map.items():
            if rname == name:
                return rid
        return -1

    def class_id_or_create(self, name: str) -> int:
        for cid, cname in self.class_name.items():
            if cname == name:
                return cid
        cid = max(self.class_name, default=-1) + 1
        self.class_name[cid] = name
        return cid

    # -- build -------------------------------------------------------------
    def add_bucket(self, name: str, type_name: str,
                   alg: int = CRUSH_BUCKET_STRAW2, bucket_id: int | None = None
                   ) -> int:
        tid = self.get_type_id(type_name)
        if tid < 0:
            tid = max(self.type_map) + 1
            self.type_map[tid] = type_name
        b = CrushBucket(id=bucket_id if bucket_id is not None else 0,
                        type=tid, alg=alg)
        bid = self.crush.add_bucket(b)
        self.name_map[bid] = name
        return bid

    def insert_item(self, item: int, weight: float, name: str,
                    bucket_name: str, device_class: str | None = None) -> None:
        """Add a device (or sub-bucket) into a named bucket; weight is in
        'crush units' (converted to 16.16 fixed point)."""
        bid = self.get_item_id(bucket_name)
        if bid is None or bid >= 0:
            raise ValueError(f"no bucket {bucket_name}")
        bucket = self.crush.bucket(bid)
        w = int(weight * 0x10000)
        bucket.items.append(item)
        bucket.item_weights.append(w)
        bucket.weight += w
        self.name_map.setdefault(item, name)
        if item >= 0:
            self.crush.max_devices = max(self.crush.max_devices, item + 1)
            if device_class is not None:
                self.class_map[item] = self.class_id_or_create(device_class)
        # propagate weight up: find parents containing bid
        self._adjust_ancestors(bid, w)

    def _adjust_ancestors(self, child_id: int, delta: int) -> None:
        for b in self.crush.buckets:
            if b is None:
                continue
            for i, it in enumerate(b.items):
                if it == child_id:
                    b.item_weights[i] += delta
                    b.weight += delta
                    self._adjust_ancestors(b.id, delta)
                    return

    def adjust_item_weight(self, item: int, weight: float) -> int:
        """Set a device's weight everywhere it appears
        (ref: CrushWrapper.cc adjust_item_weightf_in_loc)."""
        w = int(weight * 0x10000)
        changed = 0
        for b in self.crush.buckets:
            if b is None:
                continue
            for i, it in enumerate(b.items):
                if it == item:
                    delta = w - b.item_weights[i]
                    b.item_weights[i] = w
                    b.weight += delta
                    self._adjust_ancestors(b.id, delta)
                    changed += 1
        return changed

    # -- rules -------------------------------------------------------------
    def add_simple_rule(self, name: str, root_name: str,
                        failure_domain: str, device_class: str = "",
                        mode: str = "firstn", rule_type: str = "replicated",
                        max_size: int | None = None) -> int:
        """ref: CrushWrapper.h:1199 add_simple_rule -> steps
        TAKE root / CHOOSELEAF_<mode> 0 type <domain> / EMIT.

        max_size widens the legacy rule-mask ceiling (default 10):
        find_rule filters on min_size <= pool.size <= max_size, so a
        wide EC pool (k+m > 10) must pass its chunk count or the rule
        never matches and every PG maps empty (ref: ErasureCode.cc
        create_rule passing get_chunk_count() as the rule's max_size)."""
        root = self.get_item_id(root_name)
        if root is None:
            raise ValueError(f"root item {root_name} does not exist")
        steps = [CrushRuleStep(CRUSH_RULE_TAKE, root, 0)]
        rtype = RULE_TYPE_ERASURE if rule_type == "erasure" else \
            RULE_TYPE_REPLICATED
        if failure_domain in ("", "osd"):
            op = CRUSH_RULE_CHOOSE_FIRSTN if mode == "firstn" else \
                CRUSH_RULE_CHOOSE_INDEP
            steps.append(CrushRuleStep(op, 0, 0))
        else:
            tid = self.get_type_id(failure_domain)
            if tid < 0:
                raise ValueError(f"unknown type {failure_domain}")
            op = CRUSH_RULE_CHOOSELEAF_FIRSTN if mode == "firstn" else \
                CRUSH_RULE_CHOOSELEAF_INDEP
            steps.append(CrushRuleStep(op, 0, tid))
        steps.append(CrushRuleStep(CRUSH_RULE_EMIT, 0, 0))
        mask = CrushRuleMask(ruleset=len(self.crush.rules), type=rtype)
        if max_size is not None:
            mask.max_size = max(max_size, mask.max_size)
        rule = CrushRule(steps=steps, mask=mask)
        self.crush.rules.append(rule)
        rid = len(self.crush.rules) - 1
        self.rule_name_map[rid] = name
        return rid

    # -- mapping -----------------------------------------------------------
    def do_rule(self, ruleno: int, x: int, numrep: int,
                weights: list[int] | None = None, choose_args=None
                ) -> list[int]:
        """ref: CrushWrapper.h:1568.  weights: per-device 16.16 in/out
        vector (default: all fully in)."""
        if weights is None:
            weights = [0x10000] * self.crush.max_devices
        return mapper.do_rule(self.crush, ruleno, x, numrep, weights,
                              choose_args)

    # -- convenience for tests/tools --------------------------------------
    @classmethod
    def build_flat(cls, n_osds: int, weight: float = 1.0,
                   osds_per_host: int = 1) -> "CrushWrapper":
        """default root -> hosts -> osds, like `osdmaptool
        --createsimple` / `crushtool --build` defaults."""
        cw = cls()
        cw.add_bucket("default", "root")
        for base in range(0, n_osds, osds_per_host):
            host = f"host{base // osds_per_host}"
            cw.add_bucket(host, "host")
            for i in range(base, min(base + osds_per_host, n_osds)):
                cw.insert_item(i, weight, f"osd.{i}", host)
            # attach host under root
            root = cw.crush.bucket(cw.get_item_id("default"))
            hid = cw.get_item_id(host)
            hb = cw.crush.bucket(hid)
            root.items.append(hid)
            root.item_weights.append(hb.weight)
            root.weight += hb.weight
        return cw
