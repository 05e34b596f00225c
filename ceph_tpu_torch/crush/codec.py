"""JSON codec for CrushMap / CrushWrapper, shared by crushtool and
osdmaptool so their map files stay interchangeable (the reference's
analogue is the single binary encode/decode in crush/CrushWrapper.cc).

The port's copy of `ceph_tpu.crush.codec`: the JSON is the same key for
key, so a map file written by either package's tools loads in the
other's.
"""
from __future__ import annotations

from .types import (ChooseArg, CrushBucket, CrushMap, CrushRule,
                    CrushRuleMask, CrushRuleStep)
from .wrapper import CrushWrapper

TUNABLE_FIELDS = ("choose_local_tries", "choose_local_fallback_tries",
                  "choose_total_tries", "chooseleaf_descend_once",
                  "chooseleaf_vary_r", "chooseleaf_stable",
                  "straw_calc_version")


def crush_to_json(c: CrushMap) -> dict:
    return {
        "tunables": {f: getattr(c, f) for f in TUNABLE_FIELDS},
        "max_devices": c.max_devices,
        "buckets": [None if b is None else {
            "id": b.id, "type": b.type, "alg": b.alg, "hash": b.hash,
            "weight": b.weight, "items": b.items,
            "item_weights": b.item_weights,
        } for b in c.buckets],
        "rules": [None if r is None else {
            "steps": [[s.op, s.arg1, s.arg2] for s in r.steps],
            "mask": [r.mask.ruleset, r.mask.type, r.mask.min_size,
                     r.mask.max_size],
        } for r in c.rules],
        "choose_args": {
            str(name): {str(bid): {"ids": a.ids,
                                   "weight_set": a.weight_set}
                        for bid, a in args.items()}
            for name, args in c.choose_args.items()},
    }


def crush_from_json(data: dict) -> CrushMap:
    c = CrushMap()
    for f in TUNABLE_FIELDS:
        setattr(c, f, data["tunables"][f])
    c.max_devices = data["max_devices"]
    for bd in data["buckets"]:
        c.buckets.append(None if bd is None else CrushBucket(
            id=bd["id"], type=bd["type"], alg=bd["alg"], hash=bd["hash"],
            weight=bd["weight"], items=list(bd["items"]),
            item_weights=list(bd["item_weights"])))
    for rd in data["rules"]:
        c.rules.append(None if rd is None else CrushRule(
            steps=[CrushRuleStep(*s) for s in rd["steps"]],
            mask=CrushRuleMask(*rd["mask"])))
    for name, args in data.get("choose_args", {}).items():
        try:
            key = int(name)
        except ValueError:
            key = name
        c.choose_args[key] = {
            int(bid): ChooseArg(ids=a.get("ids"),
                                weight_set=a.get("weight_set"))
            for bid, a in args.items()}
    return c


def wrapper_to_json(w: CrushWrapper) -> dict:
    data = crush_to_json(w.crush)
    data.update({
        "type_map": {str(k): v for k, v in w.type_map.items()},
        "name_map": {str(k): v for k, v in w.name_map.items()},
        "rule_name_map": {str(k): v for k, v in w.rule_name_map.items()},
        "class_map": {str(k): v for k, v in w.class_map.items()},
        "class_name": {str(k): v for k, v in w.class_name.items()},
    })
    return data


def wrapper_from_json(data: dict) -> CrushWrapper:
    w = CrushWrapper()
    w.crush = crush_from_json(data)
    w.type_map = {int(k): v for k, v in data["type_map"].items()}
    w.name_map = {int(k): v for k, v in data["name_map"].items()}
    w.rule_name_map = {int(k): v
                       for k, v in data["rule_name_map"].items()}
    w.class_map = {int(k): v for k, v in data.get("class_map",
                                                  {}).items()}
    w.class_name = {int(k): v for k, v in data.get("class_name",
                                                   {}).items()}
    return w
