"""Helpers to rebuild CrushMaps from fixture specs (the C core's vectors in
tests/fixtures/crush_vectors.json; format: see scripts/gen_crush_fixtures.py),
and small maps for checking the batch engine's two forms on the card."""
from __future__ import annotations

import numpy as np

from .types import (
    CRUSH_BUCKET_STRAW2, CRUSH_BUCKET_TREE, CRUSH_RULE_CHOOSELEAF_FIRSTN,
    CRUSH_RULE_CHOOSELEAF_INDEP, CRUSH_RULE_CHOOSE_FIRSTN,
    CRUSH_RULE_CHOOSE_INDEP, CRUSH_RULE_EMIT, CRUSH_RULE_TAKE, CrushBucket,
    CrushMap, CrushRule, CrushRuleStep,
)


def tree_node_weights(items: list[int], weights: list[int]) -> list[int]:
    """Tree-bucket node weights, replicating builder.c
    crush_make_tree_bucket's layout (leaves at odd nodes (i+1)*2-1)."""
    n = len(items)
    depth = 0
    t = 1
    while t < n:
        t <<= 1
        depth += 1
    num_nodes = 1 << (depth + 1)
    nw = [0] * num_nodes
    for i, w in enumerate(weights):
        node = ((i + 1) << 1) - 1
        nw[node] = w
        while node != (num_nodes >> 1):
            h = 0
            nn = node
            while (nn & 1) == 0:
                h += 1
                nn >>= 1
            if (node >> (h + 1)) & 1:
                parent = node - (1 << h)
            else:
                parent = node + (1 << h)
            nw[parent] += w
            node = parent
    return nw


def map_from_spec(spec: dict) -> CrushMap:
    """Build a CrushMap from a fixture spec (buckets get ids -1, -2, ...
    in order, matching crush_add_bucket)."""
    m = CrushMap()
    (m.choose_local_tries, m.choose_local_fallback_tries,
     m.choose_total_tries, m.chooseleaf_descend_once,
     m.chooseleaf_vary_r, m.chooseleaf_stable) = spec["tunables"]
    m.straw_calc_version = spec.get("straw_calc_version", 0)
    for i, (alg, type_, items, weights) in enumerate(spec["buckets"]):
        b = CrushBucket(id=-(i + 1), type=type_, alg=alg,
                        items=list(items), item_weights=list(weights),
                        weight=sum(weights))
        if alg == CRUSH_BUCKET_TREE:
            b.node_weights = tree_node_weights(items, weights)
        m.add_bucket(b)
        for it in items:
            if it >= 0:
                m.max_devices = max(m.max_devices, it + 1)
    for steps in spec["rules"]:
        m.rules.append(CrushRule(steps=[CrushRuleStep(*s) for s in steps]))
    return m


# ---------------------------------------------------------------------------
# Small straw2 maps and rule shapes for checking the batch engine's two
# forms against each other on the card (chip_smoke.py, the cuda tests);
# the same shapes as the reference package's tests/test_crush_batch.py.

def build_hierarchy(n_racks: int = 3, hosts_per_rack: int = 3,
                    osds_per_host: int = 4, seed: int = 0,
                    tunables: str = "jewel") -> tuple[CrushMap, int]:
    """root(type 3) -> racks(2) -> hosts(1) -> osds(0), all straw2, OSD
    weights 1..3 x 0x10000 from `seed`.  Returns (map, root id)."""
    rng = np.random.default_rng(seed)
    m = CrushMap()
    m.set_tunables_profile(tunables)
    osd = 0
    rack_ids = []
    for _ in range(n_racks):
        host_ids = []
        for _ in range(hosts_per_rack):
            items = list(range(osd, osd + osds_per_host))
            osd += osds_per_host
            weights = [int(rng.integers(1, 4) * 0x10000) for _ in items]
            host_ids.append(m.add_bucket(CrushBucket(
                id=0, type=1, alg=CRUSH_BUCKET_STRAW2, items=items,
                item_weights=weights, weight=sum(weights))))
        hw = [m.bucket(h).weight for h in host_ids]
        rack_ids.append(m.add_bucket(CrushBucket(
            id=0, type=2, alg=CRUSH_BUCKET_STRAW2, items=host_ids,
            item_weights=hw, weight=sum(hw))))
    rw = [m.bucket(r).weight for r in rack_ids]
    root = m.add_bucket(CrushBucket(
        id=0, type=3, alg=CRUSH_BUCKET_STRAW2, items=rack_ids,
        item_weights=rw, weight=sum(rw)))
    m.max_devices = osd
    return m, root


def build_flat(weights: list[int], numrep: int = 3,
               tunables: str = "jewel") -> CrushMap:
    """root -> osds directly with the given weights; rule 0 is
    take root, choose_firstn numrep type 0, emit."""
    m = CrushMap()
    m.set_tunables_profile(tunables)
    items = list(range(len(weights)))
    root = m.add_bucket(CrushBucket(
        id=0, type=1, alg=CRUSH_BUCKET_STRAW2, items=items,
        item_weights=list(weights), weight=sum(weights)))
    m.max_devices = len(weights)
    m.rules.append(CrushRule(steps=[
        CrushRuleStep(CRUSH_RULE_TAKE, root),
        CrushRuleStep(CRUSH_RULE_CHOOSE_FIRSTN, numrep, 0),
        CrushRuleStep(CRUSH_RULE_EMIT)]))
    return m


def rule_shapes(root: int) -> dict[str, tuple[list[CrushRuleStep], int]]:
    """{name: (steps, result_max)} of the rule shapes of the batch
    engine's tests, taking from `root` of a build_hierarchy map."""
    take, emit = CrushRuleStep(CRUSH_RULE_TAKE, root), \
        CrushRuleStep(CRUSH_RULE_EMIT)
    return {
        "replicated_firstn": ([take, CrushRuleStep(
            CRUSH_RULE_CHOOSELEAF_FIRSTN, 3, 1), emit], 4),
        "ec_indep": ([take, CrushRuleStep(
            CRUSH_RULE_CHOOSELEAF_INDEP, 0, 1), emit], 6),
        "two_level_firstn": ([take, CrushRuleStep(
            CRUSH_RULE_CHOOSE_FIRSTN, 2, 2), CrushRuleStep(
            CRUSH_RULE_CHOOSELEAF_FIRSTN, 2, 1), emit], 4),
        "direct_osd_indep": ([take, CrushRuleStep(
            CRUSH_RULE_CHOOSE_INDEP, 4, 0), emit], 4),
        "direct_osd_firstn": ([take, CrushRuleStep(
            CRUSH_RULE_CHOOSE_FIRSTN, 3, 0), emit], 4),
    }


def make_weight(n_devices: int, seed: int = 0, frac_out: float = 0.15,
                frac_partial: float = 0.15) -> np.ndarray:
    """(n_devices,) int64 16.16 reweights: `frac_out` of the devices out
    (0), `frac_partial` partially reweighted, the rest in (0x10000)."""
    rng = np.random.default_rng(seed)
    w = np.full(n_devices, 0x10000, dtype=np.int64)
    rolls = rng.random(n_devices)
    w[rolls < frac_out] = 0
    part = (rolls >= frac_out) & (rolls < frac_out + frac_partial)
    w[part] = rng.integers(0x1000, 0x10000, part.sum())
    return w
