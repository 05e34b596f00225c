"""CRUSH-aware remap search for the upmap balancer.

Given a rule and a placement, find a substitute placement that moves
chunks off *overfull* devices onto *underfull* ones while preserving the
rule's failure-domain structure (ref: src/crush/CrushWrapper.cc:3987
try_remap_rule, :3801 _choose_type_stack).  This is the validity engine
behind ``OSDMap.calc_pg_upmaps``: the balancer proposes pg_upmap_items
pairs, and this module guarantees each proposal is one the rule itself
could have emitted (distinct hosts stay distinct, racks stay racks).

Pure host-side tree walking; the bulk placement that drives it is the
batch path in ceph_tpu_torch.osd.balancer (K3 on the card).

The port's copy of `ceph_tpu.crush.remap`.
"""
from __future__ import annotations

from .types import (CRUSH_RULE_CHOOSELEAF_FIRSTN, CRUSH_RULE_CHOOSELEAF_INDEP,
                    CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSE_INDEP,
                    CRUSH_RULE_EMIT, CRUSH_RULE_TAKE, CrushMap)


class _ParentMap(dict):
    """child -> one parent, plus the set of children that have MORE
    than one (shared subtrees) — _contains_up must not trust the
    single-parent walk for those."""

    __slots__ = ("multi",)

    def __init__(self):
        super().__init__()
        self.multi: set[int] = set()


def build_parent_map(cmap: CrushMap) -> dict[int, int]:
    """child item id -> containing bucket id (ref: CrushWrapper.h
    parent_map, built by build_rmaps)."""
    parent = _ParentMap()
    for b in cmap.buckets:
        if b is None:
            continue
        for it in b.items:
            if it in parent and parent[it] != b.id:
                parent.multi.add(it)
            parent[it] = b.id
    return parent


def get_parent_of_type(cmap: CrushMap, item: int, type_: int,
                       parent: dict[int, int] | None = None) -> int:
    """Nearest ancestor bucket of the given type; 0 when none
    (ref: CrushWrapper.cc get_parent_of_type)."""
    if parent is None:
        parent = build_parent_map(cmap)
    while True:
        nxt = parent.get(item)
        if nxt is None:
            return 0
        item = nxt
        b = cmap.bucket(item)
        if b is not None and b.type == type_:
            return item


def subtree_contains(cmap: CrushMap, root: int, item: int) -> bool:
    """True when item is root or lives under bucket `root`
    (ref: CrushWrapper.cc subtree_contains)."""
    if root == item:
        return True
    b = cmap.bucket(root)
    if b is None:
        return False
    return any(subtree_contains(cmap, child, item) for child in b.items)


def _contains_up(cmap: CrushMap, parent: dict[int, int], root: int,
                 item: int) -> bool:
    """subtree_contains via the precomputed parent map: walk UP from
    item (O(tree depth)) instead of recursing down from root
    (O(subtree size) — at 10k OSDs that recursion was ~95% of a
    balancer iteration).

    The parent map records ONE parent per item; an item reachable
    through several parents (shared subtree under multiple roots)
    falls back to the exact downward recursion — the upward walk
    would only see one of its ancestries."""
    multi = getattr(parent, "multi", None)
    cur = item
    while cur != root:
        if multi and cur in multi:
            return subtree_contains(cmap, root, item)
        nxt = parent.get(cur)
        if nxt is None:
            return False
        cur = nxt
    return True


def get_rule_weight_osd_map(cmap: CrushMap, ruleno: int) -> dict[int, float]:
    """Normalized osd -> weight-fraction map over the rule's TAKE roots
    (ref: CrushWrapper.cc:2385 get_rule_weight_osd_map,
    _get_take_weight_osd_map, _normalize_weight_map)."""
    if not (0 <= ruleno < len(cmap.rules)) or cmap.rules[ruleno] is None:
        raise KeyError(f"no rule {ruleno}")
    rule = cmap.rules[ruleno]
    pmap: dict[int, float] = {}
    for step in rule.steps:
        if step.op != CRUSH_RULE_TAKE:
            continue
        m: dict[int, float] = {}
        total = 0.0
        n = step.arg1
        if n >= 0:
            m[n] = 1.0
            total = 1.0
        else:
            # breadth-first walk summing device weights
            q = [n]
            while q:
                b = cmap.bucket(q.pop(0))
                if b is None:
                    continue
                for j, it in enumerate(b.items):
                    if it >= 0:
                        w = b.item_weights[j] / 0x10000
                        m[it] = w
                        total += w
                    else:
                        q.append(it)
        if total > 0:
            for osd, w in m.items():
                pmap[osd] = pmap.get(osd, 0.0) + w / total
    return pmap


class _Cursor:
    """Mutable index into orig, mirroring the reference's shared
    vector<int>::const_iterator& threaded through the stack walk."""

    __slots__ = ("i",)

    def __init__(self) -> None:
        self.i = 0


def _choose_type_stack(cmap: CrushMap, stack: list[tuple[int, int]],
                       overfull: set[int], underfull: list[int],
                       orig: list[int], cur: _Cursor, used: set[int],
                       w: list[int], root_bucket: int,
                       parent: dict[int, int]) -> list[int]:
    """One (type, fanout)* descent replaying the rule structure over
    `orig`, swapping overfull leaves for underfull candidates that live
    under the same intermediate bucket (ref: CrushWrapper.cc:3801)."""
    assert root_bucket < 0
    cumulative_fanout = [0] * len(stack)
    f = 1
    for j in range(len(stack) - 1, -1, -1):
        cumulative_fanout[j] = f
        f *= stack[j][1]

    # per-level buckets that have >=1 underfull leaf below them
    # (CrushWrapper.cc:3838)
    underfull_buckets: list[set[int]] = [set() for _ in range(len(stack) - 1)]
    for osd in underfull:
        item = osd
        for j in range(len(stack) - 2, -1, -1):
            item = get_parent_of_type(cmap, item, stack[j][0], parent)
            if not _contains_up(cmap, parent, root_bucket, item):
                continue
            underfull_buckets[j].add(item)

    for j, (type_, fanout) in enumerate(stack):
        cum_fanout = cumulative_fanout[j]
        o: list[int] = []
        if cur.i >= len(orig):
            break
        tmpi = cur.i
        done = False
        for frm in w:
            leaves: list[set[int]] = [set() for _ in range(fanout)]
            for pos in range(fanout):
                if type_ > 0:
                    # non-leaf: name the ancestor bucket this span maps to
                    item = get_parent_of_type(cmap, orig[tmpi], type_, parent)
                    o.append(item)
                    n = cum_fanout
                    while n > 0 and tmpi < len(orig):
                        leaves[pos].add(orig[tmpi])
                        tmpi += 1
                        n -= 1
                else:
                    # leaf: try to swap an overfull device out
                    replaced = False
                    if orig[cur.i] in overfull:
                        for item in underfull:
                            if item in used:
                                continue
                            if not _contains_up(cmap, parent, frm, item):
                                continue
                            if item in orig:
                                continue
                            o.append(item)
                            used.add(item)
                            replaced = True
                            cur.i += 1
                            break
                    if not replaced:
                        o.append(orig[cur.i])
                        cur.i += 1
                    if cur.i >= len(orig):
                        done = True
                        break
            if j + 1 < len(stack):
                # reject buckets with overfull leaves but no underfull
                # alternates; swap in a same-parent peer that has some
                # (CrushWrapper.cc:3931)
                for pos in range(min(fanout, len(o))):
                    if o[pos] in underfull_buckets[j]:
                        continue
                    if not any(osd in overfull for osd in leaves[pos]):
                        continue
                    for alt in underfull_buckets[j]:
                        if alt in o:
                            continue
                        if j == 0 or \
                                get_parent_of_type(cmap, o[pos],
                                                   stack[j - 1][0], parent) \
                                == get_parent_of_type(cmap, alt,
                                                      stack[j - 1][0],
                                                      parent):
                            o[pos] = alt
                            break
            if done or cur.i >= len(orig):
                break
        w = o
    return w


def try_remap_rule(cmap: CrushMap, ruleno: int, maxout: int,
                   overfull: set[int], underfull: list[int],
                   orig: list[int],
                   parent: dict[int, int] | None = None) -> list[int]:
    """Replay rule `ruleno`'s structure over placement `orig`, swapping
    overfull devices for underfull ones where the failure-domain
    constraints allow (ref: CrushWrapper.cc:3987 try_remap_rule).
    Returns the (possibly unchanged) remapped placement.  Callers in a
    loop should build the parent map once and pass it (the reference
    caches it as rmaps on the wrapper)."""
    rule = cmap.rules[ruleno]
    if rule is None:
        raise KeyError(f"no rule {ruleno}")
    if parent is None:
        parent = build_parent_map(cmap)
    out: list[int] = []
    w: list[int] = []
    cur = _Cursor()
    used: set[int] = set()
    type_stack: list[tuple[int, int]] = []
    root_bucket = 0
    for step in rule.steps:
        if step.op == CRUSH_RULE_TAKE:
            ok = (0 <= step.arg1 < cmap.max_devices) or \
                (0 <= -1 - step.arg1 < cmap.max_buckets and
                 cmap.bucket(step.arg1) is not None)
            if ok:
                w = [step.arg1]
                root_bucket = step.arg1
        elif step.op in (CRUSH_RULE_CHOOSELEAF_FIRSTN,
                         CRUSH_RULE_CHOOSELEAF_INDEP):
            numrep, type_ = step.arg1, step.arg2
            if numrep <= 0:
                numrep += maxout
            type_stack.append((type_, numrep))
            if type_ > 0:
                type_stack.append((0, 1))
            w = _choose_type_stack(cmap, type_stack, overfull, underfull,
                                   orig, cur, used, w, root_bucket, parent)
            type_stack = []
        elif step.op in (CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSE_INDEP):
            numrep, type_ = step.arg1, step.arg2
            if numrep <= 0:
                numrep += maxout
            type_stack.append((type_, numrep))
        elif step.op == CRUSH_RULE_EMIT:
            if type_stack:
                w = _choose_type_stack(cmap, type_stack, overfull, underfull,
                                       orig, cur, used, w, root_bucket,
                                       parent)
                type_stack = []
            out.extend(w)
            w = []
    return out
