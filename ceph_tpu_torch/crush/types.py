"""CRUSH map data model.

Python rendering of the crush_map structures (ref: src/crush/crush.h:
crush_bucket :229, crush_rule/crush_rule_step :44-97, crush_map :425-521).
Buckets are identified by negative ids (-1-index into buckets[]); devices by
non-negative ids.  Weights are 16.16 fixed point.

`crush_map_from_reference` copies a CrushMap of another package (the JAX
reference's, in the tests) field by field, without importing it.
"""
from __future__ import annotations

from dataclasses import dataclass, field

# bucket algorithms (crush.h:140-190)
CRUSH_BUCKET_UNIFORM = 1
CRUSH_BUCKET_LIST = 2
CRUSH_BUCKET_TREE = 3
CRUSH_BUCKET_STRAW = 4
CRUSH_BUCKET_STRAW2 = 5

# rule step opcodes (crush.h:52-69)
CRUSH_RULE_NOOP = 0
CRUSH_RULE_TAKE = 1
CRUSH_RULE_CHOOSE_FIRSTN = 2
CRUSH_RULE_CHOOSE_INDEP = 3
CRUSH_RULE_EMIT = 4
CRUSH_RULE_CHOOSELEAF_FIRSTN = 6
CRUSH_RULE_CHOOSELEAF_INDEP = 7
CRUSH_RULE_SET_CHOOSE_TRIES = 8
CRUSH_RULE_SET_CHOOSELEAF_TRIES = 9
CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES = 10
CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES = 11
CRUSH_RULE_SET_CHOOSELEAF_VARY_R = 12
CRUSH_RULE_SET_CHOOSELEAF_STABLE = 13

# sentinels (crush.h:33-37)
CRUSH_ITEM_UNDEF = 0x7FFFFFFE
CRUSH_ITEM_NONE = 0x7FFFFFFF

CRUSH_MAX_DEPTH = 10
CRUSH_HASH_RJENKINS1 = 0


@dataclass
class CrushBucket:
    id: int                     # negative
    type: int                   # bucket type id (host/rack/... from type map)
    alg: int = CRUSH_BUCKET_STRAW2
    hash: int = CRUSH_HASH_RJENKINS1
    weight: int = 0             # 16.16 total weight
    items: list[int] = field(default_factory=list)
    item_weights: list[int] = field(default_factory=list)  # 16.16
    # tree-bucket node weights (crush.h:318-321); built on demand
    node_weights: list[int] | None = None

    @property
    def size(self) -> int:
        return len(self.items)


@dataclass
class CrushRuleStep:
    op: int
    arg1: int = 0
    arg2: int = 0


@dataclass
class CrushRuleMask:
    ruleset: int = 0
    type: int = 1               # pg_pool type: 1=replicated, 3=erasure
    min_size: int = 1
    max_size: int = 10


@dataclass
class CrushRule:
    steps: list[CrushRuleStep] = field(default_factory=list)
    mask: CrushRuleMask = field(default_factory=CrushRuleMask)


@dataclass
class ChooseArg:
    """choose_args override for one bucket (crush.h:281-295):
    optional id remap + per-position weight sets."""
    ids: list[int] | None = None
    weight_set: list[list[int]] | None = None   # [position][item] 16.16


@dataclass
class CrushMap:
    buckets: list[CrushBucket | None] = field(default_factory=list)
    rules: list[CrushRule | None] = field(default_factory=list)
    max_devices: int = 0
    # tunables (jewel profile defaults, ref: CrushWrapper.h:186-194)
    choose_local_tries: int = 0
    choose_local_fallback_tries: int = 0
    choose_total_tries: int = 50
    chooseleaf_descend_once: int = 1
    chooseleaf_vary_r: int = 1
    chooseleaf_stable: int = 1
    straw_calc_version: int = 1
    # choose_args sets: name -> {bucket_id: ChooseArg}
    choose_args: dict = field(default_factory=dict)

    # choose_args fallback key (CrushWrapper.h:61)
    DEFAULT_CHOOSE_ARGS = -1

    @property
    def max_buckets(self) -> int:
        return len(self.buckets)

    def find_rule(self, ruleset: int, type_: int, size: int) -> int:
        """First rule whose mask matches (ref: crush_find_rule
        src/crush/mapper.c:41-54); -1 when none."""
        for i, r in enumerate(self.rules):
            if r is not None and r.mask.ruleset == ruleset and \
                    r.mask.type == type_ and \
                    r.mask.min_size <= size <= r.mask.max_size:
                return i
        return -1

    def choose_args_get_with_fallback(self, index):
        """choose_args for index, falling back to DEFAULT_CHOOSE_ARGS
        (ref: CrushWrapper.h:1438-1449)."""
        args = self.choose_args.get(index)
        if args is None:
            args = self.choose_args.get(self.DEFAULT_CHOOSE_ARGS)
        return args

    def bucket(self, item_id: int) -> CrushBucket | None:
        idx = -1 - item_id
        if 0 <= idx < len(self.buckets):
            return self.buckets[idx]
        return None

    def add_bucket(self, bucket: CrushBucket) -> int:
        if bucket.id is None or bucket.id >= 0:
            bucket.id = -1 - len(self.buckets)
            self.buckets.append(bucket)
        else:
            idx = -1 - bucket.id
            while len(self.buckets) <= idx:
                self.buckets.append(None)
            self.buckets[idx] = bucket
        return bucket.id

    def set_tunables_profile(self, profile: str) -> None:
        """argonaut/bobtail/firefly/hammer/jewel
        (ref: CrushWrapper.h:146-194)."""
        vals = {
            "argonaut": (2, 5, 19, 0, 0, 0),
            "bobtail": (0, 0, 50, 1, 0, 0),
            "firefly": (0, 0, 50, 1, 1, 0),
            "hammer": (0, 0, 50, 1, 1, 0),
            "jewel": (0, 0, 50, 1, 1, 1),
        }[profile]
        (self.choose_local_tries, self.choose_local_fallback_tries,
         self.choose_total_tries, self.chooseleaf_descend_once,
         self.chooseleaf_vary_r, self.chooseleaf_stable) = vals


# ---------------------------------------------------------------------------
# carrying a map of another package across (by attribute, no import)

_TUNABLES = ("max_devices", "choose_local_tries",
             "choose_local_fallback_tries", "choose_total_tries",
             "chooseleaf_descend_once", "chooseleaf_vary_r",
             "chooseleaf_stable", "straw_calc_version")


def _opt_list(v):
    return None if v is None else [int(i) for i in v]


def choose_args_from_reference(args) -> dict | None:
    """{bucket_id: ChooseArg} of another package -> this package's."""
    if args is None:
        return None
    return {int(bid): ChooseArg(
        ids=_opt_list(a.ids),
        weight_set=None if a.weight_set is None
        else [[int(w) for w in row] for row in a.weight_set])
        for bid, a in args.items()}


def crush_map_from_reference(obj) -> CrushMap:
    """A CrushMap equal field for field to `obj`, a CrushMap of another
    package with the same attributes: buckets, rules and masks,
    tunables, choose_args and max_devices."""
    m = CrushMap()
    for name in _TUNABLES:
        setattr(m, name, int(getattr(obj, name)))
    for b in obj.buckets:
        m.buckets.append(None if b is None else CrushBucket(
            id=int(b.id), type=int(b.type), alg=int(b.alg),
            hash=int(b.hash), weight=int(b.weight),
            items=[int(i) for i in b.items],
            item_weights=[int(w) for w in b.item_weights],
            node_weights=_opt_list(b.node_weights)))
    for r in obj.rules:
        m.rules.append(None if r is None else CrushRule(
            steps=[CrushRuleStep(int(s.op), int(s.arg1), int(s.arg2))
                   for s in r.steps],
            mask=CrushRuleMask(int(r.mask.ruleset), int(r.mask.type),
                               int(r.mask.min_size), int(r.mask.max_size))))
    m.choose_args = {key: choose_args_from_reference(args)
                     for key, args in obj.choose_args.items()}
    return m
