"""Crushmap text compiler/decompiler — the crushtool `-c`/`-d` codec.

Reads and writes the reference's text crushmap grammar
(ref: src/crush/CrushCompiler.{h,cc}: decompile :108-417, parse_*
:418-1080; golden format examples: src/test/cli/crushtool/*.txt):

    # begin crush map
    tunable choose_total_tries 50
    device 0 osd.0 [class ssd]
    type 1 host
    <type> <name> { id -N  alg straw2  hash 0  item <name> weight F }
    rule <name> { id N  type replicated|erasure  min_size/max_size
                  step take <name> / choose|chooseleaf firstn|indep N
                  type <t> / set_* N / emit }
    # end crush map

Decompile is canonical: compile(decompile(w)) reproduces the same map,
and decompile(compile(text)) is a fixed point — the property the
reference pins with compile-decompile-recompile.t.

The port's copy of `ceph_tpu.crush.compiler`: both packages compile a
text map to the same map and decompile a map to the same text.
"""
from __future__ import annotations

from .types import (CRUSH_BUCKET_LIST, CRUSH_BUCKET_STRAW,
                    CRUSH_BUCKET_STRAW2, CRUSH_BUCKET_TREE,
                    CRUSH_BUCKET_UNIFORM, CRUSH_RULE_CHOOSELEAF_FIRSTN,
                    CRUSH_RULE_CHOOSELEAF_INDEP, CRUSH_RULE_CHOOSE_FIRSTN,
                    CRUSH_RULE_CHOOSE_INDEP, CRUSH_RULE_EMIT,
                    CRUSH_RULE_SET_CHOOSELEAF_TRIES,
                    CRUSH_RULE_SET_CHOOSELEAF_VARY_R,
                    CRUSH_RULE_SET_CHOOSELEAF_STABLE,
                    CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
                    CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES,
                    CRUSH_RULE_SET_CHOOSE_TRIES, CRUSH_RULE_TAKE,
                    CrushBucket, CrushRule, CrushRuleMask, CrushRuleStep)
from .wrapper import RULE_TYPE_ERASURE, RULE_TYPE_REPLICATED, CrushWrapper

ALG_NAMES = {CRUSH_BUCKET_UNIFORM: "uniform", CRUSH_BUCKET_LIST: "list",
             CRUSH_BUCKET_TREE: "tree", CRUSH_BUCKET_STRAW: "straw",
             CRUSH_BUCKET_STRAW2: "straw2"}
ALG_IDS = {v: k for k, v in ALG_NAMES.items()}

SET_STEPS = {
    CRUSH_RULE_SET_CHOOSE_TRIES: "set_choose_tries",
    CRUSH_RULE_SET_CHOOSELEAF_TRIES: "set_chooseleaf_tries",
    CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES: "set_choose_local_tries",
    CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES:
        "set_choose_local_fallback_tries",
    CRUSH_RULE_SET_CHOOSELEAF_VARY_R: "set_chooseleaf_vary_r",
    CRUSH_RULE_SET_CHOOSELEAF_STABLE: "set_chooseleaf_stable",
}
SET_STEP_IDS = {v: k for k, v in SET_STEPS.items()}

# legacy (argonaut) values: tunables are emitted only when they differ
# (ref: CrushCompiler.cc decompile :129-156)
LEGACY_TUNABLES = {"choose_local_tries": 2,
                   "choose_local_fallback_tries": 5,
                   "choose_total_tries": 19,
                   "chooseleaf_descend_once": 0,
                   "chooseleaf_vary_r": 0,
                   "chooseleaf_stable": 0,
                   "straw_calc_version": 0}


class CompileError(ValueError):
    pass


# ---------------------------------------------------------------- decompile
def _wf(w16: int) -> str:
    return f"{w16 / 0x10000:.3f}"


def decompile(w: CrushWrapper) -> str:
    """(ref: CrushCompiler.cc:338 decompile)."""
    c = w.crush
    out = ["# begin crush map"]
    for name, legacy in LEGACY_TUNABLES.items():
        val = getattr(c, name)
        if val != legacy:
            out.append(f"tunable {name} {val}")
    out += ["", "# devices"]
    for dev in range(c.max_devices):
        name = w.name_map.get(dev, f"device{dev}")
        cls = w.class_map.get(dev)
        suffix = f" class {w.class_name[cls]}" if cls is not None else ""
        out.append(f"device {dev} {name}{suffix}")
    out += ["", "# types"]
    for tid in sorted(w.type_map):
        out.append(f"type {tid} {w.type_map[tid]}")
    out += ["", "# buckets"]
    emitted: set[int] = set()

    def emit_bucket(bid: int) -> None:
        b = c.bucket(bid)
        if b is None or bid in emitted:
            return
        for child in b.items:
            if child < 0:
                emit_bucket(child)
        emitted.add(bid)
        tname = w.type_map.get(b.type, str(b.type))
        name = w.name_map.get(bid, f"bucket{-1 - bid}")
        out.append(f"{tname} {name} {{")
        out.append(f"\tid {bid}\t\t# do not change unnecessarily")
        out.append(f"\t# weight {_wf(b.weight)}")
        out.append(f"\talg {ALG_NAMES.get(b.alg, str(b.alg))}")
        out.append(f"\thash {b.hash}\t# rjenkins1")
        for item, iw in zip(b.items, b.item_weights):
            iname = w.name_map.get(item, f"device{item}" if item >= 0
                                   else f"bucket{-1 - item}")
            out.append(f"\titem {iname} weight {_wf(iw)}")
        out.append("}")

    for b in c.buckets:
        if b is not None:
            emit_bucket(b.id)
    out += ["", "# rules"]
    for rid, rule in enumerate(c.rules):
        if rule is None:
            continue
        name = w.rule_name_map.get(rid, f"rule{rid}")
        out.append(f"rule {name} {{")
        out.append(f"\tid {rule.mask.ruleset}")
        rtype = "replicated" if rule.mask.type == RULE_TYPE_REPLICATED \
            else "erasure" if rule.mask.type == RULE_TYPE_ERASURE \
            else str(rule.mask.type)
        out.append(f"\ttype {rtype}")
        out.append(f"\tmin_size {rule.mask.min_size}")
        out.append(f"\tmax_size {rule.mask.max_size}")
        for s in rule.steps:
            if s.op == CRUSH_RULE_TAKE:
                tn = w.name_map.get(s.arg1, str(s.arg1))
                out.append(f"\tstep take {tn}")
            elif s.op in (CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSE_INDEP,
                          CRUSH_RULE_CHOOSELEAF_FIRSTN,
                          CRUSH_RULE_CHOOSELEAF_INDEP):
                verb = "choose" if s.op in (CRUSH_RULE_CHOOSE_FIRSTN,
                                            CRUSH_RULE_CHOOSE_INDEP) \
                    else "chooseleaf"
                mode = "firstn" if s.op in (CRUSH_RULE_CHOOSE_FIRSTN,
                                            CRUSH_RULE_CHOOSELEAF_FIRSTN) \
                    else "indep"
                tname = w.type_map.get(s.arg2, str(s.arg2))
                out.append(f"\tstep {verb} {mode} {s.arg1} type {tname}")
            elif s.op in SET_STEPS:
                out.append(f"\tstep {SET_STEPS[s.op]} {s.arg1}")
            elif s.op == CRUSH_RULE_EMIT:
                out.append("\tstep emit")
            else:
                raise CompileError(f"cannot decompile step op {s.op}")
        out.append("}")
        out.append("")
    if out[-1] == "":
        out.pop()
    out += ["", "# end crush map"]
    return "\n".join(out) + "\n"


# ------------------------------------------------------------------ compile
def _tokens(text: str):
    """Strip comments, split into per-line token lists."""
    for line in text.splitlines():
        line = line.split("#", 1)[0]
        # brace on its own or trailing: tokenize with spaces
        line = line.replace("{", " { ").replace("}", " } ")
        toks = line.split()
        if toks:
            yield toks


def compile_crushmap(text: str) -> CrushWrapper:
    """(ref: CrushCompiler.cc:1090 compile; grammar CrushCompiler.h)."""
    w = CrushWrapper()
    w.type_map = {}
    lines = list(_tokens(text))
    i = 0
    # O(1) name lookups (get_item_id scans; a 10k-device map would be
    # quadratic through it)
    item_ids: dict[str, int] = {}

    def parse_bucket(head, body):
        tname, name = head[0], head[1]
        tid = w.get_type_id(tname)
        if tid < 0:
            raise CompileError(f"unknown bucket type {tname!r}")
        if name in item_ids:
            raise CompileError(f"duplicate name {name!r}")
        bid = None
        alg = CRUSH_BUCKET_STRAW2
        hash_ = 0
        items: list[tuple[int, int]] = []
        for toks in body:
            if toks[0] == "id":
                bid = int(toks[1])
                if bid >= 0:
                    raise CompileError("bucket id must be negative")
                if w.crush.bucket(bid) is not None:
                    raise CompileError(f"duplicate bucket id {bid}")
            elif toks[0] == "alg":
                if toks[1] not in ALG_IDS:
                    raise CompileError(f"unknown alg {toks[1]!r}")
                alg = ALG_IDS[toks[1]]
            elif toks[0] == "hash":
                hash_ = int(toks[1])
            elif toks[0] == "item":
                iname = toks[1]
                iid = item_ids.get(iname)
                if iid is None:
                    raise CompileError(f"item {iname!r} not defined")
                weight = 0x10000
                j = 2
                while j < len(toks):
                    if toks[j] == "weight":
                        weight = int(round(float(toks[j + 1]) * 0x10000))
                        j += 2
                    elif toks[j] == "pos":
                        j += 2  # positions implied by order
                    else:
                        raise CompileError(
                            f"bad item modifier {toks[j]!r}")
                items.append((iid, weight))
            else:
                raise CompileError(f"bad bucket line {' '.join(toks)!r}")
        b = CrushBucket(id=bid if bid is not None else 0, type=tid,
                        alg=alg, hash=hash_,
                        items=[it for it, _ in items],
                        item_weights=[iw for _, iw in items],
                        weight=sum(iw for _, iw in items))
        bid = w.crush.add_bucket(b)
        w.name_map[bid] = name
        item_ids[name] = bid

    def parse_rule(head, body):
        name = head[0]
        mask = CrushRuleMask()
        steps: list[CrushRuleStep] = []
        rid = None
        for toks in body:
            if toks[0] in ("id", "ruleset"):      # pre-luminous synonym
                rid = int(toks[1])
                mask.ruleset = rid
            elif toks[0] == "type":
                mask.type = {"replicated": RULE_TYPE_REPLICATED,
                             "erasure": RULE_TYPE_ERASURE}.get(
                    toks[1], int(toks[1]) if toks[1].isdigit() else None)
                if mask.type is None:
                    raise CompileError(f"bad rule type {toks[1]!r}")
            elif toks[0] == "min_size":
                mask.min_size = int(toks[1])
            elif toks[0] == "max_size":
                mask.max_size = int(toks[1])
            elif toks[0] == "step":
                verb = toks[1]
                if verb == "take":
                    item = item_ids.get(toks[2])
                    if item is None:
                        raise CompileError(
                            f"step take: unknown item {toks[2]!r}")
                    steps.append(CrushRuleStep(CRUSH_RULE_TAKE, item, 0))
                elif verb in ("choose", "chooseleaf"):
                    mode = toks[2]
                    num = int(toks[3])
                    if toks[4] != "type":
                        raise CompileError("expected 'type'")
                    tid = w.get_type_id(toks[5])
                    if tid < 0:
                        raise CompileError(
                            f"unknown type {toks[5]!r}")
                    op = {
                        ("choose", "firstn"): CRUSH_RULE_CHOOSE_FIRSTN,
                        ("choose", "indep"): CRUSH_RULE_CHOOSE_INDEP,
                        ("chooseleaf", "firstn"):
                            CRUSH_RULE_CHOOSELEAF_FIRSTN,
                        ("chooseleaf", "indep"):
                            CRUSH_RULE_CHOOSELEAF_INDEP,
                    }.get((verb, mode))
                    if op is None:
                        raise CompileError(f"bad mode {mode!r}")
                    steps.append(CrushRuleStep(op, num, tid))
                elif verb in SET_STEP_IDS:
                    steps.append(CrushRuleStep(SET_STEP_IDS[verb],
                                               int(toks[2]), 0))
                elif verb == "emit":
                    steps.append(CrushRuleStep(CRUSH_RULE_EMIT))
                else:
                    raise CompileError(f"unknown step {verb!r}")
            else:
                raise CompileError(f"bad rule line {' '.join(toks)!r}")
        rule = CrushRule(steps=steps, mask=mask)
        if rid is None:
            rid = len(w.crush.rules)
            mask.ruleset = rid
        while len(w.crush.rules) <= rid:
            w.crush.rules.append(None)
        if w.crush.rules[rid] is not None:
            raise CompileError(f"duplicate rule id {rid}")
        w.crush.rules[rid] = rule
        w.rule_name_map[rid] = name

    while i < len(lines):
        toks = lines[i]
        if toks[0] == "tunable":
            if toks[1] not in LEGACY_TUNABLES:
                raise CompileError(f"unknown tunable {toks[1]!r}")
            setattr(w.crush, toks[1], int(toks[2]))
            i += 1
        elif toks[0] == "device":
            dev = int(toks[1])
            name = toks[2]
            w.name_map[dev] = name
            item_ids[name] = dev
            w.crush.max_devices = max(w.crush.max_devices, dev + 1)
            if len(toks) >= 5 and toks[3] == "class":
                w.class_map[dev] = w.class_id_or_create(toks[4])
            i += 1
        elif toks[0] == "type":
            w.type_map[int(toks[1])] = toks[2]
            i += 1
        elif toks[0] == "rule" or (len(toks) >= 3 and toks[2] == "{") or \
                (len(toks) >= 2 and toks[-1] == "{"):
            # block: rule <name> { ... }  or  <type> <name> { ... }
            is_rule = toks[0] == "rule"
            head = toks[1:2] if is_rule else toks[0:2]
            body = []
            if toks[-1] != "{":
                raise CompileError(f"expected '{{' in {' '.join(toks)!r}")
            i += 1
            while i < len(lines) and lines[i] != ["}"]:
                body.append(lines[i])
                i += 1
            if i >= len(lines):
                raise CompileError("unterminated block")
            i += 1  # consume }
            if is_rule:
                parse_rule(head, body)
            else:
                parse_bucket(head, body)
        else:
            raise CompileError(f"cannot parse {' '.join(toks)!r}")
    if not w.type_map:
        raise CompileError("no types defined")
    return w
