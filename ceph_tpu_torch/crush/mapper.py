"""Scalar CRUSH mapping engine — the bit-exact reference oracle.

Faithful reimplementation of the CRUSH placement algorithm
(ref: src/crush/mapper.c): rule interpreter `do_rule` (:900), depth-first
`choose_firstn` with the reject/collision retry cascade (:460), breadth-first
positionally-stable `choose_indep` (:655), straw2 exponential-sampling argmax
via the fixed-point ln table (:248,:334,:361), straw/list/tree/uniform bucket
algorithms (:73-260), probabilistic reweight out-test `is_out` (:424).

All arithmetic is done with explicit 32/64-bit masking to match the C
semantics exactly; the batch mapper (`batch.py`) is validated against this
module, and this module is validated against fixture vectors of the C core.

The engine runs one input x at a time.  straw2 evaluates the items of a
bucket with numpy (one vectorised hash, an ln table built from the scalar
`crush_ln`, truncating division), which keeps a 500-item bucket cheap
enough for the identity samples of a 10,000-OSD map; the choice is still
the C core's first highest draw.
"""
from __future__ import annotations

import functools

import numpy as np

from .hashes import hash32_2_int, hash32_3, hash32_4
from ._ln_tables import RH_LH_TBL, LL_TBL
from .types import (
    CRUSH_BUCKET_LIST, CRUSH_BUCKET_STRAW, CRUSH_BUCKET_STRAW2,
    CRUSH_BUCKET_TREE, CRUSH_BUCKET_UNIFORM, CRUSH_ITEM_NONE,
    CRUSH_ITEM_UNDEF, CRUSH_RULE_CHOOSELEAF_FIRSTN,
    CRUSH_RULE_CHOOSELEAF_INDEP, CRUSH_RULE_CHOOSE_FIRSTN,
    CRUSH_RULE_CHOOSE_INDEP, CRUSH_RULE_EMIT,
    CRUSH_RULE_SET_CHOOSELEAF_STABLE, CRUSH_RULE_SET_CHOOSELEAF_TRIES,
    CRUSH_RULE_SET_CHOOSELEAF_VARY_R,
    CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES, CRUSH_RULE_SET_CHOOSE_TRIES,
    CRUSH_RULE_TAKE, ChooseArg, CrushBucket, CrushMap,
)

S64_MIN = -(1 << 63)
_U16 = 0xFFFF
_U64 = (1 << 64) - 1


def crush_ln(xin: int) -> int:
    """2^44 * log2(input+1), fixed point (ref: mapper.c:247-289)."""
    x = (xin + 1) & 0xFFFFFFFF
    iexpon = 15
    if not (x & 0x18000):
        # clz(x & 0x1FFFF) - 16 for a 32-bit clz
        x17 = x & 0x1FFFF
        bits = (32 - x17.bit_length()) - 16
        x = (x << bits) & 0xFFFFFFFF
        iexpon = 15 - bits
    index1 = (x >> 8) << 1
    RH = RH_LH_TBL[index1 - 256]
    LH = RH_LH_TBL[index1 + 1 - 256]
    xl64 = (x * RH) >> 48
    result = iexpon << 44
    index2 = xl64 & 0xFF
    LL = LL_TBL[index2]
    LH = LH + LL
    LH >>= (48 - 12 - 32)
    return result + LH


class CrushWork:
    """Per-computation workspace for permutation buckets
    (ref: mapper.c crush_init_workspace / crush_work_bucket)."""

    def __init__(self) -> None:
        self.perm: dict[int, dict] = {}

    def bucket(self, bucket_id: int) -> dict:
        st = self.perm.get(bucket_id)
        if st is None:
            st = {"perm_x": 0, "perm_n": 0, "perm": []}
            self.perm[bucket_id] = st
        return st


def bucket_perm_choose(bucket: CrushBucket, work: dict, x: int, r: int) -> int:
    """ref: mapper.c:73-131."""
    pr = r % bucket.size
    if work["perm_x"] != (x & 0xFFFFFFFF) or work["perm_n"] == 0:
        work["perm_x"] = x & 0xFFFFFFFF
        if pr == 0:
            s = int(hash32_3(x, bucket.id, 0)) % bucket.size
            work["perm"] = [s] + [0] * (bucket.size - 1)
            work["perm_n"] = 0xFFFF
            return bucket.items[s]
        work["perm"] = list(range(bucket.size))
        work["perm_n"] = 0
    elif work["perm_n"] == 0xFFFF:
        perm = list(range(bucket.size))
        perm[work["perm"][0]] = 0
        perm[0] = work["perm"][0]
        work["perm"] = perm
        work["perm_n"] = 1
    while work["perm_n"] <= pr:
        p = work["perm_n"]
        if p < bucket.size - 1:
            i = int(hash32_3(x, bucket.id, p)) % (bucket.size - p)
            if i:
                work["perm"][p + i], work["perm"][p] = \
                    work["perm"][p], work["perm"][p + i]
        work["perm_n"] += 1
    return bucket.items[work["perm"][pr]]


def bucket_list_choose(bucket: CrushBucket, x: int, r: int) -> int:
    """ref: mapper.c:141-162 (sum_weights computed as suffix sums)."""
    sums = _list_sum_weights(bucket)
    for i in range(bucket.size - 1, -1, -1):
        w = int(hash32_4(x, bucket.items[i], r, bucket.id)) & _U16
        w *= sums[i]
        w >>= 16
        if w < bucket.item_weights[i]:
            return bucket.items[i]
    return bucket.items[0]


def _list_sum_weights(bucket: CrushBucket) -> list[int]:
    # sum_weights[i] = sum of item_weights[0..i] (crush.c list build)
    sums, acc = [], 0
    for w in bucket.item_weights:
        acc += w
        sums.append(acc)
    return sums


def bucket_tree_choose(bucket: CrushBucket, x: int, r: int) -> int:
    """ref: mapper.c:166-205."""
    nw = bucket.node_weights
    assert nw is not None, "tree bucket requires node_weights"
    n = len(nw) >> 1
    while not (n & 1):
        w = nw[n]
        t = (int(hash32_4(x, n, r, bucket.id)) * w) >> 32
        h = 0
        nn = n
        while (nn & 1) == 0:
            h += 1
            nn >>= 1
        left = n - (1 << (h - 1))
        if t < nw[left]:
            n = left
        else:
            n = n + (1 << (h - 1))
    return bucket.items[n >> 1]


def bucket_straw_choose(bucket: CrushBucket, x: int, r: int,
                        straw_calc_version: int = 0) -> int:
    """Legacy straw (v1); straws derived at build time (builder.c
    crush_calc_straw).  ref: mapper.c:226-244."""
    straws = getattr(bucket, "straws", None)
    if straws is None or getattr(bucket, "_straw_ver", None) != straw_calc_version:
        straws = _calc_straws(bucket, straw_calc_version)
        bucket.straws = straws  # type: ignore[attr-defined]
        bucket._straw_ver = straw_calc_version  # type: ignore[attr-defined]
    high, high_draw = 0, 0
    for i in range(bucket.size):
        draw = int(hash32_3(x, bucket.items[i], r)) & _U16
        draw *= straws[i]
        if i == 0 or draw > high_draw:
            high, high_draw = i, draw
    return bucket.items[high]


def _calc_straws(bucket: CrushBucket, version: int = 1) -> list[int]:
    """Straw scaling (ref: src/crush/builder.c:427-543 crush_calc_straw).

    Both straw_calc_version 0 (original, with its numleft quirks preserved)
    and >=1 are implemented; weights are used as raw 16.16 integers cast to
    double, exactly like the C code, so straws match bit-for-bit.
    """
    size = bucket.size
    if size == 0:
        return []
    weights = bucket.item_weights
    # insertion sort ascending by weight; ties keep original order
    reverse = [0] if size else []
    for i in range(1, size):
        for j in range(i):
            if weights[i] < weights[reverse[j]]:
                reverse.insert(j, i)
                break
        else:
            reverse.append(i)
    straws = [0] * size
    numleft = size
    straw = 1.0
    wbelow = 0.0
    lastw = 0.0
    i = 0
    while i < size:
        if version == 0:
            if weights[reverse[i]] == 0:
                straws[reverse[i]] = 0
                i += 1
                continue
            straws[reverse[i]] = int(straw * 0x10000)
            i += 1
            if i == size:
                break
            if weights[reverse[i]] == weights[reverse[i - 1]]:
                continue
            wbelow += (float(weights[reverse[i - 1]]) - lastw) * numleft
            for j in range(i, size):
                if weights[reverse[j]] == weights[reverse[i]]:
                    numleft -= 1
                else:
                    break
            wnext = numleft * (weights[reverse[i]] - weights[reverse[i - 1]])
            pbelow = wbelow / (wbelow + wnext)
            straw *= (1.0 / pbelow) ** (1.0 / numleft)
            lastw = float(weights[reverse[i - 1]])
        else:
            if weights[reverse[i]] == 0:
                straws[reverse[i]] = 0
                i += 1
                numleft -= 1
                continue
            straws[reverse[i]] = int(straw * 0x10000)
            i += 1
            if i == size:
                break
            wbelow += (float(weights[reverse[i - 1]]) - lastw) * numleft
            numleft -= 1
            wnext = numleft * (weights[reverse[i]] - weights[reverse[i - 1]])
            pbelow = wbelow / (wbelow + wnext)
            straw *= (1.0 / pbelow) ** (1.0 / numleft)
            lastw = float(weights[reverse[i - 1]])
    return straws


def _choose_arg_weights(bucket: CrushBucket, arg: ChooseArg | None,
                        position: int) -> list[int]:
    if arg is None or arg.weight_set is None:
        return bucket.item_weights
    if position >= len(arg.weight_set):
        position = len(arg.weight_set) - 1
    return arg.weight_set[position]


def _choose_arg_ids(bucket: CrushBucket, arg: ChooseArg | None) -> list[int]:
    if arg is None or arg.ids is None:
        return bucket.items
    return arg.ids


@functools.lru_cache(maxsize=1)
def _ln_u16() -> np.ndarray:
    """crush_ln(u) for every 16-bit u, from the scalar function."""
    return np.array([crush_ln(u) for u in range(1 << 16)], dtype=np.int64)


def bucket_straw2_choose(bucket: CrushBucket, x: int, r: int,
                         arg: ChooseArg | None, position: int) -> int:
    """ref: mapper.c:361-390: for each item i, draw =
    div64_s64(crush_ln(hash(x, id_i, r) & 0xffff) - 2^48, w_i), or S64_MIN
    where w_i is 0; the first item with the highest draw wins."""
    weights = np.asarray(_choose_arg_weights(bucket, arg, position),
                         dtype=np.int64)[:bucket.size]
    ids = np.asarray(_choose_arg_ids(bucket, arg),
                     dtype=np.int64)[:bucket.size]
    u = hash32_3(x, ids, r).astype(np.int64) & _U16
    ln = _ln_u16()[u] - 0x1000000000000
    nz = weights != 0
    q = np.abs(ln) // np.where(nz, np.abs(weights), 1)
    draws = np.where((ln < 0) != (weights < 0), -q, q)
    draws = np.where(nz, draws, np.int64(S64_MIN))
    return bucket.items[int(np.argmax(draws))]


def crush_bucket_choose(bucket: CrushBucket, work: CrushWork, x: int, r: int,
                        arg: ChooseArg | None, position: int,
                        straw_calc_version: int = 0) -> int:
    """ref: mapper.c:387-421."""
    assert bucket.size > 0
    if bucket.alg == CRUSH_BUCKET_UNIFORM:
        return bucket_perm_choose(bucket, work.bucket(bucket.id), x, r)
    if bucket.alg == CRUSH_BUCKET_LIST:
        return bucket_list_choose(bucket, x, r)
    if bucket.alg == CRUSH_BUCKET_TREE:
        return bucket_tree_choose(bucket, x, r)
    if bucket.alg == CRUSH_BUCKET_STRAW:
        return bucket_straw_choose(bucket, x, r, straw_calc_version)
    if bucket.alg == CRUSH_BUCKET_STRAW2:
        return bucket_straw2_choose(bucket, x, r, arg, position)
    return bucket.items[0]


def is_out(map_: CrushMap, weight: list[int], item: int, x: int) -> bool:
    """Probabilistic reweight rejection (ref: mapper.c:424-441)."""
    if item >= len(weight):
        return True
    w = weight[item]
    if w >= 0x10000:
        return False
    if w == 0:
        return True
    return (hash32_2_int(x, item) & _U16) >= w


def _arg_for(choose_args, bucket: CrushBucket) -> ChooseArg | None:
    if not choose_args:
        return None
    return choose_args.get(bucket.id)


def choose_firstn(map_: CrushMap, work: CrushWork, bucket: CrushBucket,
                  weight: list[int], x: int, numrep: int, type_: int,
                  out: list[int], outpos: int, out_size: int,
                  tries: int, recurse_tries: int, local_retries: int,
                  local_fallback_retries: int, recurse_to_leaf: bool,
                  vary_r: int, stable: int, out2: list[int] | None,
                  parent_r: int, choose_args) -> int:
    """Depth-first replica choose with retry cascade (ref: mapper.c:460-645)."""
    count = out_size
    rep = 0 if stable else outpos
    while rep < numrep and count > 0:
        ftotal = 0
        skip_rep = False
        retry_descent = True
        while retry_descent:
            retry_descent = False
            in_ = bucket
            flocal = 0
            retry_bucket = True
            while retry_bucket:
                retry_bucket = False
                collide = False
                r = rep + parent_r + ftotal
                if in_.size == 0:
                    reject = True
                    item = 0
                else:
                    if (local_fallback_retries > 0 and
                            flocal >= (in_.size >> 1) and
                            flocal > local_fallback_retries):
                        item = bucket_perm_choose(
                            in_, work.bucket(in_.id), x, r)
                    else:
                        item = crush_bucket_choose(
                            in_, work, x, r, _arg_for(choose_args, in_),
                            outpos, map_.straw_calc_version)
                    if item >= map_.max_devices:
                        skip_rep = True
                        break
                    itemtype = map_.bucket(item).type if item < 0 else 0
                    if itemtype != type_:
                        if item >= 0 or (-1 - item) >= map_.max_buckets:
                            skip_rep = True
                            break
                        in_ = map_.bucket(item)
                        retry_bucket = True
                        continue
                    for i in range(outpos):
                        if out[i] == item:
                            collide = True
                            break
                    reject = False
                    if not collide and recurse_to_leaf:
                        if item < 0:
                            sub_r = r >> (vary_r - 1) if vary_r else 0
                            got = choose_firstn(
                                map_, work, map_.bucket(item), weight, x,
                                1 if stable else outpos + 1, 0,
                                out2, outpos, count,
                                recurse_tries, 0, local_retries,
                                local_fallback_retries, False,
                                vary_r, stable, None, sub_r, choose_args)
                            if got <= outpos:
                                reject = True
                        else:
                            out2[outpos] = item
                    if not reject and not collide and itemtype == 0:
                        reject = is_out(map_, weight, item, x)
                if reject or collide:
                    ftotal += 1
                    flocal += 1
                    if collide and flocal <= local_retries:
                        retry_bucket = True
                    elif (local_fallback_retries > 0 and
                          flocal <= in_.size + local_fallback_retries):
                        retry_bucket = True
                    elif ftotal < tries:
                        retry_descent = True
                        break
                    else:
                        skip_rep = True
                        break
        if not skip_rep:
            out[outpos] = item
            outpos += 1
            count -= 1
        rep += 1
    return outpos


def choose_indep(map_: CrushMap, work: CrushWork, bucket: CrushBucket,
                 weight: list[int], x: int, left: int, numrep: int,
                 type_: int, out: list[int], outpos: int, tries: int,
                 recurse_tries: int, recurse_to_leaf: bool,
                 out2: list[int] | None, parent_r: int, choose_args) -> None:
    """Breadth-first positionally-stable choose — the EC path
    (ref: mapper.c:655-830)."""
    endpos = outpos + left
    for rep in range(outpos, endpos):
        out[rep] = CRUSH_ITEM_UNDEF
        if out2 is not None:
            out2[rep] = CRUSH_ITEM_UNDEF
    ftotal = 0
    while left > 0 and ftotal < tries:
        for rep in range(outpos, endpos):
            if out[rep] != CRUSH_ITEM_UNDEF:
                continue
            in_ = bucket
            while True:
                r = rep + parent_r
                if (in_.alg == CRUSH_BUCKET_UNIFORM and
                        in_.size % numrep == 0):
                    r += (numrep + 1) * ftotal
                else:
                    r += numrep * ftotal
                if in_.size == 0:
                    break
                item = crush_bucket_choose(
                    in_, work, x, r, _arg_for(choose_args, in_), outpos,
                    map_.straw_calc_version)
                if item >= map_.max_devices:
                    out[rep] = CRUSH_ITEM_NONE
                    if out2 is not None:
                        out2[rep] = CRUSH_ITEM_NONE
                    left -= 1
                    break
                itemtype = map_.bucket(item).type if item < 0 else 0
                if itemtype != type_:
                    if item >= 0 or (-1 - item) >= map_.max_buckets:
                        out[rep] = CRUSH_ITEM_NONE
                        if out2 is not None:
                            out2[rep] = CRUSH_ITEM_NONE
                        left -= 1
                        break
                    in_ = map_.bucket(item)
                    continue
                collide = False
                for i in range(outpos, endpos):
                    if out[i] == item:
                        collide = True
                        break
                if collide:
                    break
                if recurse_to_leaf:
                    if item < 0:
                        choose_indep(
                            map_, work, map_.bucket(item), weight, x, 1,
                            numrep, 0, out2, rep, recurse_tries, 0,
                            False, None, r, choose_args)
                        if out2[rep] == CRUSH_ITEM_NONE:
                            break
                    else:
                        out2[rep] = item
                if itemtype == 0 and is_out(map_, weight, item, x):
                    break
                out[rep] = item
                left -= 1
                break
        ftotal += 1
    for rep in range(outpos, endpos):
        if out[rep] == CRUSH_ITEM_UNDEF:
            out[rep] = CRUSH_ITEM_NONE
        if out2 is not None and out2[rep] == CRUSH_ITEM_UNDEF:
            out2[rep] = CRUSH_ITEM_NONE


def do_rule(map_: CrushMap, ruleno: int, x: int, result_max: int,
            weight: list[int], choose_args=None) -> list[int]:
    """Rule-step interpreter (ref: mapper.c:900-1105).  Returns the result
    vector (devices, or CRUSH_ITEM_NONE holes for indep rules)."""
    if ruleno >= len(map_.rules) or map_.rules[ruleno] is None:
        return []
    if isinstance(choose_args, str):
        choose_args = map_.choose_args.get(choose_args)
    rule = map_.rules[ruleno]
    work = CrushWork()
    result: list[int] = []
    w: list[int] = []
    choose_tries = map_.choose_total_tries + 1
    choose_leaf_tries = 0
    choose_local_retries = map_.choose_local_tries
    choose_local_fallback_retries = map_.choose_local_fallback_tries
    vary_r = map_.chooseleaf_vary_r
    stable = map_.chooseleaf_stable

    for step in rule.steps:
        if step.op == CRUSH_RULE_TAKE:
            ok_dev = 0 <= step.arg1 < map_.max_devices
            ok_bkt = step.arg1 < 0 and map_.bucket(step.arg1) is not None
            if ok_dev or ok_bkt:
                w = [step.arg1]
        elif step.op == CRUSH_RULE_SET_CHOOSE_TRIES:
            if step.arg1 > 0:
                choose_tries = step.arg1
        elif step.op == CRUSH_RULE_SET_CHOOSELEAF_TRIES:
            if step.arg1 > 0:
                choose_leaf_tries = step.arg1
        elif step.op == CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES:
            if step.arg1 >= 0:
                choose_local_retries = step.arg1
        elif step.op == CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES:
            if step.arg1 >= 0:
                choose_local_fallback_retries = step.arg1
        elif step.op == CRUSH_RULE_SET_CHOOSELEAF_VARY_R:
            if step.arg1 >= 0:
                vary_r = step.arg1
        elif step.op == CRUSH_RULE_SET_CHOOSELEAF_STABLE:
            if step.arg1 >= 0:
                stable = step.arg1
        elif step.op in (CRUSH_RULE_CHOOSELEAF_FIRSTN, CRUSH_RULE_CHOOSE_FIRSTN,
                         CRUSH_RULE_CHOOSELEAF_INDEP, CRUSH_RULE_CHOOSE_INDEP):
            if not w:
                continue
            firstn = step.op in (CRUSH_RULE_CHOOSELEAF_FIRSTN,
                                 CRUSH_RULE_CHOOSE_FIRSTN)
            recurse_to_leaf = step.op in (CRUSH_RULE_CHOOSELEAF_FIRSTN,
                                          CRUSH_RULE_CHOOSELEAF_INDEP)
            # each take item writes into its own output segment starting
            # at position 0 (the C core passes o+osize with j=0,
            # mapper.c:1038-1070): collision scans and the rep counter
            # are segment-relative
            o: list[int] = [0] * result_max
            c: list[int] = [0] * result_max
            osize = 0
            for wi in w:
                numrep = step.arg1
                if numrep <= 0:
                    numrep += result_max
                    if numrep <= 0:
                        continue
                if wi >= 0 or (-1 - wi) >= map_.max_buckets:
                    continue
                bucket = map_.bucket(wi)
                if bucket is None:
                    continue
                seg = result_max - osize
                seg_o: list[int] = [0] * seg
                seg_c: list[int] = [0] * seg
                if firstn:
                    if choose_leaf_tries:
                        recurse_tries = choose_leaf_tries
                    elif map_.chooseleaf_descend_once:
                        recurse_tries = 1
                    else:
                        recurse_tries = choose_tries
                    got = choose_firstn(
                        map_, work, bucket, weight, x, numrep, step.arg2,
                        seg_o, 0, seg, choose_tries,
                        recurse_tries, choose_local_retries,
                        choose_local_fallback_retries, recurse_to_leaf,
                        vary_r, stable, seg_c, 0, choose_args)
                else:
                    got = min(numrep, seg)
                    choose_indep(
                        map_, work, bucket, weight, x, got, numrep,
                        step.arg2, seg_o, 0, choose_tries,
                        choose_leaf_tries if choose_leaf_tries else 1,
                        recurse_to_leaf, seg_c, 0, choose_args)
                o[osize:osize + got] = seg_o[:got]
                c[osize:osize + got] = seg_c[:got]
                osize += got
            if recurse_to_leaf:
                o[:osize] = c[:osize]
            w = o[:osize]
        elif step.op == CRUSH_RULE_EMIT:
            for item in w:
                if len(result) < result_max:
                    result.append(item)
            w = []
    return result
