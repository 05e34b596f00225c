"""Batched CRUSH mapper: `do_rule` over many placement seeds at once.

The port's replacement for the reference's bulk placement paths
(OSDMapMapping/ParallelPGMapper src/osd/OSDMapMapping.h:18, CrushTester,
osdmaptool --test-map-pgs): the CRUSH map is compiled to flat tables that
stay on the device, and `do_rule` runs for every seed x of a batch.

Two forms of the same function, bit-exact with each other and with the
scalar engine (`mapper.py`, itself checked against the C core):

* K3 `crush_do_rule_cuda`: a CUDA kernel written by hand for Hopper
  (`kernels/csrc/crush_rule.cu`), one thread per seed, each thread
  interpreting the rule's steps.  Counterpart of the reference package's
  `jit(vmap(_do_rule_one))`.
* `map_batch_plain`: the reference's vmapped rule with the batch dimension
  written out in int64 torch.  Each `lax.while_loop` is a Python loop
  `while cond.any()` whose body runs for every lane and whose result is
  kept where the lane's condition held; each `lax.scan` is a Python loop.
  It carries both straw2 formulations (per-item ln, and the weight-class
  shortcut), selected by `compile_map(class_path=...)`.

`CompiledCrushMap.map_batch` launches K3 on a cuda map and runs the plain
version on a cpu map.  Nothing falls back from one to the other.  It
stages the seeds, the weights and the rule's steps first and launches K3
inside a region of the device guard (common/devguard.py).

Restrictions (compile_map / map_batch raise BatchUnsupported; callers use
the scalar engine): straw2 buckets only, rjenkins1 only,
choose_local_fallback_tries == 0, result_max <= CRUSH_MAX_RESULT.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import device as _device
from ..common import devguard
from ..ec.kernels import _build
from ._ln_tables import LL_TBL, RH_LH_TBL
from .types import (
    CRUSH_BUCKET_STRAW2, CRUSH_HASH_RJENKINS1, CRUSH_ITEM_NONE,
    CRUSH_ITEM_UNDEF, CRUSH_RULE_CHOOSELEAF_FIRSTN,
    CRUSH_RULE_CHOOSELEAF_INDEP, CRUSH_RULE_CHOOSE_FIRSTN,
    CRUSH_RULE_CHOOSE_INDEP, CRUSH_RULE_EMIT,
    CRUSH_RULE_SET_CHOOSELEAF_STABLE, CRUSH_RULE_SET_CHOOSELEAF_TRIES,
    CRUSH_RULE_SET_CHOOSELEAF_VARY_R,
    CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES, CRUSH_RULE_SET_CHOOSE_TRIES,
    CRUSH_RULE_TAKE, CrushMap,
)

S64_MIN = -(1 << 62)  # below any real draw (draws are > -2^49)
U16 = 0xFFFF
U32 = 0xFFFFFFFF
LN_BIAS = 0x1000000000000

_SEED = 1315423911
_X0 = 231232
_Y0 = 1232

#: the kernel keeps each seed's result, working vector and segments in
#: arrays of this many entries (kMaxResult in crush_rule.cu); map_batch
#: refuses a larger result_max
CRUSH_MAX_RESULT = 32

#: seeds per pass of the plain version (bounds its (N, I) temporaries)
PLAIN_CHUNK = 1 << 16

# descend outcome codes
_HIT, _EMPTY, _BAD = 0, 1, 2

_CHOOSE_OPS = (CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSE_INDEP,
               CRUSH_RULE_CHOOSELEAF_FIRSTN, CRUSH_RULE_CHOOSELEAF_INDEP)

#: launches of each CUDA kernel, counted by its wrapper at the launch
LAUNCHES = {"crush_do_rule": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class BatchUnsupported(ValueError):
    """Raised when a map/rule cannot run on the batch path."""


# ---------------------------------------------------------------------------
# rjenkins1 in int64 torch (ref: src/crush/hash.c:12-113): every value is
# kept in [0, 2^32) by masking after each subtraction and left shift, so
# the right shifts are logical.

def _mix(a, b, c):
    a = (a - b - c) & U32; a = a ^ (c >> 13)
    b = (b - c - a) & U32; b = b ^ ((a << 8) & U32)
    c = (c - a - b) & U32; c = c ^ (b >> 13)
    a = (a - b - c) & U32; a = a ^ (c >> 12)
    b = (b - c - a) & U32; b = b ^ ((a << 16) & U32)
    c = (c - a - b) & U32; c = c ^ (b >> 5)
    a = (a - b - c) & U32; a = a ^ (c >> 3)
    b = (b - c - a) & U32; b = b ^ ((a << 10) & U32)
    c = (c - a - b) & U32; c = c ^ (b >> 15)
    return a, b, c


def _u32(v) -> torch.Tensor:
    """Low 32 bits of an integer tensor, as int64 in [0, 2^32)."""
    return v.to(torch.int64) & U32


def jhash2(a, b) -> torch.Tensor:
    """crush_hash32_2 of integer tensors (broadcast), int64 in [0, 2^32)."""
    a, b = _u32(a), _u32(b)
    h = _SEED ^ a ^ b
    a, b, h = _mix(a, b, h)
    x, a, h = _mix(_X0, a, h)
    b, y, h = _mix(b, _Y0, h)
    return h


def jhash3(a, b, c) -> torch.Tensor:
    """crush_hash32_3 of integer tensors (broadcast), int64 in [0, 2^32)."""
    a, b, c = _u32(a), _u32(b), _u32(c)
    h = _SEED ^ a ^ b ^ c
    x = _X0
    y = _Y0
    a, b, h = _mix(a, b, h)
    c, x, h = _mix(c, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    return h


# ---------------------------------------------------------------------------
# fixed-point ln over the 16-bit straw2 domain (ref: src/crush/mapper.c:
# 247-289), built on the host in int64 numpy

_RH_LH = np.asarray(RH_LH_TBL, dtype=np.int64)
_LL = np.asarray(LL_TBL, dtype=np.int64)


def _build_ln16_table() -> np.ndarray:
    """crush_ln(u) for every u in [0, 0xFFFF].  crush_ln's (x*RH)>>48
    product exceeds int64, so it is taken in split 32-bit limbs."""
    x = (np.arange(65536, dtype=np.int64) + 1) & 0xFFFFFFFF
    x17 = x & 0x1FFFF
    bl = np.zeros_like(x17)
    for k in range(17):
        bl += (x17 >= (1 << k)).astype(np.int64)
    bits = 16 - bl
    need = (x & 0x18000) == 0
    xn = np.where(need, x << np.clip(bits, 0, 16), x)
    iexpon = np.where(need, 15 - bits, 15)
    index1 = (xn >> 8) << 1
    RH = _RH_LH[index1 - 256]
    LH = _RH_LH[index1 + 1 - 256]
    p_lo = xn * (RH & 0xFFFFFFFF)
    p_hi = xn * (RH >> 32)
    xl64 = ((p_lo + ((p_hi & 0xFFFF) << 32)) >> 48) + (p_hi >> 16)
    LL = _LL[xl64 & 0xFF]
    return (iexpon << 44) + ((LH + LL) >> 4)


#: ln(u+1) for every u in [0, 0xFFFF] — the straw2 table
_LN16 = _build_ln16_table()

# crush_ln is monotone in u EXCEPT at the very top: u=65535 normalizes
# x=u+1=0x10000 with iexpon capped at 15, so its value dips BELOW
# ln(65534) (and sits above ln(65533)).  The weight-class straw2 path
# relies on monotonicity, so it orders hashes through a key space that
# swaps that single pair; if the table ever broke differently, the class
# path would disable itself.
_LN16_DIPS = np.nonzero(np.diff(_LN16) < 0)[0]
LN16_MONO_BY_SWAP = (
    len(_LN16_DIPS) == 0
    or (len(_LN16_DIPS) == 1 and int(_LN16_DIPS[0]) == 65534
        and _LN16[65533] <= _LN16[65535]))

#: class-path cutoff: with more distinct weights per bucket than this,
#: the masked per-class max costs more than the ln gathers it saves
CLASS_PATH_MAX = 16


@functools.lru_cache(maxsize=8)
def _ln16_on(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_LN16).to(device)


def _mono_key(u: torch.Tensor) -> torch.Tensor:
    """Involution swapping 65534 and 65535 (identity elsewhere, incl. the
    -1 dead sentinel): the key space where ln16 is monotone."""
    return torch.where(u == 65534, 65535, torch.where(u == 65535, 65534, u))


def _div_trunc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C truncating signed division, b > 0."""
    q = a.abs() // b.clamp(min=1)
    return torch.where(a < 0, -q, q)


# ---------------------------------------------------------------------------
# compiled map

def _int64_on(v, device: torch.device) -> torch.Tensor:
    """A sequence, numpy array or tensor of ints as a contiguous int64
    tensor on `device`."""
    t = v if isinstance(v, torch.Tensor) else \
        torch.from_numpy(np.asarray(v, dtype=np.int64))
    return t.to(device=device, dtype=torch.int64).contiguous()


@dataclass(frozen=True)
class _RuleCfg:
    """What do_rule decides before looking at x, for one (rule,
    result_max): the steps with a precomputed take check, and the map's
    tunables."""
    steps: tuple          # ((op, arg1, arg2, take_ok), ...)
    result_max: int
    tries: int            # choose_total_tries + 1
    local_retries: int
    vary_r: int
    stable: int
    descend_once: int


@dataclass
class CompiledCrushMap:
    """CrushMap flattened to tables on `device` for the batch engine."""
    map_: CrushMap
    device: torch.device
    items: torch.Tensor       # (B, I) int32 — bucket members (pad 0)
    ids: torch.Tensor         # (B, I) int32 — straw2 hash ids (choose_args)
    weights: torch.Tensor     # (P, B, I) int64 — per-position 16.16 weights
    sizes: torch.Tensor       # (B,) int32
    btypes: torch.Tensor      # (B,) int32
    valid: torch.Tensor       # (B,) bool
    max_devices: int
    max_buckets: int
    n_positions: int
    max_depth: int            # longest bucket chain (bound of the descent)
    #: weight-class tables of the plain version's class path: class_of
    #: (P, B, I) int32, -1 for zero-weight/pad lanes; class_w (P, B, C)
    class_of: torch.Tensor
    class_w: torch.Tensor
    n_class_max: int
    use_classes: bool
    #: id of any non-empty bucket (safe target for masked lanes)
    first_valid: int
    _steps_dev: dict = field(default_factory=dict, repr=False)

    # -- public API ---------------------------------------------------------
    def map_batch(self, xs, weight, ruleno=0, result_max=None,
                  return_counts=False):
        """Map a batch of inputs.  xs: (N,) int seeds; weight: (D,) int
        16.16 reweight vector (device in/out/partial).  Returns
        (N, result_max) int32 placements on the map's device
        (CRUSH_ITEM_NONE holes), optionally with per-row result counts.
        K3 on a cuda map, the plain version on a cpu map."""
        cfg = self.rule_cfg(ruleno, result_max)
        xs = _int64_on(xs, self.device)
        weight = _int64_on(weight, self.device)
        if self.device.type == "cuda":
            # staged here, outside the guarded launch
            self.steps_tensor(cfg)
            _ln16_on(self.device)
            with devguard.guard_transfers(self.device):
                res, cnt = crush_do_rule_cuda(self, cfg, xs, weight)
        else:
            res, cnt = map_batch_plain(self, cfg, xs, weight)
        if return_counts:
            return res, cnt
        return res

    def rule_cfg(self, ruleno: int, result_max=None) -> _RuleCfg:
        """Resolve rule `ruleno` for `result_max` (default: the bound of
        its chained choose steps).  Raises BatchUnsupported for a missing
        rule, a choose step with numrep <= 0 and no result_max, a local
        fallback step, or result_max above CRUSH_MAX_RESULT."""
        if not (0 <= ruleno < len(self.map_.rules)) or \
                self.map_.rules[ruleno] is None:
            raise BatchUnsupported(f"no rule {ruleno}")
        rule = self.map_.rules[ruleno]
        if result_max is None:
            # a choose step with arg1 <= 0 means numrep = result_max
            # (mapper.c:972-976): no sensible default exists
            if any(s.op in _CHOOSE_OPS and s.arg1 <= 0 for s in rule.steps):
                raise BatchUnsupported(
                    f"rule {ruleno} has a choose step with numrep <= 0 "
                    "(numrep = result_max - pass result_max explicitly, "
                    "e.g. k+m for an EC rule)")
            # upper bound on emitted results: chained choose steps
            # multiply, emits accumulate
            wmax = 0
            total = 0
            for s in rule.steps:
                if s.op == CRUSH_RULE_TAKE:
                    wmax = 1
                elif s.op in _CHOOSE_OPS:
                    wmax *= s.arg1
                elif s.op == CRUSH_RULE_EMIT:
                    total += wmax
                    wmax = 0
            result_max = max(total, 1)
        result_max = int(result_max)
        if not 1 <= result_max <= CRUSH_MAX_RESULT:
            raise BatchUnsupported(
                f"result_max {result_max} outside [1, {CRUSH_MAX_RESULT}]")
        if any(s.op == CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES and
               s.arg1 > 0 for s in rule.steps):
            raise BatchUnsupported("set_choose_local_fallback_tries > 0")
        m = self.map_
        steps = tuple(
            (st.op, st.arg1, st.arg2,
             bool((0 <= st.arg1 < m.max_devices)
                  or (st.arg1 < 0 and m.bucket(st.arg1) is not None))
             if st.op == CRUSH_RULE_TAKE else False)
            for st in rule.steps)
        return _RuleCfg(steps=steps, result_max=result_max,
                        tries=m.choose_total_tries + 1,
                        local_retries=m.choose_local_tries,
                        vary_r=m.chooseleaf_vary_r,
                        stable=m.chooseleaf_stable,
                        descend_once=m.chooseleaf_descend_once)

    def steps_tensor(self, cfg: _RuleCfg) -> torch.Tensor:
        """(n_steps, 4) int32 rows (op, arg1, arg2, take_ok) on the
        device, staged once per rule."""
        t = self._steps_dev.get(cfg.steps)
        if t is None:
            rows = np.array([[op, a1, a2, int(ok)]
                             for op, a1, a2, ok in cfg.steps],
                            dtype=np.int32).reshape(-1, 4)
            t = self._steps_dev[cfg.steps] = \
                torch.from_numpy(rows).to(self.device)
        return t


def compile_map(map_: CrushMap, choose_args=None,
                class_path: bool | None = None,
                device=None) -> CompiledCrushMap:
    """Flatten a CrushMap for the batch engine (straw2-only) onto
    `device` (None -> cuda).

    class_path: None = auto (on when every bucket has at most
    CLASS_PATH_MAX distinct positive weights per position); True/False
    force it.  It selects the plain version's straw2 formulation; K3
    always evaluates every item."""
    dev = _device.resolve(device)
    if isinstance(choose_args, str):
        choose_args = map_.choose_args.get(choose_args)
    choose_args = choose_args or {}
    B = map_.max_buckets
    I = 1
    P = 1
    for b in map_.buckets:
        if b is None:
            continue
        if b.alg != CRUSH_BUCKET_STRAW2:
            raise BatchUnsupported(
                f"bucket {b.id}: alg {b.alg} not batchable (straw2 only)")
        if b.hash != CRUSH_HASH_RJENKINS1:
            raise BatchUnsupported(f"bucket {b.id}: non-rjenkins hash")
        I = max(I, b.size)
        arg = choose_args.get(b.id)
        if arg is not None and arg.weight_set is not None:
            P = max(P, len(arg.weight_set))
    if map_.choose_local_fallback_tries:
        raise BatchUnsupported("choose_local_fallback_tries > 0")
    # item references must resolve: the scalar engine fails loudly on a
    # dangling bucket id, the batch engine must not silently diverge
    for b in map_.buckets:
        if b is None:
            continue
        for it in b.items:
            if it < 0 and (
                    -1 - it >= B or map_.buckets[-1 - it] is None):
                raise BatchUnsupported(
                    f"bucket {b.id} references missing bucket {it}")
    # longest bucket chain = bound of the descent; also rejects cyclic
    # maps (the scalar engine would not terminate)
    depth_memo: dict[int, int] = {}

    def bdepth(bi: int, stack: set) -> int:
        if bi in stack:
            raise BatchUnsupported(f"bucket cycle through {-1 - bi}")
        if bi in depth_memo:
            return depth_memo[bi]
        stack.add(bi)
        d = 1
        for it in map_.buckets[bi].items:
            if it < 0:
                d = max(d, 1 + bdepth(-1 - it, stack))
        stack.remove(bi)
        depth_memo[bi] = d
        return d

    max_depth = max(
        (bdepth(bi, set()) for bi, b in enumerate(map_.buckets)
         if b is not None), default=1)

    items = np.zeros((B, I), dtype=np.int32)
    ids = np.zeros((B, I), dtype=np.int32)
    weights = np.zeros((P, B, I), dtype=np.int64)
    sizes = np.zeros((B,), dtype=np.int32)
    btypes = np.zeros((B,), dtype=np.int32)
    valid = np.zeros((B,), dtype=bool)
    for bi, b in enumerate(map_.buckets):
        if b is None:
            continue
        n = b.size
        valid[bi] = True
        sizes[bi] = n
        btypes[bi] = b.type
        items[bi, :n] = b.items
        arg = choose_args.get(b.id)
        ids[bi, :n] = (arg.ids if arg is not None and arg.ids is not None
                       else b.items)
        for p in range(P):
            if arg is not None and arg.weight_set is not None:
                ws = arg.weight_set[min(p, len(arg.weight_set) - 1)]
            else:
                ws = b.item_weights
            weights[p, bi, :n] = ws
    # -- weight classes (the plain version's straw2 shortcut) -----------
    # group each bucket's items by their exact weight; per draw the
    # class path takes a masked max of the raw 16-bit hashes per class
    # and evaluates ln only on the C class winners
    class_lists: dict[tuple[int, int], list[int]] = {}
    cmax = 1
    for bi, b in enumerate(map_.buckets):
        if b is None:
            continue
        for p in range(P):
            seen = {int(w): None for w in weights[p, bi, :b.size] if w > 0}
            class_lists[(p, bi)] = list(seen)
            cmax = max(cmax, len(seen))
    use_classes = (cmax <= CLASS_PATH_MAX if class_path is None
                   else class_path) and LN16_MONO_BY_SWAP
    class_of = np.full((P, B, I), -1, dtype=np.int32)
    class_w = np.ones((P, B, cmax), dtype=np.int64)
    for (p, bi), seen in class_lists.items():
        class_w[p, bi, :len(seen)] = seen
        lut = {w: c for c, w in enumerate(seen)}
        n = map_.buckets[bi].size
        for i in range(n):
            w = int(weights[p, bi, i])
            if w > 0:
                class_of[p, bi, i] = lut[w]

    def t(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev)

    items_t = t(items)
    return CompiledCrushMap(
        map_=map_, device=items_t.device, items=items_t, ids=t(ids),
        weights=t(weights), sizes=t(sizes), btypes=t(btypes),
        valid=t(valid), max_devices=map_.max_devices, max_buckets=B,
        n_positions=P, max_depth=max_depth, class_of=t(class_of),
        class_w=t(class_w), n_class_max=cmax, use_classes=use_classes,
        first_valid=next(
            (-1 - bi for bi, b in enumerate(map_.buckets)
             if b is not None and b.size > 0), -1))


# ---------------------------------------------------------------------------
# The plain version: the reference's vmapped rule, batch dimension written
# out.  Every per-seed scalar is an (n,) tensor and every per-seed array
# an (n, R) tensor, all int64.  A loop's body runs for every lane; the
# new state is kept where the lane's condition held (the semantics of a
# batched lax.while_loop).  `live` marks the lanes whose result of a call
# is used; it only feeds the count of straw2 item evaluations.

class _Run:
    """Tables and per-lane inputs of one plain pass."""

    def __init__(self, cm: CompiledCrushMap, xs: torch.Tensor,
                 weight: torch.Tensor, count: bool):
        self.cm = cm
        self.x = xs
        self.n = xs.shape[0]
        self.weight = weight
        self.items = cm.items.to(torch.int64)
        self.ids = cm.ids.to(torch.int64)
        self.sizes = cm.sizes.to(torch.int64)
        self.btypes = cm.btypes.to(torch.int64)
        self.ln16 = _ln16_on(xs.device)
        self.lanes = torch.arange(cm.items.shape[1], device=xs.device)
        self.evals = torch.zeros((), dtype=torch.int64, device=xs.device) \
            if count else None

    def full(self, v) -> torch.Tensor:
        return torch.full((self.n,), v, dtype=torch.int64,
                          device=self.x.device)


def _keep(c: torch.Tensor, new, old):
    """Per-lane select of a loop state: new where c, else old."""
    return tuple(torch.where(c.view(-1, *([1] * (o.dim() - 1))), nv, o)
                 for nv, o in zip(new, old))


def _bidx(run: _Run, item: torch.Tensor) -> torch.Tensor:
    return (-1 - item).clamp(0, run.cm.max_buckets - 1)


def _item_type(run: _Run, item: torch.Tensor) -> torch.Tensor:
    return torch.where(item < 0, run.btypes[_bidx(run, item)], 0)


def _bucket_ok(run: _Run, item: torch.Tensor) -> torch.Tensor:
    """item is a loadable bucket id."""
    inb = (item < 0) & ((-1 - item) < run.cm.max_buckets)
    return inb & run.cm.valid[_bidx(run, item)]


def _is_out(run: _Run, item: torch.Tensor) -> torch.Tensor:
    """Probabilistic reweight rejection (mapper.c:424-441)."""
    D = run.weight.shape[0]
    w = run.weight[item.clamp(0, D - 1)]
    oob = item >= D
    return oob | ((w < 0x10000) & (
        (w == 0) | ((jhash2(run.x, item) & U16) >= w)))


def _straw2(run: _Run, bidx, r, position, live) -> torch.Tensor:
    """bucket_straw2_choose (mapper.c:361-390) for dense buckets bidx.

    Two bit-identical formulations:

    * class path: crush_ln is monotone (in the swapped key space) and
      draw = trunc(ln(u)/w) is monotone in ln for fixed w > 0, so within
      a weight class the winner is the item with the highest 16-bit hash.
      Per class: the max key, one ln and one division, then a 16-step
      binary search for the lowest key that reaches the same draw (the
      C core's strict `>` keeps the FIRST index among equal draws).
    * direct path: per-item ln, truncating division, first argmax.
    """
    cm = run.cm
    if run.evals is not None:
        run.evals += torch.where(live, run.sizes[bidx], 0).sum()
    ids = run.ids[bidx]                                  # (n, I)
    pos = position.clamp(max=cm.n_positions - 1)
    u = jhash3(run.x[:, None], ids, r[:, None]) & U16
    I = ids.shape[1]
    lane_ok = run.lanes[None, :] < run.sizes[bidx][:, None]
    if cm.use_classes:
        cls = cm.class_of[pos, bidx].to(torch.int64)     # (n, I)
        cw = cm.class_w[pos, bidx]                       # (n, C)
        ue = torch.where(lane_ok & (cls >= 0), u, -1)
        uk = _mono_key(ue)
        classes = torch.arange(cm.n_class_max, device=u.device)
        cmask = cls[:, None, :] == classes[None, :, None]  # (n, C, I)
        kc = torch.where(cmask, uk[:, None, :], -1)
        kmax = kc.max(dim=2).values                      # (n, C)
        umax = _mono_key(kmax)
        absln = LN_BIAS - run.ln16[umax.clamp(min=0)]
        k = absln // cw
        draws = torch.where(kmax >= 0, -k, S64_MIN)
        x_thr = LN_BIAS - (k + 1) * cw + 1
        lo = torch.zeros_like(kmax)
        hi = kmax.clamp(min=0)
        for _ in range(16):
            mid = (lo + hi) >> 1
            ok = run.ln16[_mono_key(mid)] >= x_thr
            hi = torch.where(ok, mid, hi)
            lo = torch.where(ok, lo, mid + 1)
        idx_c = torch.where(cmask & (uk[:, None, :] >= hi[:, :, None]),
                            run.lanes[None, None, :], I).min(dim=2).values
        best = draws.max(dim=1).values
        idx = torch.where(draws == best[:, None], idx_c, I).min(dim=1).values
        idx = torch.where(best == S64_MIN, 0, idx).clamp(max=I - 1)
        return run.items[bidx, idx]
    w = cm.weights[pos, bidx]                            # (n, I)
    ln = run.ln16[u] - LN_BIAS
    draws = torch.where(w > 0, _div_trunc(ln, w), S64_MIN)
    draws = torch.where(lane_ok, draws, S64_MIN - 1)
    return run.items[bidx, draws.argmax(dim=1)]


def _descend(run: _Run, r, start_item, target_type: int, position, live):
    """Straw2-walk from bucket `start_item` down to an item of
    target_type or a dead end.  Returns (item, parent, code): parent is
    the bucket the item was chosen from; code is _HIT, _EMPTY (a size-0
    bucket was reached) or _BAD (invalid item, mapper.c:540,553)."""
    cm = run.cm
    st = (start_item, run.full(0), run.full(_BAD),
          torch.zeros(run.n, dtype=torch.bool, device=run.x.device),
          run.full(0))
    while True:
        cur, item, code, done, depth = st
        c = ~done & (depth < cm.max_depth)
        if not bool(c.any()):
            break
        bidx = _bidx(run, cur)
        empty = run.sizes[bidx] == 0
        nxt = _straw2(run, bidx, r, position, live & c)
        ntype = _item_type(run, nxt)
        bad = (nxt >= cm.max_devices) | \
            ((ntype != target_type) & ~_bucket_ok(run, nxt))
        hit = (ntype == target_type) & (nxt < cm.max_devices)
        code2 = torch.where(empty, _EMPTY, torch.where(
            bad, _BAD, torch.where(hit, _HIT, code)))
        done2 = empty | bad | hit
        cur2 = torch.where(done2, cur, nxt)
        item2 = torch.where(hit & ~empty, nxt, item)
        st = _keep(c, (cur2, item2, code2, done2, depth + 1), st)
    cur, item, code, done, _ = st
    # depth exhaustion counts as BAD (cannot happen on well-formed maps)
    return item, cur, torch.where(done, code, _BAD)


def _collides(arr: torch.Tensor, upto: torch.Tensor, item: torch.Tensor):
    """item equals one of arr[:, :upto] (per lane)."""
    pos_idx = torch.arange(arr.shape[1], device=arr.device)
    return ((pos_idx[None, :] < upto[:, None]) &
            (arr == item[:, None])).any(dim=1)


def _firstn_rep(run, take_item, rep: int, target_type, out_arr, outpos,
                tries, local_retries, vary_r, stable, recurse_tries,
                recurse_to_leaf, out2_arr, live):
    """One replica of crush_choose_firstn (mapper.c:460-645): descend,
    then the reject/collide retry cascade.  Returns (item, leaf,
    skipped)."""
    false = torch.zeros(run.n, dtype=torch.bool, device=run.x.device)
    st = (take_item, run.full(0), run.full(0), run.full(0), run.full(0),
          false, false)
    while True:
        in_item, ftotal, flocal, item, leaf, done, skipped = st
        c = ~done
        if not bool(c.any()):
            break
        lv = live & c
        r = rep + ftotal
        item_n, parent, code = _descend(run, r, in_item, target_type,
                                        outpos, lv)
        bad = code == _BAD          # -> skip this replica (no retry)
        empty = code == _EMPTY      # -> reject (retry path)
        ok = code == _HIT
        collide = ok & _collides(out_arr, outpos, item_n)
        if recurse_to_leaf:
            sub_r = (r >> (vary_r - 1)) if vary_r else torch.zeros_like(r)
            rep_eff = torch.zeros_like(outpos) if stable else outpos
            leaf_n, leaf_ok = _leaf_firstn(
                run, item_n, rep_eff, sub_r, recurse_tries, local_retries,
                out2_arr, outpos, lv & ok & ~collide & (item_n < 0))
            leaf_ok = leaf_ok | (item_n >= 0)
            leaf_n = torch.where(item_n >= 0, item_n, leaf_n)
        else:
            leaf_n, leaf_ok = torch.zeros_like(item_n), ~false
        reject = empty | (ok & ~collide & (
            ~leaf_ok |
            ((_item_type(run, item_n) == 0) & _is_out(run, item_n))))
        fail = reject | collide
        ftotal2 = ftotal + fail
        flocal2 = flocal + fail
        local_retry = collide & (flocal2 <= local_retries)
        redescent = fail & ~local_retry & (ftotal2 < tries)
        succ = ok & ~fail
        done2 = succ | bad | (fail & ~local_retry & ~redescent)
        skipped2 = bad | (fail & done2)
        in_next = torch.where(local_retry, parent, take_item)
        flocal3 = torch.where(local_retry, flocal2, 0)
        st = _keep(c, (in_next, ftotal2, flocal3,
                       torch.where(succ, item_n, item),
                       torch.where(succ, leaf_n, leaf), done2, skipped2), st)
    _, _, _, item, leaf, _, skipped = st
    return item, leaf, skipped


def _leaf_firstn(run, bucket_item, rep_eff, parent_r, tries, local_retries,
                 out2_arr, outpos, live):
    """Inner chooseleaf descent (mapper.c:566-595: a one-replica
    recursive crush_choose_firstn to type 0).  Returns (leaf, success)."""
    false = torch.zeros(run.n, dtype=torch.bool, device=run.x.device)
    st = (bucket_item, run.full(0), run.full(0), run.full(0), false, false)
    while True:
        in_item, ftotal, flocal, item, done, succ = st
        c = ~done
        if not bool(c.any()):
            break
        r = rep_eff + parent_r + ftotal
        item_n, parent, code = _descend(run, r, in_item, 0, outpos,
                                        live & c)
        bad = code == _BAD
        empty = code == _EMPTY
        ok = code == _HIT
        collide = ok & _collides(out2_arr, outpos, item_n)
        reject = empty | (ok & ~collide & _is_out(run, item_n))
        fail = reject | collide
        ftotal2 = ftotal + fail
        flocal2 = flocal + fail
        local_retry = collide & (flocal2 <= local_retries)
        redescent = fail & ~local_retry & (ftotal2 < tries)
        s = ok & ~fail
        done2 = s | bad | (fail & ~local_retry & ~redescent)
        in_next = torch.where(local_retry, parent, bucket_item)
        flocal3 = torch.where(local_retry, flocal2, 0)
        st = _keep(c, (in_next, ftotal2, flocal3,
                       torch.where(s, item_n, item), done2, s), st)
    _, _, _, item, _, succ = st
    return item, succ


def _choose_firstn(run, take_item, numrep, target_type, count0, tries,
                   recurse_tries, local_retries, recurse_to_leaf, vary_r,
                   stable, result_max, live):
    """crush_choose_firstn over the replicas of one take segment.  Each
    take item gets a fresh segment (mapper.c:1038-1043), so positions are
    segment-relative and rep = 0 .. numrep-1.  Returns (seg_out,
    seg_out2, got)."""
    pos_idx = torch.arange(result_max, device=run.x.device)
    out = torch.zeros((run.n, result_max), dtype=torch.int64,
                      device=run.x.device)
    out2 = torch.zeros_like(out)
    outpos = run.full(0)
    count = count0
    for rep in range(numrep):
        active = count > 0
        if not bool(active.any()):
            break
        item, leaf, skipped = _firstn_rep(
            run, take_item, rep, target_type, out, outpos, tries,
            local_retries, vary_r, stable, recurse_tries, recurse_to_leaf,
            out2, live & active)
        write = active & ~skipped
        at = write[:, None] & (pos_idx[None, :] == outpos[:, None])
        out = torch.where(at, item[:, None], out)
        if recurse_to_leaf:
            out2 = torch.where(at, leaf[:, None], out2)
        outpos = outpos + write.to(torch.int64)
        count = count - write.to(torch.int64)
    return out, out2, outpos


def _leaf_indep(run, bucket_item, numrep, parent_r, tries, rep: int, live):
    """Inner chooseleaf descent for indep (mapper.c:781-790: a one-slot
    recursive crush_choose_indep to type 0).  Returns leaf or NONE."""
    position = run.full(rep)
    st = (run.full(0), run.full(CRUSH_ITEM_NONE),
          torch.zeros(run.n, dtype=torch.bool, device=run.x.device))
    while True:
        ft, leaf, done = st
        c = ~done & (ft < tries)
        if not bool(c.any()):
            break
        r = rep + parent_r + numrep * ft
        item, _, code = _descend(run, r, bucket_item, 0, position, live & c)
        ok = code == _HIT
        hard = code == _BAD
        good = ok & ~_is_out(run, item)
        # a hard failure fills the slot with NONE for good
        leaf2 = torch.where(good, item,
                            torch.where(hard, CRUSH_ITEM_NONE, leaf))
        st = _keep(c, (ft + 1, leaf2, good | hard), st)
    return st[1]


def _choose_indep(run, take_item, left0, numrep, target_type, tries,
                  recurse_tries, recurse_to_leaf, result_max, live):
    """crush_choose_indep (mapper.c:655-830) over one take segment:
    breadth-first, positionally stable; holes become CRUSH_ITEM_NONE.
    Returns (seg_out, seg_out2) with slots [0, left0) filled."""
    pos_idx = torch.arange(result_max, device=run.x.device)
    in_range = pos_idx[None, :] < left0[:, None]
    out = torch.where(in_range, CRUSH_ITEM_UNDEF, 0)
    out2 = out.clone()
    zero = run.full(0)
    st = (out, out2, left0, run.full(0))
    while True:
        out, out2, left, ftotal = st
        c = (left > 0) & (ftotal < tries)
        if not bool(c.any()):
            break
        lvr = live & c
        o, o2, lf = out.clone(), out2.clone(), left
        for rep in range(result_max):
            todo = (rep < left0) & (o[:, rep] == CRUSH_ITEM_UNDEF)
            rr = rep + numrep * ftotal
            item, _, code = _descend(run, rr, take_item, target_type, zero,
                                     lvr & todo)
            ok = code == _HIT
            hard = code == _BAD  # -> NONE at once (mapper.c:731,758)
            collide = ok & (in_range & (o == item[:, None])).any(dim=1)
            if recurse_to_leaf:
                leaf = torch.where(
                    item < 0,
                    _leaf_indep(run, item, numrep, rr, recurse_tries, rep,
                                lvr & todo & ok & ~collide & (item < 0)),
                    item)
                leaf_fail = (item < 0) & (leaf == CRUSH_ITEM_NONE)
            else:
                leaf_fail = torch.zeros_like(ok)
            reject = ok & ((_item_type(run, item) == 0) & _is_out(run, item))
            good = ok & ~collide & ~leaf_fail & ~reject
            col = torch.where(todo & good, item, o[:, rep])
            o[:, rep] = torch.where(todo & hard, CRUSH_ITEM_NONE, col)
            if recurse_to_leaf:
                # C writes out2[rep] before the is_out check, so a rejected
                # device leaves a stale out2 entry (mapper.c:791-793), and
                # a failed bucket recursion leaves out2[rep] = NONE
                stale = todo & ok & ~collide & (
                    ((item >= 0) & reject) | leaf_fail)
                col = torch.where(todo & good, leaf, o2[:, rep])
                col = torch.where(stale, torch.where(
                    leaf_fail, CRUSH_ITEM_NONE, item), col)
                o2[:, rep] = torch.where(todo & hard, CRUSH_ITEM_NONE, col)
            lf = lf - (todo & (good | hard)).to(torch.int64)
        st = _keep(c, (o, o2, lf, ftotal + 1), st)
    out, out2, _, _ = st
    out = torch.where(in_range & (out == CRUSH_ITEM_UNDEF),
                      CRUSH_ITEM_NONE, out)
    out2 = torch.where(in_range & (out2 == CRUSH_ITEM_UNDEF),
                       CRUSH_ITEM_NONE, out2)
    return out, out2


def _do_rule(run: _Run, cfg: _RuleCfg):
    """do_rule (mapper.c:900-1105) for every lane.  Returns (result
    (n, R), rcount (n,))."""
    R = cfg.result_max
    tries = cfg.tries
    leaf_tries = 0
    local_retries = cfg.local_retries
    vary_r = cfg.vary_r
    stable = cfg.stable
    dev = run.x.device
    pos_idx = torch.arange(R, device=dev)
    result = torch.full((run.n, R), CRUSH_ITEM_NONE, dtype=torch.int64,
                        device=dev)
    rcount = run.full(0)
    w_items = torch.zeros((run.n, R), dtype=torch.int64, device=dev)
    w_count = run.full(0)
    w_max = 0  # upper bound on w_count
    live = torch.ones(run.n, dtype=torch.bool, device=dev)

    for op, arg1, arg2, take_ok in cfg.steps:
        if op == CRUSH_RULE_TAKE:
            if take_ok:
                w_items[:, 0] = arg1
                w_count = run.full(1)
                w_max = 1
        elif op == CRUSH_RULE_SET_CHOOSE_TRIES:
            if arg1 > 0:
                tries = arg1
        elif op == CRUSH_RULE_SET_CHOOSELEAF_TRIES:
            if arg1 > 0:
                leaf_tries = arg1
        elif op == CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES:
            if arg1 >= 0:
                local_retries = arg1
        elif op == CRUSH_RULE_SET_CHOOSELEAF_VARY_R:
            if arg1 >= 0:
                vary_r = arg1
        elif op == CRUSH_RULE_SET_CHOOSELEAF_STABLE:
            if arg1 >= 0:
                stable = arg1
        elif op in _CHOOSE_OPS:
            firstn = op in (CRUSH_RULE_CHOOSE_FIRSTN,
                            CRUSH_RULE_CHOOSELEAF_FIRSTN)
            recurse = op in (CRUSH_RULE_CHOOSELEAF_FIRSTN,
                             CRUSH_RULE_CHOOSELEAF_INDEP)
            numrep = arg1
            if numrep <= 0:
                numrep += R
            o = torch.zeros((run.n, R), dtype=torch.int64, device=dev)
            c = torch.zeros_like(o)
            osize = run.full(0)
            if firstn:
                if leaf_tries:
                    recurse_tries = leaf_tries
                elif cfg.descend_once:
                    recurse_tries = 1
                else:
                    recurse_tries = tries
            else:
                recurse_tries = leaf_tries if leaf_tries else 1
            # numrep <= 0 after adjustment skips every take item but the
            # o/w swap still empties w (mapper.c:1010-1015,1077-1081)
            for wi in (range(w_max) if numrep > 0 else ()):
                wi_item = w_items[:, wi]
                wi_ok = (wi < w_count) & _bucket_ok(run, wi_item)
                # masked execution: run the choose from a safe bucket,
                # discard the lanes where wi is invalid
                take = torch.where(wi_ok, wi_item, run.cm.first_valid)
                if firstn:
                    seg_o, seg_c, got = _choose_firstn(
                        run, take, numrep, arg2, R - osize, tries,
                        recurse_tries, local_retries, recurse, vary_r,
                        stable, R, live & wi_ok)
                else:
                    got = (R - osize).clamp(max=numrep)
                    seg_o, seg_c = _choose_indep(
                        run, take, got, numrep, arg2, tries, recurse_tries,
                        recurse, R, live & wi_ok)
                got = torch.where(wi_ok, got, 0)
                seg_idx = (pos_idx[None, :] - osize[:, None]).clamp(0, R - 1)
                mask = (pos_idx[None, :] >= osize[:, None]) & \
                    (pos_idx[None, :] < (osize + got)[:, None])
                o = torch.where(mask, seg_o.gather(1, seg_idx), o)
                c = torch.where(mask, seg_c.gather(1, seg_idx), c)
                osize = osize + got
            if recurse:
                o = torch.where(pos_idx[None, :] < osize[:, None], c, o)
            w_items = o
            w_count = osize
            w_max = (min(R, max(w_max * numrep, 1)) if numrep > 0 else 0)
        elif op == CRUSH_RULE_EMIT:
            src_idx = (pos_idx[None, :] - rcount[:, None]).clamp(0, R - 1)
            emit = (pos_idx[None, :] >= rcount[:, None]) & \
                ((pos_idx[None, :] - rcount[:, None]) < w_count[:, None])
            result = torch.where(emit, w_items.gather(1, src_idx), result)
            rcount = (rcount + w_count).clamp(max=R)
            w_items = torch.zeros_like(w_items)
            w_count = run.full(0)
            w_max = 0
    return result, rcount


def map_batch_plain(cm: CompiledCrushMap, cfg: _RuleCfg, xs: torch.Tensor,
                    weight: torch.Tensor, chunk: int = PLAIN_CHUNK,
                    stats: dict | None = None):
    """The plain version of K3 on the map's device: (N, R) int32
    placements and (N,) int32 counts, `chunk` seeds per pass.  With a
    `stats` dict, adds the straw2 item evaluations the rule needed for
    these seeds under stats["straw2_evals"] (evaluations whose result the
    rule uses, as the scalar engine and K3 make them)."""
    devguard.check_device("map_batch_plain", cm.device, xs, weight)
    if weight.dim() != 1 or weight.shape[0] < 1:
        raise ValueError("weight must be a non-empty (D,) vector")
    res, cnt = [], []
    evals = 0
    for lo in range(0, xs.shape[0], chunk):
        run = _Run(cm, xs[lo:lo + chunk], weight, stats is not None)
        r, n = _do_rule(run, cfg)
        res.append(r.to(torch.int32))
        cnt.append(n.to(torch.int32))
        if run.evals is not None:
            evals += int(run.evals)
    if stats is not None:
        stats["straw2_evals"] = stats.get("straw2_evals", 0) + evals
    if not res:
        return (torch.empty((0, cfg.result_max), dtype=torch.int32,
                            device=cm.device),
                torch.empty((0,), dtype=torch.int32, device=cm.device))
    return torch.cat(res), torch.cat(cnt)


# ---------------------------------------------------------------------------
# K3, the CUDA kernel

class _CrushArgs(ctypes.Structure):
    """Mirror of `CrushArgs` in crush_rule.cu (same order and types)."""
    _fields_ = [
        ("xs", ctypes.c_void_p), ("n", ctypes.c_longlong),
        ("weight", ctypes.c_void_p), ("n_weight", ctypes.c_int),
        ("n_buckets", ctypes.c_int), ("n_items", ctypes.c_int),
        ("n_positions", ctypes.c_int),
        ("items", ctypes.c_void_p), ("ids", ctypes.c_void_p),
        ("weights", ctypes.c_void_p), ("sizes", ctypes.c_void_p),
        ("btypes", ctypes.c_void_p), ("valid", ctypes.c_void_p),
        ("ln16", ctypes.c_void_p), ("steps", ctypes.c_void_p),
        ("n_steps", ctypes.c_int), ("result_max", ctypes.c_int),
        ("tries", ctypes.c_int), ("local_retries", ctypes.c_int),
        ("vary_r", ctypes.c_int), ("stable", ctypes.c_int),
        ("descend_once", ctypes.c_int), ("max_devices", ctypes.c_int),
        ("max_depth", ctypes.c_int),
        ("out", ctypes.c_void_p), ("counts", ctypes.c_void_p),
    ]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("crush_rule")
    lib.crush_do_rule.argtypes = [ctypes.POINTER(_CrushArgs), ctypes.c_void_p]
    lib.crush_do_rule.restype = ctypes.c_int
    lib.crush_error_string.argtypes = [ctypes.c_int]
    lib.crush_error_string.restype = ctypes.c_char_p
    return lib


def crush_do_rule_cuda(cm: CompiledCrushMap, cfg: _RuleCfg,
                       xs: torch.Tensor, weight: torch.Tensor):
    """K3: do_rule for every seed of xs (N,) int64 under weight (D,)
    int64, on the map's cuda device and the current stream.  Returns
    (N, R) int32 placements and (N,) int32 counts."""
    dev = cm.device
    if dev.type != "cuda" or xs.device != dev or weight.device != dev:
        raise ValueError(f"K3 needs the map, xs and weight on one cuda "
                         f"device, got {dev}, {xs.device}, {weight.device}")
    if xs.dtype != torch.int64 or xs.dim() != 1 or not xs.is_contiguous():
        raise ValueError("xs must be a contiguous (N,) int64 tensor")
    if weight.dtype != torch.int64 or weight.dim() != 1 or \
            weight.shape[0] < 1 or not weight.is_contiguous():
        raise ValueError("weight must be a contiguous non-empty (D,) int64 "
                         "tensor")
    if not 1 <= cfg.result_max <= CRUSH_MAX_RESULT:
        raise ValueError(f"result_max {cfg.result_max} outside "
                         f"[1, {CRUSH_MAX_RESULT}]")
    n = xs.shape[0]
    R = cfg.result_max
    out = torch.empty((n, R), dtype=torch.int32, device=dev)
    counts = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return out, counts
    steps = cm.steps_tensor(cfg)
    tables = (cm.items, cm.ids, cm.weights, cm.sizes, cm.btypes, cm.valid)
    for t, dt in zip(tables, (torch.int32, torch.int32, torch.int64,
                              torch.int32, torch.int32, torch.bool)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError("compiled map tables have the wrong layout")
    ln16 = _ln16_on(dev)
    args = _CrushArgs(
        xs=xs.data_ptr(), n=n, weight=weight.data_ptr(),
        n_weight=weight.shape[0], n_buckets=cm.max_buckets,
        n_items=cm.items.shape[1], n_positions=cm.n_positions,
        items=cm.items.data_ptr(), ids=cm.ids.data_ptr(),
        weights=cm.weights.data_ptr(), sizes=cm.sizes.data_ptr(),
        btypes=cm.btypes.data_ptr(), valid=cm.valid.data_ptr(),
        ln16=ln16.data_ptr(), steps=steps.data_ptr(),
        n_steps=steps.shape[0], result_max=R, tries=cfg.tries,
        local_retries=cfg.local_retries, vary_r=cfg.vary_r,
        stable=cfg.stable, descend_once=cfg.descend_once,
        max_devices=cm.max_devices, max_depth=cm.max_depth,
        out=out.data_ptr(), counts=counts.data_ptr())
    lib = _lib()
    # the library launches on the calling thread's current device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.crush_do_rule(ctypes.byref(args), stream)
    if err:
        msg = lib.crush_error_string(err).decode()
        raise RuntimeError(f"crush_do_rule launch failed: {msg} ({err})")
    LAUNCHES["crush_do_rule"] += 1
    return out, counts
