"""CrushTester: placement distribution testing for crushtool --test.

Port of src/crush/CrushTester.{h,cc} (test_with_fork -> test :477): map
x = min_x..max_x through each rule for each num_rep in the rule mask
range, bucket results by size, count per-device placements, and print
the reference tool's exact output shapes (--show-utilization /
--show-statistics / --show-mappings / --show-bad-mappings; golden
format: src/test/cli/crushtool/arg-order-checks.t:204).

All x values of one (rule, num_rep) go through the batch CRUSH engine in
one call (K3 on the card, its plain version on the CPU) and come back to
the host in one copy; the counters are numpy passes over that table, and
only --show-mappings / --show-bad-mappings walk it x by x.  `test(...,
timings={})` returns the host seconds of its pieces, summed over the
(rule, num_rep) runs of that one call.  A map the
batch engine refuses (BatchUnsupported: legacy bucket algorithms, or
num_rep above CRUSH_MAX_RESULT) is mapped by the scalar engine instead,
counted in `FALLBACKS`; no other error is caught.

The port's copy of `ceph_tpu.crush.tester`: the output text is the
reference's, byte for byte.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import device as _device
from . import mapper as crush_mapper
from .batch import BatchUnsupported, compile_map
from .types import CRUSH_ITEM_NONE, CRUSH_RULE_TAKE
from .wrapper import CrushWrapper

#: (rule, num_rep) runs mapped by the scalar engine because the batch
#: engine refused the map or the width, counted where it happens
FALLBACKS = {"batch_unsupported": 0}


def reset_fallbacks() -> None:
    for name in FALLBACKS:
        FALLBACKS[name] = 0


def _fmt_float(v: float) -> str:
    """C++ default ostream float formatting (6 significant digits)."""
    return f"{v:g}"


class _Laps:
    """lap(name) adds the seconds since the previous lap (or since the
    _Laps was made) to timings[name]; a no-op without a dict."""

    def __init__(self, timings: dict | None):
        self.timings = timings
        self.t = time.monotonic()

    def __call__(self, name: str) -> None:
        if self.timings is not None:
            now = time.monotonic()
            self.timings[name] = self.timings.get(name, 0.0) + now - self.t
            self.t = now


class CrushTester:
    def __init__(self, w: CrushWrapper, min_x: int = 0, max_x: int = 1023,
                 min_rep: int = 0, max_rep: int = 0, rule: int = -1,
                 weights: list[int] | None = None, device=None):
        self.w = w
        self.min_x = min_x
        self.max_x = max_x
        self.min_rep = min_rep
        self.max_rep = max_rep
        self.rule = rule
        self.device = _device.resolve(device)
        n = w.crush.max_devices
        self.weights = list(weights) if weights is not None \
            else [0x10000] * n

    # ------------------------------------------------------------ engine
    def map_all(self, ruleno: int, numrep: int, timings: dict | None = None
                ) -> tuple[np.ndarray, np.ndarray]:
        """Every x of the range through rule `ruleno` at `numrep`: an
        (N, numrep) int32 table (entries past a row's count unused) and
        the (N,) counts, on the host.  With `timings`, adds the host
        seconds of "compile_map", "map_batch" (staging, the launch and,
        on the card, the wait for it) and "copy_back"."""
        lap = _Laps(timings)
        xs = np.arange(self.min_x, self.max_x + 1, dtype=np.int64)
        try:
            cc = compile_map(self.w.crush, device=self.device)
            lap("compile_map")
            res, cnt = cc.map_batch(
                xs, np.asarray(self.weights, dtype=np.int64),
                ruleno=ruleno, result_max=numrep, return_counts=True)
            if timings is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            lap("map_batch")
        except BatchUnsupported:
            FALLBACKS["batch_unsupported"] += 1
            res = np.full((len(xs), max(numrep, 0)), CRUSH_ITEM_NONE,
                          dtype=np.int32)
            cnt = np.zeros(len(xs), dtype=np.int32)
            for i, x in enumerate(xs.tolist()):
                out = crush_mapper.do_rule(self.w.crush, ruleno, x, numrep,
                                           self.weights)
                res[i, :len(out)] = out
                cnt[i] = len(out)
            return res, cnt
        res, cnt = res.cpu().numpy(), cnt.cpu().numpy()
        lap("copy_back")
        return res, cnt

    def _reachable_devices(self, ruleno: int) -> set[int]:
        """Devices under the rule's TAKE roots
        (get_maximum_affected_by_rule, CrushTester.cc:133)."""
        out: set[int] = set()
        rule = self.w.crush.rules[ruleno]
        for step in rule.steps:
            if step.op != CRUSH_RULE_TAKE:
                continue
            stack = [step.arg1]
            while stack:
                it = stack.pop()
                if it >= 0:
                    out.add(it)
                else:
                    b = self.w.crush.bucket(it)
                    if b is not None:
                        stack.extend(b.items)
        return out

    # ------------------------------------------------------------ output
    def test(self, show_utilization: bool = False,
             show_statistics: bool = False, show_mappings: bool = False,
             show_bad_mappings: bool = False,
             timings: dict | None = None) -> str:
        """The tool's text.  With `timings`, adds map_all's pieces and
        "count_format", the rest of each (rule, num_rep) run."""
        lines: list[str] = []
        rules = [self.rule] if self.rule >= 0 else [
            i for i, r in enumerate(self.w.crush.rules) if r is not None]
        num_x = self.max_x - self.min_x + 1
        n_dev = self.w.crush.max_devices
        for r in rules:
            rule = self.w.crush.rules[r] \
                if 0 <= r < len(self.w.crush.rules) else None
            if rule is None:
                lines.append(f"rule {r} dne")
                continue
            name = self.w.rule_name_map.get(r, f"rule{r}")
            min_rep = self.min_rep or rule.mask.min_size
            max_rep = self.max_rep or rule.mask.max_size
            lines.append(f"rule {r} ({name}), x = {self.min_x}.."
                         f"{self.max_x}, numrep = {min_rep}..{max_rep}")
            reachable = self._reachable_devices(r)
            total_weight = sum(self.weights[d] for d in reachable
                               if d < len(self.weights))
            for nr in range(min_rep, max_rep + 1):
                res, cnt = self.map_all(r, nr, timings)
                lap = _Laps(timings)
                used = np.arange(res.shape[1])[None, :] < cnt[:, None]
                # non-device results (a rule emitting buckets) must not
                # wrap into the device counters
                dev = used & (res != CRUSH_ITEM_NONE) & (res >= 0) & \
                    (res < n_dev)
                per = np.bincount(res[dev], minlength=n_dev)[:n_dev]
                # size histogram keys on the raw result length, NONE
                # holes included (CrushTester.cc:648)
                sizes = np.bincount(cnt)
                if show_mappings or show_bad_mappings:
                    bad = (cnt != nr) | (used & (res == CRUSH_ITEM_NONE)) \
                        .any(axis=1)
                    for i, x in enumerate(range(self.min_x, self.max_x + 1)):
                        if not show_mappings and not bad[i]:
                            continue
                        fmt = "[" + ",".join(
                            str(o) for o in res[i, :cnt[i]].tolist()) + "]"
                        if show_mappings:
                            lines.append(f"CRUSH rule {r} x {x} {fmt}")
                        if show_bad_mappings and bad[i]:
                            lines.append(f"bad mapping rule {r} x {x} "
                                         f"num_rep {nr} result {fmt}")
                if show_statistics or show_utilization:
                    expected_objects = min(nr, len(reachable)) * num_x
                    for size in np.flatnonzero(sizes).tolist():
                        lines.append(
                            f"rule {r} ({name}) num_rep {nr} result "
                            f"size == {size}:\t{sizes[size]}/{num_x}")
                    if show_utilization:
                        # devices with nothing stored (or no weight)
                        # are omitted (CrushTester.cc:674)
                        for d in np.flatnonzero(per).tolist():
                            frac = (self.weights[d] / total_weight
                                    if total_weight and d in reachable
                                    else 0.0)
                            expected = frac * expected_objects
                            if expected == 0:
                                continue
                            lines.append(
                                f"  device {d}:\t\t stored : "
                                f"{per[d]}\t expected : "
                                f"{_fmt_float(expected)}")
                lap("count_format")
        return "\n".join(lines) + ("\n" if lines else "")
