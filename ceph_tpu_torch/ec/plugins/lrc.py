"""lrc plugin: layered locally-repairable codes.

Faithful re-implementation of the reference lrc plugin
(ref: src/erasure-code/lrc/ErasureCodeLrc.{h,cc}): the profile describes
a list of layers, each a (chunks-map string, sub-profile) pair; each
layer delegates its math to another registered plugin over the subset of
chunk positions its map marks 'D' (data) or 'c' (coding).  Repairing a
single lost chunk only needs the chunks of the *smallest* layer able to
recover it — the layered `_minimum_to_decode` (ErasureCodeLrc.cc:566)
walks layers from the most local upward.

The k/m/l shorthand (parse_kml, ErasureCodeLrc.cc:293) generates the
mapping, one global layer and (k+m)/l local layers, exactly like the
reference, so chunk layouts match byte-for-byte given the same
sub-plugin.

The port's copy of `ceph_tpu.ec.plugins.lrc`: each layer's sub-code is
built through the port's registry on this plugin's device; compiled
repair runs there through K1.
"""
from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Mapping

import numpy as np

from ..interface import (ErasureCode, ErasureCodeError, ErasureCodeProfile,
                         to_int)
from ..registry import ErasureCodePlugin

DEFAULT_KML = -1


@dataclass
class Layer:
    """One LRC layer (ErasureCodeLrc.h struct Layer)."""
    chunks_map: str
    profile: dict = field(default_factory=dict)
    data: list[int] = field(default_factory=list)
    coding: list[int] = field(default_factory=list)
    chunks: list[int] = field(default_factory=list)
    chunks_as_set: set = field(default_factory=set)
    erasure_code: object = None


@dataclass
class Step:
    """CRUSH rule step description (ErasureCodeLrc.h struct Step)."""
    op: str
    type: str
    n: int


def _json_loads(s: str):
    """json_spirit tolerates trailing commas in arrays; python json
    does not — normalize before parsing."""
    return json.loads(re.sub(r",\s*([\]}])", r"\1", s))


def _parse_str_map(s: str) -> dict:
    """A JSON object or 'k=v k=v' space-separated pairs
    (common/str_map get_json_str_map semantics)."""
    s = s.strip()
    if not s:
        return {}
    if s.startswith("{"):
        return {k: str(v) for k, v in json.loads(s).items()}
    out = {}
    for kv in s.split():
        if "=" not in kv:
            raise ErasureCodeError(f"expected k=v in {s!r}")
        k, v = kv.split("=", 1)
        out[k] = v
    return out


class ErasureCodeLrc(ErasureCode):
    def __init__(self, device=None) -> None:
        super().__init__(device)
        self.layers: list[Layer] = []
        self.chunk_count_ = 0
        self.data_chunk_count_ = 0
        self.rule_steps = [Step("chooseleaf", "host", 0)]

    # -- interface ----------------------------------------------------------
    def get_chunk_count(self) -> int:
        return self.chunk_count_

    def get_data_chunk_count(self) -> int:
        return self.data_chunk_count_

    def get_chunk_size(self, object_size: int) -> int:
        # ref: ErasureCodeLrc.cc:559-562
        return self.layers[0].erasure_code.get_chunk_size(object_size)

    # -- init ---------------------------------------------------------------
    def init(self, profile: ErasureCodeProfile) -> None:
        self.parse_kml(profile)
        self.parse(profile)
        layers_str = profile.get("layers")
        if layers_str is None:
            raise ErasureCodeError("could not find 'layers' in profile")
        try:
            description = _json_loads(layers_str)
        except ValueError as e:
            raise ErasureCodeError(
                f"failed to parse layers={layers_str!r}: {e}") from e
        if not isinstance(description, list):
            raise ErasureCodeError(
                f"layers={layers_str!r} must be a JSON array")
        self.layers_parse(description)
        self.layers_init()
        mapping = profile.get("mapping")
        if mapping is None:
            raise ErasureCodeError("the 'mapping' profile is missing")
        self.data_chunk_count_ = mapping.count("D")
        self.chunk_count_ = len(mapping)
        self.layers_sanity_checks(layers_str)
        # kml-generated parameters are not exposed back to the caller
        # (ErasureCodeLrc.cc:539-544)
        if profile.get("l") not in (None, str(DEFAULT_KML)):
            profile.pop("mapping", None)
            profile.pop("layers", None)
        super().init(profile)

    def parse(self, profile: ErasureCodeProfile) -> None:
        super().parse(profile)
        self.parse_rule(profile)

    def parse_kml(self, profile: ErasureCodeProfile) -> None:
        """Generate mapping/layers/crush steps from k, m, l
        (ref: ErasureCodeLrc.cc:293-397)."""
        super().parse(profile)
        k = to_int("k", profile, str(DEFAULT_KML))
        m = to_int("m", profile, str(DEFAULT_KML))
        lv = to_int("l", profile, str(DEFAULT_KML))
        if k == DEFAULT_KML and m == DEFAULT_KML and lv == DEFAULT_KML:
            return
        if DEFAULT_KML in (k, m, lv):
            raise ErasureCodeError(
                "All of k, m, l must be set or none of them")
        for generated in ("mapping", "layers", "crush-steps"):
            if generated in profile:
                raise ErasureCodeError(
                    f"The {generated} parameter cannot be set "
                    "when k, m, l are set")
        if lv == 0 or (k + m) % lv:
            raise ErasureCodeError("k + m must be a multiple of l")
        local_group_count = (k + m) // lv
        if k % local_group_count:
            raise ErasureCodeError("k must be a multiple of (k + m) / l")
        if m % local_group_count:
            raise ErasureCodeError("m must be a multiple of (k + m) / l")
        kd = k // local_group_count
        md = m // local_group_count
        profile["mapping"] = ("D" * kd + "_" * md + "_") * local_group_count
        layers = "[ "
        # global layer
        layers += ' [ "' + ("D" * kd + "c" * md + "_") * local_group_count \
            + '", "" ],'
        # local layers
        for i in range(local_group_count):
            layers += ' [ "'
            for j in range(local_group_count):
                layers += ("D" * lv + "c") if i == j else "_" * (lv + 1)
            layers += '", "" ],'
        profile["layers"] = layers + "]"
        rule_locality = profile.get("crush-locality", "")
        rule_failure_domain = profile.get("crush-failure-domain", "host")
        if rule_locality:
            self.rule_steps = [
                Step("choose", rule_locality, local_group_count),
                Step("chooseleaf", rule_failure_domain, lv + 1)]
        elif rule_failure_domain:
            self.rule_steps = [Step("chooseleaf", rule_failure_domain, 0)]

    def parse_rule(self, profile: ErasureCodeProfile) -> None:
        """ref: ErasureCodeLrc.cc:399-451."""
        self.rule_root = profile.setdefault("crush-root", "default")
        self.rule_device_class = profile.setdefault("crush-device-class", "")
        steps_str = profile.get("crush-steps")
        if steps_str is not None:
            try:
                description = _json_loads(steps_str)
            except ValueError as e:
                raise ErasureCodeError(
                    f"failed to parse crush-steps={steps_str!r}: {e}") from e
            if not isinstance(description, list):
                raise ErasureCodeError("crush-steps must be a JSON array")
            self.rule_steps = []
            for stp in description:
                if not (isinstance(stp, list) and len(stp) >= 3 and
                        isinstance(stp[0], str) and isinstance(stp[1], str)
                        and isinstance(stp[2], int)):
                    raise ErasureCodeError(
                        f"bad crush-steps element {stp!r} "
                        "(expected [op, type, n])")
                self.rule_steps.append(Step(stp[0], stp[1], stp[2]))

    def layers_parse(self, description: list) -> None:
        """ref: ErasureCodeLrc.cc:143-211."""
        for position, layer_json in enumerate(description):
            if not isinstance(layer_json, list):
                raise ErasureCodeError(
                    f"layers element at position {position} must be a "
                    f"JSON array, got {layer_json!r}")
            if not layer_json or not isinstance(layer_json[0], str):
                raise ErasureCodeError(
                    f"the first element of layer {position} must be "
                    "a string (the chunks map)")
            layer = Layer(chunks_map=layer_json[0])
            if len(layer_json) > 1:
                second = layer_json[1]
                if isinstance(second, str):
                    layer.profile = _parse_str_map(second)
                elif isinstance(second, dict):
                    layer.profile = {k: str(v) for k, v in second.items()}
                else:
                    raise ErasureCodeError(
                        f"the second element of layer {position} must be "
                        "a string or object")
            # trailing elements ignored, like the reference
            self.layers.append(layer)

    def layers_init(self) -> None:
        """ref: ErasureCodeLrc.cc:213-250."""
        from ..registry import ErasureCodePluginRegistry
        registry = ErasureCodePluginRegistry.instance()
        for layer in self.layers:
            for position, c in enumerate(layer.chunks_map):
                if c == "D":
                    layer.data.append(position)
                if c == "c":
                    layer.coding.append(position)
                if c in ("c", "D"):
                    layer.chunks_as_set.add(position)
            layer.chunks = layer.data + layer.coding
            layer.profile.setdefault("k", str(len(layer.data)))
            layer.profile.setdefault("m", str(len(layer.coding)))
            layer.profile.setdefault("plugin", "jerasure")
            layer.profile.setdefault("technique", "reed_sol_van")
            layer.erasure_code = registry.factory(
                layer.profile["plugin"], layer.profile, self.device)

    def layers_sanity_checks(self, description_string: str) -> None:
        """ref: ErasureCodeLrc.cc:252-279."""
        if len(self.layers) < 1:
            raise ErasureCodeError(
                f"layers parameter has {len(self.layers)} which is less "
                f"than the minimum of one: {description_string}")
        for layer in self.layers:
            if self.chunk_count_ != len(layer.chunks_map):
                raise ErasureCodeError(
                    f"the layer '{layer.chunks_map}' is expected to be "
                    f"{self.chunk_count_} characters long but is "
                    f"{len(layer.chunks_map)} characters long instead")

    # -- minimum_to_decode --------------------------------------------------
    def _minimum_to_decode(self, want_to_read: set, available_chunks: set
                           ) -> set:
        """Layered cheapest-repair walk (ref: ErasureCodeLrc.cc:566-735)."""
        erasures_total = set()
        erasures_not_recovered = set()
        erasures_want = set()
        for i in range(self.get_chunk_count()):
            if i not in available_chunks:
                erasures_total.add(i)
                erasures_not_recovered.add(i)
                if i in want_to_read:
                    erasures_want.add(i)

        # Case 1: nothing wanted is missing
        if not erasures_want:
            return set(want_to_read)

        # Case 2: recover wanted erasures with as few chunks as possible,
        # walking layers from the most local (last) upward
        minimum: set = set()
        for layer in reversed(self.layers):
            layer_want = want_to_read & layer.chunks_as_set
            if not layer_want:
                continue
            layer_erasures = layer_want & erasures_want
            if not layer_erasures:
                layer_minimum = layer_want
            else:
                erasures = layer.chunks_as_set & erasures_not_recovered
                if len(erasures) > \
                        layer.erasure_code.get_coding_chunk_count():
                    # too many erasures for this layer: hope upward
                    continue
                layer_minimum = layer.chunks_as_set - erasures_not_recovered
                for j in erasures:
                    erasures_not_recovered.discard(j)
                    erasures_want.discard(j)
            minimum |= layer_minimum
        if not erasures_want:
            minimum |= set(want_to_read)
            minimum -= erasures_total
            return minimum

        # Case 3: recover as many chunks as possible even from layers
        # without wanted chunks, hoping it unlocks upper layers
        erasures_total = {i for i in range(self.get_chunk_count())
                          if i not in available_chunks}
        for layer in reversed(self.layers):
            layer_erasures = layer.chunks_as_set & erasures_total
            if not layer_erasures:
                continue
            if len(layer_erasures) <= \
                    layer.erasure_code.get_coding_chunk_count():
                erasures_total -= layer_erasures
        if not erasures_total:
            return set(available_chunks)

        raise ErasureCodeError(
            f"EIO: not enough chunks in {sorted(available_chunks)} to "
            f"read {sorted(want_to_read)}")

    # -- local-group repair -------------------------------------------------
    #: weight multiplier for reads outside the wanted chunk's local
    #: parity group in minimum_to_decode_with_cost — a cross-group read
    #: crosses a CRUSH fault domain when crush-locality maps groups to
    #: domains (see parse_kml/create_rule), so it is charged like the
    #: slower, blast-radius-expanding read it is
    CROSS_GROUP_COST = 4

    def local_layer(self, chunk: int):
        """The smallest layer containing `chunk` — for kml profiles,
        its local parity group; the global layer only when no local
        layer covers the chunk."""
        best = None
        for layer in self.layers:
            if chunk in layer.chunks_as_set and (
                    best is None
                    or len(layer.chunks_as_set) < len(best.chunks_as_set)):
                best = layer
        return best

    def _repair_layer(self, chunk: int, available: set):
        """Smallest layer that can rebuild `chunk` from available
        survivors, or None."""
        best = None
        for layer in self.layers:
            if chunk not in layer.chunks_as_set:
                continue
            erased = layer.chunks_as_set - set(available) \
                - {chunk} | {chunk}
            if len(erased) > layer.erasure_code.get_coding_chunk_count():
                continue
            if best is None or \
                    len(layer.chunks_as_set) < len(best.chunks_as_set):
                best = layer
        return best

    def is_repair(self, want_to_read: set, available_chunks: set) -> bool:
        """True when the single wanted erasure rebuilds from a local
        parity group smaller than a k-survivor decode (l << k reads)."""
        want = set(want_to_read)
        if len(want) != 1 or want <= set(available_chunks):
            return False
        layer = self._repair_layer(next(iter(want)),
                                   set(available_chunks))
        return layer is not None and \
            len(layer.chunks_as_set & set(available_chunks)) < \
            self.get_data_chunk_count()

    def minimum_to_repair(self, want_to_read: set, available_chunks: set
                          ) -> dict[int, list[tuple[int, int]]]:
        """The lost chunk's local-group survivors, whole chunks each
        (lrc has no sub-chunk granularity — the saving is reading
        l << k chunks, not partial chunks)."""
        want = set(want_to_read)
        avail = set(available_chunks)
        lost = next(iter(want))
        layer = self._repair_layer(lost, avail)
        if layer is None:
            raise ErasureCodeError(
                f"minimum_to_repair: no layer can rebuild {lost} from "
                f"{sorted(avail)}")
        return {c: [(0, 1)] for c in layer.chunks_as_set & avail}

    def repair_schedule(self, erasures: set, available: set):
        """Single-erasure LRC plan: the local group's l survivors,
        full chunks."""
        erasures = set(erasures)
        available = set(available) - erasures
        if not self.is_repair(erasures, available):
            return None
        from ..repairc import RepairPlan
        return RepairPlan.make(
            erasures, self.minimum_to_repair(erasures, available),
            sub_chunk_no=1)

    def minimum_to_decode_with_cost(self, want_to_read: set,
                                    available: Mapping[int, int]) -> set:
        """Cost-weighted survivor choice: reads outside the wanted
        chunks' local parity groups are charged CROSS_GROUP_COST x
        their supplied cost, so degraded reads prefer in-group
        survivors (the base class charges every read the same)."""
        want = set(want_to_read)
        avail = set(available)
        costs = dict(available) if isinstance(available, Mapping) else {}
        home: set = set()
        for c in want:
            layer = self.local_layer(c)
            if layer is not None:
                home |= layer.chunks_as_set
        candidates = [self._minimum_to_decode(want, avail)]
        lost = want - avail
        if len(lost) == 1:
            layer = self._repair_layer(next(iter(lost)), avail)
            if layer is not None:
                candidates.append(
                    (layer.chunks_as_set & avail) | (want & avail))

        def total(chunks: set) -> int:
            return sum(
                costs.get(c, 1) * (1 if c in home
                                   else self.CROSS_GROUP_COST)
                for c in chunks)

        return min(candidates, key=total)

    # -- encode / decode ----------------------------------------------------
    def encode_chunks(self, want_to_encode, encoded) -> None:
        """ref: ErasureCodeLrc.cc:737-775."""
        want = set(want_to_encode)
        top = len(self.layers)
        for layer in reversed(self.layers):
            top -= 1
            if want <= layer.chunks_as_set:
                break
        for layer in self.layers[top:]:
            layer_want = set()
            layer_encoded = {}
            for j, c in enumerate(layer.chunks):
                layer_encoded[j] = encoded[c]
                if c in want:
                    layer_want.add(j)
            layer.erasure_code.encode_chunks(layer_want, layer_encoded)
            for j, c in enumerate(layer.chunks):
                encoded[c] = layer_encoded[j]

    def decode_chunks(self, want_to_read, chunks, decoded) -> None:
        """ref: ErasureCodeLrc.cc:777-860."""
        want = set(want_to_read)
        available = set()
        erasures = set()
        for i in range(self.get_chunk_count()):
            if i in chunks:
                available.add(i)
            else:
                erasures.add(i)

        want_to_read_erasures: set = set()
        for layer in reversed(self.layers):
            layer_erasures = layer.chunks_as_set & erasures
            if len(layer_erasures) > \
                    layer.erasure_code.get_coding_chunk_count():
                continue  # too many erasures for this layer
            if not layer_erasures:
                continue  # all chunks already available
            layer_want = set()
            layer_chunks = {}
            layer_decoded = {}
            for j, c in enumerate(layer.chunks):
                # pick from *decoded* so chunks recovered by previous
                # layers are reused (ErasureCodeLrc.cc:806-815)
                if c not in erasures:
                    layer_chunks[j] = decoded[c]
                if c in want:
                    layer_want.add(j)
                layer_decoded[j] = decoded[c]
            layer.erasure_code.decode_chunks(layer_want, layer_chunks,
                                             layer_decoded)
            for j, c in enumerate(layer.chunks):
                decoded[c] = layer_decoded[j]
                erasures.discard(c)
            want_to_read_erasures = erasures & want
            if not want_to_read_erasures:
                break

        if want_to_read_erasures:
            raise ErasureCodeError(
                f"EIO: want to read {sorted(want)} with available "
                f"{sorted(available)} end up unable to read "
                f"{sorted(want_to_read_erasures)}")

    # -- crush rule ---------------------------------------------------------
    def create_rule(self, name: str, crush) -> int:
        """Multi-step rule from rule_steps
        (ref: ErasureCodeLrc.cc:44-112)."""
        from ...crush.types import (
            CRUSH_RULE_CHOOSELEAF_INDEP, CRUSH_RULE_CHOOSE_INDEP,
            CRUSH_RULE_EMIT, CRUSH_RULE_TAKE, CrushRule, CrushRuleMask,
            CrushRuleStep)
        root = crush.get_item_id(self.rule_root)
        if root is None:
            raise ErasureCodeError(
                f"root item {self.rule_root} does not exist")
        steps = [CrushRuleStep(CRUSH_RULE_TAKE, root, 0)]
        for step in self.rule_steps:
            if step.op == "choose":
                op = CRUSH_RULE_CHOOSE_INDEP
            elif step.op == "chooseleaf":
                op = CRUSH_RULE_CHOOSELEAF_INDEP
            else:
                raise ErasureCodeError(
                    f"unknown crush-steps op {step.op!r} (want choose or "
                    "chooseleaf)")
            tid = crush.get_type_id(step.type)
            if tid < 0:
                raise ErasureCodeError(f"unknown type {step.type}")
            steps.append(CrushRuleStep(op, step.n, tid))
        steps.append(CrushRuleStep(CRUSH_RULE_EMIT, 0, 0))
        rule = CrushRule(steps=steps,
                         mask=CrushRuleMask(
                             ruleset=len(crush.crush.rules), type=3,
                             max_size=max(10, self.get_chunk_count())))
        crush.crush.rules.append(rule)
        rid = len(crush.crush.rules) - 1
        crush.rule_name_map[rid] = name
        return rid


PLUGIN = ErasureCodePlugin("lrc", ErasureCodeLrc)
