"""The port's CRUSH engine against the JAX package, on the CPU.

Hashes, the ln table, the scalar `do_rule` (against the C core's vectors
in tests/fixtures/crush_vectors.json and the JAX scalar engine) and the
plain version of the batch engine (`map_batch` on a cpu map) against the
JAX package's `compile_map(...).map_batch` on the same maps, weights and
seeds.  Maps are built with the JAX package's types and carried across
with `crush_map_from_reference`.  Integer results, tolerance 0.
"""
import functools
import json
import os
import zlib

import numpy as np
import pytest
import torch

from ceph_tpu.crush import batch as jbatch
from ceph_tpu.crush import hashes as jhashes
from ceph_tpu.crush import mapper as jmapper
from ceph_tpu.crush.testing import map_from_spec as j_map_from_spec
from ceph_tpu.crush.types import (
    CRUSH_BUCKET_LIST, CRUSH_BUCKET_STRAW2, CRUSH_RULE_CHOOSELEAF_FIRSTN,
    CRUSH_RULE_CHOOSELEAF_INDEP, CRUSH_RULE_CHOOSE_FIRSTN,
    CRUSH_RULE_CHOOSE_INDEP, CRUSH_RULE_EMIT,
    CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES, CRUSH_RULE_TAKE, ChooseArg,
    CrushBucket, CrushMap, CrushRule, CrushRuleStep,
)
from ceph_tpu_torch.crush import batch as pbatch
from ceph_tpu_torch.crush import hashes as phashes
from ceph_tpu_torch.crush import mapper as pmapper
from ceph_tpu_torch.crush.testing import map_from_spec
from ceph_tpu_torch.crush.types import (choose_args_from_reference,
                                        crush_map_from_reference)

# The plain version runs thousands of small tensor ops; with one
# intra-op thread pool per test worker on a shared CPU they thrash.
torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures",
                        "crush_vectors.json")
with open(FIXTURES) as _f:
    CASES = json.load(_f)

STRAW2_CASES = sorted(
    name for name, case in CASES.items()
    if {b[0] for b in case["spec"]["buckets"]} == {CRUSH_BUCKET_STRAW2}
    and case["spec"]["tunables"][1] == 0)
REFUSED_CASES = sorted(set(CASES) - set(STRAW2_CASES))


# -- maps, built with the JAX package's types -------------------------------

def build_hierarchy(n_racks=3, hosts_per_rack=3, osds_per_host=4, seed=0,
                    tunables="jewel"):
    """root(type 3) -> racks(2) -> hosts(1) -> osds(0), all straw2."""
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


def build_flat(weights_list, tunables="jewel"):
    """root -> osds directly, exact weights as given, choose_firstn 3."""
    m = CrushMap()
    m.set_tunables_profile(tunables)
    items = list(range(len(weights_list)))
    root = m.add_bucket(CrushBucket(
        id=0, type=1, alg=CRUSH_BUCKET_STRAW2, items=items,
        item_weights=list(weights_list), weight=sum(weights_list)))
    m.max_devices = len(weights_list)
    m.rules.append(CrushRule(steps=[
        CrushRuleStep(CRUSH_RULE_TAKE, root),
        CrushRuleStep(CRUSH_RULE_CHOOSE_FIRSTN, 3, 0),
        CrushRuleStep(CRUSH_RULE_EMIT)]))
    return m


RULES = {
    "replicated_firstn": lambda root: [
        CrushRuleStep(CRUSH_RULE_TAKE, root),
        CrushRuleStep(CRUSH_RULE_CHOOSELEAF_FIRSTN, 3, 1),
        CrushRuleStep(CRUSH_RULE_EMIT)],
    "ec_indep": lambda root: [
        CrushRuleStep(CRUSH_RULE_TAKE, root),
        CrushRuleStep(CRUSH_RULE_CHOOSELEAF_INDEP, 0, 1),
        CrushRuleStep(CRUSH_RULE_EMIT)],
    "direct_osd_indep": lambda root: [
        CrushRuleStep(CRUSH_RULE_TAKE, root),
        CrushRuleStep(CRUSH_RULE_CHOOSE_INDEP, 4, 0),
        CrushRuleStep(CRUSH_RULE_EMIT)],
    "direct_osd_firstn": lambda root: [
        CrushRuleStep(CRUSH_RULE_TAKE, root),
        CrushRuleStep(CRUSH_RULE_CHOOSE_FIRSTN, 3, 0),
        CrushRuleStep(CRUSH_RULE_EMIT)],
}


def make_weight(n_devices, seed=0, frac_out=0.15, frac_partial=0.15):
    rng = np.random.default_rng(seed)
    w = np.full(n_devices, 0x10000, dtype=np.int64)
    rolls = rng.random(n_devices)
    w[rolls < frac_out] = 0
    part = (rolls >= frac_out) & (rolls < frac_out + frac_partial)
    w[part] = rng.integers(0x1000, 0x10000, part.sum())
    return w


def rule_case(rule_name, tunables):
    seed = zlib.crc32(rule_name.encode()) % 1000
    m, root = build_hierarchy(seed=seed, tunables=tunables)
    m.rules.append(CrushRule(steps=RULES[rule_name](root)))
    result_max = 6 if rule_name == "ec_indep" else 4
    return m, result_max, make_weight(m.max_devices, seed=1), np.arange(150)


@functools.lru_cache(maxsize=None)
def special_case(name):
    """(jax map, choose_args, result_max, weight, xs) of the cases the
    JAX package's own tests single out."""
    if name == "weight_set":
        m, root = build_hierarchy(seed=11)
        m.rules.append(CrushRule(steps=RULES["ec_indep"](root)))
        rng = np.random.default_rng(4)
        rb = m.bucket(root)
        ws = [[int(rng.integers(1, 8) * 0x10000) for _ in rb.items]
              for _ in range(3)]
        return (m, {root: ChooseArg(weight_set=ws)}, 6,
                make_weight(m.max_devices, seed=5), np.arange(100))
    if name == "collisions":
        m, root = build_hierarchy(n_racks=1, hosts_per_rack=2,
                                  osds_per_host=2, seed=5)
        m.rules.append(CrushRule(steps=[
            CrushRuleStep(CRUSH_RULE_TAKE, root),
            CrushRuleStep(CRUSH_RULE_CHOOSELEAF_INDEP, 0, 1),
            CrushRuleStep(CRUSH_RULE_EMIT)]))
        return (m, None, 4, np.full(m.max_devices, 0x10000, dtype=np.int64),
                np.arange(100))
    if name == "local_retries":
        m, root = build_hierarchy(seed=7)
        m.choose_local_tries = 2
        m.rules.append(CrushRule(steps=RULES["replicated_firstn"](root)))
        return (m, None, 4, make_weight(m.max_devices, seed=2),
                np.arange(100))
    if name == "ties":
        # huge equal weights collapse distinct hashes onto equal draws:
        # the first item of the tied range must win, not the max hash
        m = build_flat([0xFFFF0000] * 20)
        return (m, None, 3, np.full(20, 0x10000, dtype=np.int64),
                np.arange(1000))
    if name == "class_path_max":
        n = jbatch.CLASS_PATH_MAX + 8
        m = build_flat([0x10000 + i * 0x100 for i in range(n)])
        return (m, None, 3, make_weight(n, seed=3), np.arange(400))
    if name == "ln_boundary":
        # seeds whose hash hits u = 65534 / 65535, where crush_ln dips
        m = build_flat([0x20000] * 16)
        xs = np.arange(200_000, dtype=np.int64)
        hit = np.zeros(xs.shape, dtype=bool)
        for r in range(3):
            u = jhashes.hash32_3(xs[:, None], np.arange(16)[None, :], r) \
                .astype(np.int64) & 0xFFFF
            hit |= (u >= 65534).any(axis=1)
        return (m, None, 3, np.full(16, 0x10000, dtype=np.int64),
                np.concatenate([xs[hit], [0, 31337, 65534, 65535]]))
    raise KeyError(name)


SPECIAL = ("weight_set", "collisions", "local_retries", "ties",
           "class_path_max", "ln_boundary")

_JAX_RESULTS: dict = {}


def jax_map_batch(key, m, choose_args, result_max, weight, xs):
    """The JAX package's direct-path map_batch, computed once per case
    and shared between the cases that compare against it."""
    if key not in _JAX_RESULTS:
        cc = jbatch.compile_map(m, choose_args=choose_args, class_path=False)
        res, cnt = cc.map_batch(xs, weight, ruleno=0, result_max=result_max,
                                return_counts=True)
        _JAX_RESULTS[key] = (np.asarray(res), np.asarray(cnt))
    return _JAX_RESULTS[key]


def port_map_batch(m, choose_args, result_max, weight, xs, class_path):
    cc = pbatch.compile_map(crush_map_from_reference(m),
                            choose_args=choose_args_from_reference(
                                choose_args),
                            class_path=class_path, device="cpu")
    assert cc.use_classes == class_path
    res, cnt = cc.map_batch(xs, weight, ruleno=0, result_max=result_max,
                            return_counts=True)
    assert res.device.type == "cpu" and res.dtype == torch.int32
    return res.numpy(), cnt.numpy()


# -- hashes and ln ----------------------------------------------------------

_RNG = np.random.default_rng(20261016)
_U = [_RNG.integers(0, 1 << 32, 4096, dtype=np.int64) for _ in range(3)]


@pytest.mark.parametrize("name", ["hash32_2", "hash32_3", "jhash2", "jhash3",
                                  "hash32_2_int"])
def test_hash_matches_reference(name):
    a, b, c = _U
    if name in ("hash32_2", "hash32_3"):
        args = (a, b) if name == "hash32_2" else (a, b, c)
        got = getattr(phashes, name)(*args)
        want = getattr(jhashes, name)(*args)
    elif name in ("jhash2", "jhash3"):
        args = (a, b) if name == "jhash2" else (a, b, c)
        # the batch engine's forms: int64 seeds, int32 ids and r
        targs = (torch.from_numpy(args[0]),) + tuple(
            torch.from_numpy(v.astype(np.uint32).view(np.int32))
            for v in args[1:])
        got = getattr(pbatch, name)(*targs).numpy()
        with jbatch.enable_x64(True):
            jargs = (args[0],) + tuple(v.astype(np.uint32).view(np.int32)
                                       for v in args[1:])
            want = np.asarray(getattr(jbatch, name)(*jargs))
    else:
        got = np.array([phashes.hash32_2_int(int(a[i]) - (1 << 31),
                                             int(b[i]) - (1 << 31))
                        for i in range(512)])
        want = jhashes.hash32_2(a[:512] - (1 << 31), b[:512] - (1 << 31))
    assert np.array_equal(np.asarray(got, dtype=np.int64),
                          np.asarray(want, dtype=np.int64))


def test_ln16_table_matches_reference():
    assert np.array_equal(pbatch._LN16, jbatch._LN16)
    with jbatch.enable_x64(True):
        import jax.numpy as jnp
        computed = np.asarray(jbatch.crush_ln_vec(
            jnp.arange(65536, dtype=jnp.int64)))
    assert np.array_equal(pbatch._LN16, computed)
    assert bool(pbatch.LN16_MONO_BY_SWAP) and bool(jbatch.LN16_MONO_BY_SWAP)
    for u in (0, 1, 12345, 0x7FFF, 0x8000, 0xFFFE, 0xFFFF):
        assert pmapper.crush_ln(u) == jmapper.crush_ln(u) == pbatch._LN16[u]


# -- the scalar engine ------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_scalar_do_rule_matches_c_core(name):
    case = CASES[name]
    m = map_from_spec(case["spec"])
    for x, want in zip(case["xs"], case["expected"]):
        got = pmapper.do_rule(m, 0, x, case["result_max"], case["weights"])
        assert got == want, f"{name} x={x}"


@pytest.mark.parametrize("rule_name", sorted(RULES))
def test_scalar_do_rule_matches_reference_engine(rule_name):
    m, result_max, weight, xs = rule_case(rule_name, "firefly")
    pm = crush_map_from_reference(m)
    for x in xs[:60]:
        assert pmapper.do_rule(pm, 0, int(x), result_max, list(weight)) == \
            jmapper.do_rule(m, 0, int(x), result_max, list(weight)), x


# -- the plain version of the batch engine ----------------------------------

@pytest.mark.parametrize("class_path", [True, False])
@pytest.mark.parametrize("tunables", ["jewel", "firefly"])
@pytest.mark.parametrize("rule_name", sorted(RULES))
def test_plain_map_batch_matches_reference(rule_name, tunables, class_path):
    m, result_max, weight, xs = rule_case(rule_name, tunables)
    want = jax_map_batch((rule_name, tunables), m, None, result_max, weight,
                         xs)
    got = port_map_batch(m, None, result_max, weight, xs, class_path)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


@pytest.mark.parametrize("class_path", [True, False])
@pytest.mark.parametrize("name", SPECIAL)
def test_plain_map_batch_special_cases(name, class_path):
    m, ca, result_max, weight, xs = special_case(name)
    want = jax_map_batch(name, m, ca, result_max, weight, xs)
    got = port_map_batch(m, ca, result_max, weight, xs, class_path)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


@pytest.mark.parametrize("name", STRAW2_CASES)
def test_plain_map_batch_matches_c_core(name):
    case = CASES[name]
    cc = pbatch.compile_map(map_from_spec(case["spec"]), device="cpu")
    res, cnt = cc.map_batch(case["xs"], case["weights"], ruleno=0,
                            result_max=case["result_max"],
                            return_counts=True)
    for i, (x, want) in enumerate(zip(case["xs"], case["expected"])):
        assert res[i, :cnt[i]].tolist() == want, f"{name} x={x}"


def test_straw2_evaluation_count_matches_scalar_engine(monkeypatch):
    """The plain version counts the straw2 item evaluations that the
    rule uses (the bound of K3 rests on it): the same count as the
    scalar engine's bucket_straw2_choose calls make."""
    m, result_max, weight, xs = rule_case("ec_indep", "jewel")
    pm = crush_map_from_reference(m)
    stats = {}
    cc = pbatch.compile_map(pm, device="cpu")
    pbatch.map_batch_plain(cc, cc.rule_cfg(0, result_max), torch.from_numpy(
        xs.astype(np.int64)), torch.from_numpy(weight), stats=stats)
    seen = []
    real = pmapper.bucket_straw2_choose

    def counting(bucket, *args):
        seen.append(bucket.size)
        return real(bucket, *args)

    monkeypatch.setattr(pmapper, "bucket_straw2_choose", counting)
    for x in xs:
        pmapper.do_rule(pm, 0, int(x), result_max, list(weight))
    assert stats["straw2_evals"] == sum(seen) > 0


# -- what the batch engine refuses ------------------------------------------

def _refusal(name):
    """(jax map, map_batch kwargs) that the batch path refuses."""
    if name in CASES:
        return j_map_from_spec(CASES[name]["spec"]), None
    m, root = build_hierarchy(seed=1)
    m.rules.append(CrushRule(steps=RULES["ec_indep"](root)))
    if name == "non_rjenkins_hash":
        m.bucket(root).hash = 1
    elif name == "local_fallback_tunable":
        m.choose_local_fallback_tries = 2
    elif name == "dangling_bucket":
        m.bucket(root).items[0] = -999
    elif name == "bucket_cycle":
        m.bucket(m.bucket(root).items[0]).items.append(root)
    elif name == "legacy_bucket":
        m.bucket(root).alg = CRUSH_BUCKET_LIST
    elif name == "no_rule":
        return m, {"ruleno": 5, "result_max": 6}
    elif name == "numrep_without_result_max":
        return m, {}
    elif name == "local_fallback_step":
        m.rules[0].steps.insert(0, CrushRuleStep(
            CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES, 3))
        return m, {"result_max": 6}
    return m, None


REFUSALS = REFUSED_CASES + [
    "non_rjenkins_hash", "local_fallback_tunable", "dangling_bucket",
    "bucket_cycle", "legacy_bucket", "no_rule", "numrep_without_result_max",
    "local_fallback_step"]


@pytest.mark.parametrize("name", REFUSALS)
def test_batch_unsupported_where_reference_refuses(name):
    m, kwargs = _refusal(name)
    pm = crush_map_from_reference(m)
    if kwargs is None:      # refused by compile_map, before device work
        with pytest.raises(jbatch.BatchUnsupported):
            jbatch.compile_map(m)
        with pytest.raises(pbatch.BatchUnsupported):
            pbatch.compile_map(pm, device="cpu")
        return
    # refused by map_batch; the rule is resolved before any tracing, so
    # the JAX side raises without compiling
    weight = make_weight(m.max_devices)
    with pytest.raises(jbatch.BatchUnsupported):
        jbatch.compile_map(m).map_batch([1, 2], weight, **kwargs)
    with pytest.raises(pbatch.BatchUnsupported):
        pbatch.compile_map(pm, device="cpu").map_batch([1, 2], weight,
                                                       **kwargs)


@pytest.mark.parametrize("result_max", [0, pbatch.CRUSH_MAX_RESULT + 1])
def test_result_max_outside_the_kernel_cap_is_refused(result_max):
    m, root = build_hierarchy(seed=1)
    m.rules.append(CrushRule(steps=RULES["ec_indep"](root)))
    cc = pbatch.compile_map(crush_map_from_reference(m), device="cpu")
    with pytest.raises(pbatch.BatchUnsupported, match="result_max"):
        cc.map_batch([1], make_weight(m.max_devices), result_max=result_max)


def test_result_max_at_the_cap_matches_scalar():
    cap = pbatch.CRUSH_MAX_RESULT
    m = build_flat([0x10000] * (2 * cap))
    m.rules[0].steps[1].arg1 = 0          # numrep = result_max
    pm = crush_map_from_reference(m)
    weight = make_weight(m.max_devices, seed=8, frac_out=0.05)
    res, cnt = pbatch.compile_map(pm, device="cpu").map_batch(
        np.arange(40), weight, result_max=cap, return_counts=True)
    assert res.shape == (40, cap)
    for x in range(40):
        want = pmapper.do_rule(pm, 0, x, cap, list(weight))
        assert res[x, :cnt[x]].tolist() == want


def test_default_result_max_covers_chained_chooses():
    m, root = build_hierarchy(seed=2)
    m.rules.append(CrushRule(steps=[
        CrushRuleStep(CRUSH_RULE_TAKE, root),
        CrushRuleStep(CRUSH_RULE_CHOOSE_FIRSTN, 2, 2),
        CrushRuleStep(CRUSH_RULE_CHOOSELEAF_FIRSTN, 2, 1),
        CrushRuleStep(CRUSH_RULE_EMIT)]))
    pm = crush_map_from_reference(m)
    res = pbatch.compile_map(pm, device="cpu").map_batch(
        [1, 2, 3], make_weight(m.max_devices))
    assert res.shape == (3, 4)       # 2 racks x 2 hosts
    for x in (1, 2, 3):
        want = pmapper.do_rule(pm, 0, x, 4, list(make_weight(m.max_devices)))
        assert [o for o in res[x - 1].tolist()
                if o != pbatch.CRUSH_ITEM_NONE] == want


# -- dispatch ---------------------------------------------------------------

def test_cpu_map_runs_the_plain_version_and_launches_nothing():
    m, result_max, weight, xs = rule_case("replicated_firstn", "jewel")
    cc = pbatch.compile_map(crush_map_from_reference(m), device="cpu")
    before = dict(pbatch.LAUNCHES)
    res, cnt = cc.map_batch(xs, weight, result_max=result_max,
                            return_counts=True)
    plain = pbatch.map_batch_plain(cc, cc.rule_cfg(0, result_max),
                                   torch.from_numpy(xs.astype(np.int64)),
                                   torch.from_numpy(weight), chunk=7)
    assert torch.equal(res, plain[0]) and torch.equal(cnt, plain[1])
    assert pbatch.LAUNCHES == before
    with pytest.raises(ValueError, match="cuda"):
        pbatch.crush_do_rule_cuda(cc, cc.rule_cfg(0, result_max),
                                  torch.from_numpy(xs.astype(np.int64)),
                                  torch.from_numpy(weight))


def test_compile_map_defaults_to_the_card():
    m = crush_map_from_reference(build_flat([0x10000] * 4))
    if torch.cuda.is_available():
        assert pbatch.compile_map(m).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pbatch.compile_map(m)
