"""The port's erasure-code plugin family against the reference package.

jerasure (every technique, w = 8/16/32), isa, shec, lrc and clay of
`ceph_tpu_torch` against the same plugins of `ceph_tpu` on the CPU, on
the same seeded objects: chunk sizes, encoded chunks, every 1- and
2-erasure decode and `minimum_to_decode`; the golden corpus; the GF(2)
bit-matrix constructions and their device form.  Every output is bytes,
compared exactly."""
import hashlib
import itertools
import json
from pathlib import Path

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU for the reference)
import numpy as np
import pytest
import torch

from ceph_tpu.ec import bitmatrix as ref_bitmatrix
from ceph_tpu.ec import gfw as ref_gfw
from ceph_tpu.ec import registry as ref_registry
from ceph_tpu.ec.interface import ErasureCodeError as RefErasureCodeError
from ceph_tpu_torch.ec import bitmatrix, gfw, registry
from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.ec.kernels import bitmatmul as bm

CORPUS = json.loads((Path(__file__).resolve().parent / "fixtures"
                     / "ec_corpus.json").read_text())
CPU = torch.device("cpu")


def port(plugin, profile):
    return registry.factory(plugin, dict(profile), device="cpu")


def ref(plugin, profile):
    return ref_registry.factory(plugin, dict(profile))


# ---------------------------------------------------------------------------
# The golden corpus
# ---------------------------------------------------------------------------

def case_id(plugin, profile):
    return f"{plugin}-" + "-".join(f"{k}{v}" for k, v in sorted(profile.items())
                                   if k != "layers")


ENTRIES = CORPUS["entries"]
ENTRY_IDS = [case_id(e["plugin"], e["profile"]) for e in ENTRIES]


@pytest.mark.parametrize("entry", ENTRIES, ids=ENTRY_IDS)
def test_corpus_reencode_byte_exact(entry):
    obj = bytes.fromhex(CORPUS["object_hex"])
    ec = port(entry["plugin"], entry["profile"])
    assert ec.get_chunk_count() == entry["chunk_count"]
    assert ec.get_data_chunk_count() == entry["data_chunk_count"]
    assert ec.get_chunk_size(len(obj)) == entry["chunk_size"]
    encoded = ec.encode(set(range(entry["chunk_count"])), obj)
    for i, hexdata in entry["chunks"].items():
        assert bytes(encoded[int(i)]) == bytes.fromhex(hexdata), i


@pytest.mark.parametrize("entry", ENTRIES, ids=ENTRY_IDS)
def test_corpus_decode_sweep(entry):
    """Every erasure pattern up to min(m, 3) decodes back to the archived
    chunks; only shec and lrc may refuse a pattern, and then so must
    the reference (tests/test_ec_fixtures.py's sweep)."""
    ec = port(entry["plugin"], entry["profile"])
    rc = ref(entry["plugin"], entry["profile"])
    n = entry["chunk_count"]
    chunks = {int(i): np.frombuffer(bytes.fromhex(h), dtype=np.uint8)
              for i, h in entry["chunks"].items()}
    want = set(range(n))
    m = n - entry["data_chunk_count"]
    may_skip = entry["plugin"] in ("shec", "lrc")
    skipped = 0
    for sz in range(1, min(m, 3) + 1):
        for erasure in itertools.combinations(range(n), sz):
            avail = {i: c for i, c in chunks.items() if i not in erasure}
            try:
                minimum = ec.minimum_to_decode(want, set(avail))
            except ErasureCodeError:
                assert may_skip, erasure
                with pytest.raises(Exception):
                    rc.minimum_to_decode(want, set(avail))
                skipped += 1
                continue
            assert minimum == rc.minimum_to_decode(want, set(avail))
            decoded = ec.decode(want, avail)
            for i in range(n):
                assert np.array_equal(decoded[i], chunks[i]), (erasure, i)
    if not may_skip:
        assert skipped == 0


# ---------------------------------------------------------------------------
# Port against reference, plugin by plugin
# ---------------------------------------------------------------------------

JERASURE = [("jerasure", {"technique": t, "k": str(k), "m": str(m),
                          "w": str(w), "packetsize": "32"})
            for t, k, m in (("reed_sol_van", 4, 2), ("reed_sol_r6_op", 5, 2),
                            ("cauchy_orig", 3, 2), ("cauchy_good", 4, 2))
            for w in (8, 16, 32)]
JERASURE += [("jerasure", {"technique": t, "k": str(k), "w": str(w),
                           "packetsize": "64"})
             for t, k, w in (("liberation", 4, 5), ("liberation", 7, 7),
                             ("blaum_roth", 4, 4), ("blaum_roth", 6, 6),
                             ("liber8tion", 5, 8), ("liber8tion", 8, 8))]
OTHERS = [
    ("jerasure", {"technique": "reed_sol_van", "k": "6", "m": "3",
                  "jerasure-per-chunk-alignment": "true"}),
    ("isa", {"technique": "reed_sol_van", "k": "4", "m": "2"}),
    ("isa", {"technique": "reed_sol_van", "k": "5", "m": "1"}),
    ("isa", {"technique": "cauchy", "k": "6", "m": "3"}),
    ("shec", {"technique": "multiple", "k": "4", "m": "3", "c": "2"}),
    ("shec", {"technique": "single", "k": "6", "m": "4", "c": "2"}),
    ("lrc", {"k": "4", "m": "2", "l": "3"}),
    ("lrc", {"mapping": "__DD__DD",
             "layers": '[["_cDD_cDD", ""], ["cDDD____", ""], '
                       '["____cDDD", ""]]'}),
    ("clay", {"k": "4", "m": "2"}),
    ("clay", {"k": "6", "m": "3", "d": "8"}),
    ("clay", {"k": "4", "m": "2", "scalar_mds": "isa"}),
    ("clay", {"k": "3", "m": "2", "d": "3", "scalar_mds": "shec"}),
]
CASES = JERASURE + OTHERS
CASE_IDS = [case_id(p, pr) for p, pr in CASES]


def _same_outcome(fn_port, fn_ref):
    """Both raise, or both return the same value."""
    try:
        want = fn_ref()
    except Exception:
        with pytest.raises(ErasureCodeError):
            fn_port()
        return None
    got = fn_port()
    assert got == want
    return got


@pytest.mark.parametrize("plugin,profile", CASES, ids=CASE_IDS)
def test_plugin_matches_reference(plugin, profile):
    ec = port(plugin, profile)
    rc = ref(plugin, profile)
    n, k = ec.get_chunk_count(), ec.get_data_chunk_count()
    assert (n, k) == (rc.get_chunk_count(), rc.get_data_chunk_count())
    assert ec.get_sub_chunk_count() == rc.get_sub_chunk_count()
    assert ec.get_chunk_mapping() == rc.get_chunk_mapping()
    assert ec.get_profile() == rc.get_profile()
    for size in (1, 1000, 4097, 50_000):
        assert ec.get_chunk_size(size) == rc.get_chunk_size(size), size
    rng = np.random.default_rng(len(case_id(plugin, profile)))
    obj = rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    enc = ec.encode(set(range(n)), obj)
    enc_ref = rc.encode(set(range(n)), obj)
    assert sorted(enc) == sorted(enc_ref)
    for i in range(n):
        np.testing.assert_array_equal(enc[i], enc_ref[i], err_msg=f"chunk {i}")
    for sz in (1, 2):
        for lost in itertools.combinations(range(n), sz):
            avail = {i: enc_ref[i] for i in range(n) if i not in lost}
            _same_outcome(lambda: ec.minimum_to_decode(set(lost), set(avail)),
                          lambda: rc.minimum_to_decode(set(lost), set(avail)))
            _same_outcome(
                lambda: ec.minimum_to_decode_with_cost(
                    set(lost), {i: 1 + i % 3 for i in avail}),
                lambda: rc.minimum_to_decode_with_cost(
                    set(lost), {i: 1 + i % 3 for i in avail}))
            try:
                want = rc.decode(set(range(n)), dict(avail))
            except Exception:
                with pytest.raises(Exception):
                    ec.decode(set(range(n)), dict(avail))
                continue
            got = ec.decode(set(range(n)), dict(avail))
            for i in range(n):
                np.testing.assert_array_equal(got[i], want[i],
                                              err_msg=f"{lost} {i}")


@pytest.mark.parametrize("w", [16, 32])
def test_wide_field_matches_reference(w):
    f, rf = gfw.field(w), ref_gfw.field(w)
    rng = np.random.default_rng(w)
    x = rng.integers(0, 1 << min(w, 63), 257, dtype=np.uint64).astype(f.dtype)
    for c in (0, 1, 2, 3, 0x8001, (1 << w) - 1):
        assert np.array_equal(f.mul_words(c, x), rf.mul_words(c, x))
    for build in ("vandermonde_coding_matrix", "cauchy_original_coding_matrix",
                  "cauchy_good_coding_matrix"):
        assert np.array_equal(getattr(f, build)(4, 3),
                              getattr(rf, build)(4, 3)), build
    assert np.array_equal(f.r6_coding_matrix(5), rf.r6_coding_matrix(5))
    mat = f.vandermonde_coding_matrix(3, 2)
    data = rng.integers(0, 256, (3, 64), dtype=np.uint8)
    assert np.array_equal(f.matmul_bytes(mat, data), rf.matmul_bytes(mat, data))


def test_wide_w_has_no_repair_plan_and_w8_does():
    """Wide-word fields are not byte-linear: no compiled plan."""
    for w in (16, 32):
        ec = port("jerasure", {"k": "4", "m": "2", "w": str(w)})
        assert ec.repair_schedule({0}, {1, 2, 3, 4, 5}) is None
    ec = port("jerasure", {"k": "4", "m": "2", "w": "8"})
    plan = ec.repair_schedule({0}, {1, 2, 3, 4, 5})
    assert plan.helper_ids() == [1, 2, 3, 4] and plan.lost == (0,)
    assert ec.repair_schedule({0, 1, 2}, {3, 4, 5}) is None   # > m lost
    for plugin, profile in (("shec", {"k": "4", "m": "3", "c": "2"}),
                            ("jerasure", {"technique": "liberation",
                                          "k": "4", "w": "5"})):
        assert port(plugin, profile).repair_schedule({0}, {1, 2, 3}) is None


def test_technique_errors_match_reference():
    for plugin, profile in (
            ("jerasure", {"technique": "nosuch"}),
            ("jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2",
                          "w": "7"}),
            ("jerasure", {"technique": "liberation", "k": "3", "w": "6"}),
            ("jerasure", {"technique": "liber8tion", "k": "9"}),
            ("isa", {"technique": "liberation"}),
            ("shec", {"k": "4", "m": "3"}),
            ("shec", {"technique": "nosuch"}),
            ("clay", {"k": "4", "m": "2", "d": "6"}),
            ("clay", {"k": "4", "m": "2", "scalar_mds": "lrc"}),
            ("lrc", {"k": "4", "m": "2", "l": "5"}),
            ("nosuch", {})):
        with pytest.raises(RefErasureCodeError):
            ref(plugin, profile)
        with pytest.raises(ErasureCodeError):
            port(plugin, profile)


def test_sub_codes_follow_the_device():
    """lrc's layers and clay's scalar MDS and pairwise transform are
    built through the port's registry on the parent's device."""
    lrc = port("lrc", {"k": "4", "m": "2", "l": "3"})
    assert lrc.device == CPU
    assert all(type(layer.erasure_code).__module__.startswith(
        "ceph_tpu_torch.") and layer.erasure_code.device == CPU
        for layer in lrc.layers)
    clay = port("clay", {"k": "4", "m": "2"})
    for sub in (clay.mds, clay.pft):
        assert type(sub).__module__.startswith("ceph_tpu_torch.")
        assert sub.device == CPU


def test_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for plugin, profile in (("jerasure", {}), ("isa", {}), ("clay", {}),
                            ("lrc", {"k": "4", "m": "2", "l": "3"}),
                            ("shec", {})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            registry.factory(plugin, profile)


def test_lrc_create_rule_on_port_crush_types():
    """lrc's multi-step rule built against the port's CRUSH types."""
    from ceph_tpu_torch.crush import types as ct

    class Crush:            # the CrushWrapper surface create_rule uses
        def __init__(self):
            self.crush = ct.CrushMap()
            self.rule_name_map = {}

        def get_item_id(self, name):
            return -1 if name == "default" else None

        def get_type_id(self, name):
            return {"host": 1, "rack": 3}.get(name, -1)

    ec = port("lrc", {"k": "4", "m": "2", "l": "3",
                      "crush-locality": "rack", "crush-failure-domain": "host"})
    crush = Crush()
    rid = ec.create_rule("lrc_rule", crush)
    rule = crush.crush.rules[rid]
    assert crush.rule_name_map[rid] == "lrc_rule"
    assert [(s.op, s.arg1, s.arg2) for s in rule.steps] == [
        (ct.CRUSH_RULE_TAKE, -1, 0), (ct.CRUSH_RULE_CHOOSE_INDEP, 2, 3),
        (ct.CRUSH_RULE_CHOOSELEAF_INDEP, 4, 1), (ct.CRUSH_RULE_EMIT, 0, 0)]
    assert rule.mask.max_size == 10


# ---------------------------------------------------------------------------
# GF(2) bit-matrix codes and their device form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("build,args", [
    ("liberation_bitmatrix", (k, w)) for k, w in ((3, 5), (4, 5), (7, 7),
                                                  (5, 11))] + [
    ("blaum_roth_bitmatrix", (k, w)) for k, w in ((4, 4), (5, 6), (4, 10))] + [
    ("liber8tion_bitmatrix", (k,)) for k in (2, 5, 8)])
def test_bitmatrix_constructions_match_reference(build, args):
    g = getattr(bitmatrix, build)(*args)
    assert np.array_equal(g, getattr(ref_bitmatrix, build)(*args))
    k = args[0]
    w = g.shape[1] // k
    assert bitmatrix.is_mds(k, w, g)
    coding = g[k * w:]
    assert bitmatrix.bitmatrix_schedule(coding) == \
        ref_bitmatrix.bitmatrix_schedule(coding)


def test_gf2_inv_and_matmul_match_reference():
    rng = np.random.default_rng(11)
    for n in (4, 9, 16):
        for _ in range(5):
            m = rng.integers(0, 2, (n, n)).astype(np.uint8)
            inv, rinv = bitmatrix.gf2_inv(m), ref_bitmatrix.gf2_inv(m)
            assert (inv is None) == (rinv is None)
            if inv is not None:
                assert np.array_equal(inv, rinv)
                assert np.array_equal(bitmatrix.gf2_matmul(m, inv),
                                      np.eye(n, dtype=np.uint8))


@pytest.mark.parametrize("g", [
    bitmatrix.liber8tion_bitmatrix(8), bitmatrix.liberation_bitmatrix(7, 7),
    bitmatrix.blaum_roth_bitmatrix(6, 6)], ids=["liber8tion", "liberation",
                                                "blaum_roth"])
def test_gf2_matmul_device_matches_reference(g):
    """The device form (K1's plain version on the CPU) equals the
    reference's MXU form (XLA on the CPU) and the XOR form."""
    rows = g.shape[1]
    coding = g[rows:]
    rng = np.random.default_rng(rows)
    packets = rng.integers(0, 256, (rows, 4099), dtype=np.uint8)
    want = bitmatrix.bitmatrix_apply(coding, packets)
    assert np.array_equal(want, ref_bitmatrix.bitmatrix_apply(coding, packets))
    got = bitmatrix.gf2_matmul_device(coding, packets, device="cpu")
    assert got.device == CPU and got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(
        got.numpy(), np.asarray(ref_bitmatrix.gf2_matmul_device(coding,
                                                                packets)))
    assert np.array_equal(bitmatrix.gf2_matmul_device(
        coding, torch.from_numpy(packets), device="cpu").numpy(), want)


def test_gf2_matmul_device_is_k1_with_a_01_matrix():
    g = bitmatrix.liberation_bitmatrix(4, 5)
    coding = g[20:]
    packets = np.random.default_rng(1).integers(0, 256, (20, 64),
                                                dtype=np.uint8)
    want = bm.gf_matmul_plain(torch.from_numpy(coding.copy()),
                              torch.from_numpy(packets)[None])[0]
    assert torch.equal(bitmatrix.gf2_matmul_device(coding, packets,
                                                   device="cpu"), want)
    with pytest.raises(ValueError, match="0 or 1"):
        bitmatrix.gf2_matmul_device(coding * 2, packets, device="cpu")


@pytest.mark.parametrize("tech,k,w,digest", [
    ("liberation", 4, 5, "bd544d763a176669fbf3045c4747857d"),
    ("blaum_roth", 6, 6, "abccd484e2898b53d28a3d358376782e"),
    ("liber8tion", 8, 8, "9e0d243fe4957d8167dea5629f781a72"),
])
def test_bitmatrix_pinned_chunk_fixtures(tech, k, w, digest):
    """The reference's pinned layouts (tests/test_ec_bitmatrix.py)."""
    ec = port("jerasure", {"technique": tech, "k": str(k), "w": str(w),
                           "packetsize": "64"})
    obj = np.random.default_rng(1234).integers(0, 256, 50_000,
                                               dtype=np.uint8).tobytes()
    enc = ec.encode(set(range(k + 2)), obj)
    got = hashlib.sha256(b"".join(enc[i].tobytes() for i in range(k + 2)))
    assert got.hexdigest()[:32] == digest
