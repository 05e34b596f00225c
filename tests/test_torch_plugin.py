"""The port's `tpu` plugin against the reference plugins, on the CPU.

Chunks and decoded shards must be byte-identical to the reference `tpu`,
`isa` and `jerasure` plugins and to the golden corpus."""
import itertools
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.ec import registry as ref_registry
from ceph_tpu_torch.ec import gf, registry
from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.ec.matrix_code import DecodeTableCache
from ceph_tpu_torch.ec.plugins import tpu

CORPUS = Path(__file__).resolve().parent / "fixtures" / "ec_corpus.json"


def port(k, m, technique="reed_sol_van", **extra):
    return registry.factory("tpu", {"k": str(k), "m": str(m),
                                    "technique": technique, **extra},
                            device="cpu")


def arrival(em, k, m, erasures, rng, stripes, nbytes):
    """(S, n, N) chunk array with garbage in the erased slots, and the
    true rows of the erased slots."""
    data = rng.integers(0, 256, (stripes, k, nbytes), dtype=np.uint8)
    parity = np.stack([gf.gf_matmul_bytes(em[k:], d) for d in data])
    full = np.concatenate([data, parity], axis=1)
    want = full[:, erasures].copy()
    full[:, erasures] = rng.integers(0, 256, (stripes, len(erasures), nbytes),
                                     dtype=np.uint8)
    return full, want


@pytest.mark.parametrize("k,m,technique,ref_plugin,ref_profile", [
    (8, 4, "reed_sol_van", "tpu", {"technique": "reed_sol_van"}),
    (8, 4, "reed_sol_van", "isa", {"technique": "reed_sol_van"}),
    (4, 2, "cauchy", "isa", {"technique": "cauchy"}),
    (6, 3, "jerasure_reed_sol_van", "jerasure", {"technique": "reed_sol_van"}),
    (5, 2, "reed_sol_r6_op", "jerasure", {"technique": "reed_sol_r6_op"}),
    (4, 3, "cauchy_orig", "tpu", {"technique": "cauchy_orig"}),
    (4, 3, "cauchy_good", "jerasure",
     {"technique": "cauchy_good", "packetsize": "32"}),
])
def test_parity_with_reference_plugins(k, m, technique, ref_plugin,
                                       ref_profile):
    ec = port(k, m, technique)
    ref = ref_registry.factory(ref_plugin, dict(ref_profile, k=str(k),
                                                m=str(m)))
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, 8192, dtype=np.uint8).tobytes()
    size = max(ref.get_chunk_size(len(data)), ec.get_chunk_size(len(data))) * k
    data = data + b"\0" * (size - len(data))
    n = k + m
    enc_ref = ref.encode(set(range(n)), data)
    enc = ec.encode(set(range(n)), data)
    for i in range(n):
        np.testing.assert_array_equal(enc[i], enc_ref[i], err_msg=f"chunk {i}")
    for erasures in itertools.combinations(range(n), min(m, 2)):
        avail = {i: enc[i] for i in range(n) if i not in erasures}
        dec = ec.decode(set(range(n)), avail)
        for i in range(n):
            np.testing.assert_array_equal(dec[i], enc_ref[i],
                                          err_msg=f"{erasures} {i}")
    assert ec.decode_concat({i: enc[i] for i in range(1, n)}) == \
        ref.decode_concat({i: enc_ref[i] for i in range(1, n)})


def test_profile_surface_matches_reference():
    for profile in ({"k": "8", "m": "4"}, {"k": "5", "m": "3",
                                          "tpu-alignment": "64"},
                    {"k": "4", "m": "2", "mapping": "DD_DD_"}):
        ec = registry.factory("tpu", profile, device="cpu")
        ref = ref_registry.factory("tpu", profile)
        assert ec.get_profile() == ref.get_profile()
        assert ec.get_chunk_mapping() == ref.get_chunk_mapping()
        for size in (1, 1000, 1 << 20, 4097):
            assert ec.get_chunk_size(size) == ref.get_chunk_size(size)
        avail = set(range(1, ec.get_chunk_count()))
        assert ec.minimum_to_decode({0, 1}, avail) == \
            ref.minimum_to_decode({0, 1}, avail)
    with pytest.raises(ErasureCodeError):
        registry.factory("tpu", {"k": "1", "m": "2"}, device="cpu")
    with pytest.raises(ErasureCodeError, match="m=2"):
        port(4, 3, "reed_sol_r6_op")
    with pytest.raises(ErasureCodeError, match="ENOENT"):
        port(4, 2, "liberation")
    with pytest.raises(ErasureCodeError, match="ENOENT"):
        registry.factory("nosuch", {"k": "4", "m": "2"}, device="cpu")


def test_corpus_tpu_entries():
    corpus = json.loads(CORPUS.read_text())
    obj = bytes.fromhex(corpus["object_hex"])
    entries = [e for e in corpus["entries"] if e["plugin"] == "tpu"]
    assert entries
    for entry in entries:
        ec = registry.factory("tpu", dict(entry["profile"]), device="cpu")
        n = entry["chunk_count"]
        assert ec.get_chunk_count() == n
        assert ec.get_chunk_size(len(obj)) == entry["chunk_size"]
        encoded = ec.encode(set(range(n)), obj)
        chunks = {int(i): bytes.fromhex(h) for i, h in entry["chunks"].items()}
        for i, want in chunks.items():
            assert bytes(encoded[i]) == want, (entry["profile"], i)
        m = n - entry["data_chunk_count"]
        for sz in range(1, m + 1):
            for erasure in itertools.combinations(range(n), sz):
                avail = {i: np.frombuffer(c, dtype=np.uint8)
                         for i, c in chunks.items() if i not in erasure}
                decoded = ec.decode(set(range(n)), avail)
                for i in range(n):
                    assert bytes(decoded[i]) == chunks[i], (erasure, i)


def test_exhaustive_erasure_sweep_k4m2_against_reference():
    """Every pattern of up to m erasures: the port's staged and
    full-width decodes rebuild the lost rows, equal to the reference
    plugin's decode on the same inputs."""
    k, m = 4, 2
    n = k + m
    ec = port(k, m)
    ref = ref_registry.factory("tpu", {"k": str(k), "m": str(m)})
    rng = np.random.default_rng(42)
    for sz in range(1, m + 1):
        for erasures in itertools.combinations(range(n), sz):
            erasures = list(erasures)
            full, want = arrival(ec.encode_matrix, k, m, erasures, rng, 2, 96)
            got = ec.decode_batch_full(erasures, full).numpy()
            np.testing.assert_array_equal(got, want, err_msg=str(erasures))
            decode_index = [i for i in range(n) if i not in erasures][:k]
            staged = ec.decode_batch(decode_index, erasures,
                                     full[:, decode_index]).numpy()
            np.testing.assert_array_equal(staged, want)
            ref_out = np.asarray(ref.decode_batch(
                decode_index, erasures, jnp.asarray(full[:, decode_index])))
            np.testing.assert_array_equal(staged, ref_out)


def test_sampled_erasure_sweep_k8m4_against_reference():
    k, m = 8, 4
    n = k + m
    ec = port(k, m)
    ref = ref_registry.factory("tpu", {"k": str(k), "m": str(m)})
    rng = np.random.default_rng(8)
    patterns = list(itertools.combinations(range(n), 2))
    picks = [list(patterns[i]) for i in rng.choice(len(patterns), 8,
                                                   replace=False)]
    picks += [[0], [11], [0, 1, 2, 3], [8, 9, 10, 11], [1, 4, 9]]
    for erasures in picks:
        full, want = arrival(ec.encode_matrix, k, m, erasures, rng, 3, 160)
        got = ec.decode_batch_full(erasures, full).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(erasures))
        ref_out = np.asarray(ref.decode_batch_full(erasures,
                                                   jnp.asarray(full)))
        np.testing.assert_array_equal(got, ref_out)


def test_batched_encode_matches_reference_and_oracle():
    ec = port(8, 4)
    ref = ref_registry.factory("tpu", {"k": "8", "m": "4"})
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, (4, 8, 512), dtype=np.uint8)
    parity = ec.encode_batch(data)
    assert isinstance(parity, torch.Tensor) and parity.shape == (4, 4, 512)
    np.testing.assert_array_equal(
        parity.numpy(), np.asarray(ref.encode_batch(jnp.asarray(data))))
    for s in range(4):
        np.testing.assert_array_equal(
            parity[s].numpy(), gf.gf_matmul_bytes(ec.encode_matrix[8:], data[s]))
    np.testing.assert_array_equal(ec.encode_batch(torch.from_numpy(data)),
                                  parity)


def test_decode_batches_full_pipeline_matches_reference():
    k, m = 4, 2
    ec = port(k, m)
    ref = ref_registry.factory("tpu", {"k": str(k), "m": str(m)})
    rng = np.random.default_rng(9)
    erasures = [1, 4]
    batches, wants = [], []
    for _ in range(3):
        full, want = arrival(ec.encode_matrix, k, m, erasures, rng, 1, 256)
        batches.append(full)
        wants.append(want)
    outs = [o.numpy() for o in ec.decode_batches_full(erasures, batches)]
    refs = [np.asarray(o) for o in ref.decode_batches_full(erasures, batches)]
    assert len(outs) == len(refs) == 3
    for got, r, want in zip(outs, refs, wants):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, r)
    assert list(ec.decode_batches_full(erasures, [])) == []


def test_decode_batch_full_too_few_valid_is_eio():
    ec = port(4, 2)
    valid = np.array([1, 1, 1, 0, 0, 1], dtype=bool)
    with pytest.raises(ErasureCodeError, match="EIO"):
        ec.decode_batch_full([0], np.zeros((1, 6, 64), dtype=np.uint8),
                             valid=valid)


def test_decode_table_cache_cost_weighted_eviction():
    c = DecodeTableCache(capacity=10)
    c.put("d1", "densemat1", cost=4)
    c.put("d2", "densemat2", cost=4)
    c.put("full-1", "fullmat1", cost=6)      # 14 > 10: evicts d1
    assert c.get("d1") is None
    assert c.get("d2") == "densemat2"
    assert c.get("full-1") == "fullmat1"
    assert c.total_cost() == 10
    c.put("full-2", "fullmat2", cost=6)      # evicts d2 and full-1
    assert c.get("d2") is None and c.get("full-1") is None
    assert c.total_cost() == 6
    c.put("huge", "hugemat", cost=99)        # never thrash to empty
    assert c.get("huge") == "hugemat" and len(c) >= 1


def test_plugin_decode_cache_costs_and_bound():
    k, m = 4, 2
    n = k + m
    ec = port(k, m)
    assert ec.DECODE_LRU_WIDTH == 2516 * 8
    rng = np.random.default_rng(0)
    ec.decode_batch_full([1], rng.integers(0, 256, (1, n, 32), dtype=np.uint8))
    assert ec._decode_mm.total_cost() == n               # full-width: n
    ec.decode_batch([0, 2, 3, 4], [1],
                    rng.integers(0, 256, (1, k, 32), dtype=np.uint8))
    assert ec._decode_mm.total_cost() == n + k           # dense: k
    ec._decode_mm.capacity = 4 * 6
    for erasures in itertools.combinations(range(n), 2):
        decode_index = [i for i in range(n) if i not in erasures][:k]
        ec.decode_batch(decode_index, list(erasures),
                        rng.integers(0, 256, (1, k, 64), dtype=np.uint8))
    assert ec._decode_mm.total_cost() <= ec._decode_mm.capacity
    assert len(ec._decode_mm) <= 6


def test_from_reference_carries_matrices():
    for technique, k, m in (("reed_sol_van", 8, 4), ("cauchy_good", 4, 3),
                            ("reed_sol_r6_op", 6, 2)):
        ref = ref_registry.factory("tpu", {"k": str(k), "m": str(m),
                                           "technique": technique})
        ec = tpu.from_reference(np.asarray(ref.encode_matrix), k, m,
                                technique, device="cpu")
        np.testing.assert_array_equal(ec.encode_matrix, ref.encode_matrix)
        assert ec.device == torch.device("cpu")
    wrong = np.asarray(ref_registry.factory(
        "tpu", {"k": "8", "m": "4", "technique": "cauchy"}).encode_matrix)
    with pytest.raises(AssertionError, match="differs"):
        tpu.from_reference(wrong, 8, 4, "reed_sol_van", device="cpu")


def test_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.factory("tpu", {"k": "8", "m": "4"})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpu.ErasureCodeTpu()
