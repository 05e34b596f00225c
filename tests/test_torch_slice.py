"""The whole ported slice against the reference, on the CPU.

ECUtil encode -> lose shards -> decode / decode_concat at k=8 m=4, a
4096-byte chunk and 8 stripes, through the port's `tpu` plugin and
through the reference `ceph_tpu.osd.ecutil` with the reference `tpu`
plugin, on the same bytes made with numpy.  Shard streams and rebuilt
objects must be byte-identical."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest

from ceph_tpu.ec import registry as ref_registry
from ceph_tpu.osd import ecutil as ref_ecutil
from ceph_tpu_torch.ec import registry
from ceph_tpu_torch.ec.kernels import bitmatmul as bm
from ceph_tpu_torch.osd import ecutil

K, M, CHUNK, STRIPES = 8, 4, 4096, 8


@pytest.fixture(scope="module")
def codes():
    profile = {"k": str(K), "m": str(M), "technique": "reed_sol_van"}
    return (registry.factory("tpu", profile, device="cpu"),
            ref_registry.factory("tpu", profile))


@pytest.fixture(scope="module")
def logical():
    rng = np.random.default_rng(2026)
    return rng.integers(0, 256, STRIPES * K * CHUNK, dtype=np.uint8).tobytes()


def test_encode_shards_equal_reference(codes, logical):
    ec, ref = codes
    sinfo = ecutil.StripeInfo(K, K * CHUNK)
    ref_sinfo = ref_ecutil.StripeInfo(K, K * CHUNK)
    shards = ecutil.encode(sinfo, ec, logical)
    ref_shards = ref_ecutil.encode(ref_sinfo, ref, logical)
    assert sorted(shards) == list(range(K + M))
    for i in range(K + M):
        assert len(shards[i]) == STRIPES * CHUNK
        assert shards[i] == ref_shards[i], f"shard {i}"
    sub = ecutil.encode(sinfo, ec, logical, want=[0, 9])
    assert sorted(sub) == [0, 9] and sub[9] == ref_shards[9]
    assert ecutil.encode(sinfo, ec, b"") == {}
    with pytest.raises(ValueError, match="stripe-aligned"):
        ecutil.encode(sinfo, ec, logical[:-1])


@pytest.mark.parametrize("lost", [[1, 9], [0], [10, 11], [2, 3, 5, 7],
                                  [8, 9, 10, 11]])
def test_degraded_read_equals_reference(codes, logical, lost):
    ec, ref = codes
    sinfo = ecutil.StripeInfo(K, K * CHUNK)
    shards = ecutil.encode(sinfo, ec, logical)
    degraded = {i: v for i, v in shards.items() if i not in lost}
    timings = {}
    bm.reset_launches()
    assert ecutil.decode_concat(sinfo, ec, degraded, timings) == logical
    assert set(timings) <= {"stage", "kernel"}
    assert bm.LAUNCHES == {"gf_matmul": 0, "gf_decode_select": 0}  # cpu
    rebuilt = ecutil.decode(sinfo, ec, degraded, want=range(K + M))
    ref_rebuilt = ref_ecutil.decode(ref_ecutil.StripeInfo(K, K * CHUNK), ref,
                                    degraded, want=range(K + M))
    for i in range(K + M):
        assert rebuilt[i] == shards[i] == ref_rebuilt[i], (lost, i)


def test_full_width_decode_over_shard_streams(codes, logical):
    """The staging-free path on the same streams: arrival layout with
    garbage in the lost slots rebuilds exactly what ECUtil decode does."""
    ec, ref = codes
    sinfo = ecutil.StripeInfo(K, K * CHUNK)
    shards = ecutil.encode(sinfo, ec, logical)
    arrival = np.stack([np.frombuffer(shards[i], dtype=np.uint8)
                        .reshape(STRIPES, CHUNK) for i in range(K + M)], 1)
    lost = [1, 9]
    garbled = arrival.copy()
    garbled[:, lost] = 0x5A
    got = ec.decode_batch_full(lost, garbled).numpy()
    np.testing.assert_array_equal(got, arrival[:, lost])
    np.testing.assert_array_equal(
        got, np.asarray(ref.decode_batch_full(lost, jnp.asarray(garbled))))


def test_remapped_profile_takes_per_stripe_path():
    """A `mapping=` profile is not batchable: both ECUtils fall back to
    the per-stripe plugin loop and agree byte for byte (on multi-erasure
    patterns too, where the matrix code's decode does not undo the
    remapping in either package)."""
    profile = {"k": "4", "m": "2", "mapping": "DD_DD_"}
    ec = registry.factory("tpu", profile, device="cpu")
    ref = ref_registry.factory("tpu", profile)
    assert not ecutil._batchable(ec)
    cs = 256
    data = np.random.default_rng(3).integers(
        0, 256, 3 * 4 * cs, dtype=np.uint8).tobytes()
    shards = ecutil.encode(ecutil.StripeInfo(4, 4 * cs), ec, data)
    ref_shards = ref_ecutil.encode(ref_ecutil.StripeInfo(4, 4 * cs), ref,
                                   data)
    assert shards == ref_shards
    for lost in itertools.combinations(range(6), 2):
        avail = {i: v for i, v in shards.items() if i not in lost}
        assert ecutil.decode_concat(ecutil.StripeInfo(4, 4 * cs), ec,
                                    avail) == ref_ecutil.decode_concat(
            ref_ecutil.StripeInfo(4, 4 * cs), ref, avail), lost


def test_stripe_info_algebra_equals_reference():
    a = ecutil.StripeInfo(K, K * CHUNK)
    b = ref_ecutil.StripeInfo(K, K * CHUNK)
    for off in (0, 1, CHUNK, K * CHUNK - 1, K * CHUNK, 3 * K * CHUNK + 5):
        for fn in ("logical_offset_is_stripe_aligned",
                   "logical_to_prev_chunk_offset",
                   "logical_to_next_chunk_offset",
                   "logical_to_prev_stripe_offset",
                   "logical_to_next_stripe_offset"):
            assert getattr(a, fn)(off) == getattr(b, fn)(off), (fn, off)
        assert a.offset_len_to_stripe_bounds((off, 777)) == \
            b.offset_len_to_stripe_bounds((off, 777))
    assert a.aligned_offset_len_to_chunk((K * CHUNK, 2 * K * CHUNK)) == \
        b.aligned_offset_len_to_chunk((K * CHUNK, 2 * K * CHUNK))
    with pytest.raises(ValueError):
        ecutil.StripeInfo(3, 100)
