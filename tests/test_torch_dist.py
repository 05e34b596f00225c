"""The port's mesh (ceph_tpu_torch.dist) against the JAX package's.

The reference MeshECCoder runs on the conftest's 8-device JAX CPU mesh,
the port's on a grid of ["cpu"] * 8 (K1's plain version per position,
the partials XORed per stripe row); parity and decodes must be equal,
byte for byte (tolerance 0).  Each reference coder is built once per
module and at shapes no other test file uses: its jit step compiles
once per signature under the conftest's jaxguard.
"""
import itertools
import threading

import numpy as np
import pytest
import torch

from ceph_tpu.dist import MeshECCoder as RefMeshECCoder
from ceph_tpu.dist import make_mesh as ref_make_mesh
from ceph_tpu.ec import gf as ref_gf
from ceph_tpu_torch.dist import ICIFabric, MeshECCoder, make_mesh
from ceph_tpu_torch.dist.mesh_ec import ShardedStripes
from ceph_tpu_torch.ec import registry
from ceph_tpu_torch.ec.kernels import bitmatmul as bm

CPU8 = ["cpu"] * 8
N_ENC, N_DEC = 384, 160
DEC_K, DEC_M = 4, 2


@pytest.fixture(scope="module")
def jax_devices():
    import jax
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs the 8-device CPU mesh (conftest env)")
    return devs


@pytest.fixture(scope="module")
def encode_case(jax_devices):
    """{shard_ways: (data, reference parity)} for k=8 m=4."""
    out = {}
    for ways in (1, 2, 4):
        ref = RefMeshECCoder(8, 4, ref_make_mesh(8, shard_ways=ways, k=8))
        rng = np.random.default_rng(100 + ways)
        data = rng.integers(0, 256, (2 * (8 // ways), 8, N_ENC),
                            dtype=np.uint8)
        out[ways] = (data, np.asarray(ref.encode(ref.shard_data(data))))
    return out


@pytest.mark.parametrize("shard_ways", [1, 2, 4])
def test_mesh_encode_equals_reference(encode_case, shard_ways):
    data, want = encode_case[shard_ways]
    mesh = make_mesh(8, shard_ways=shard_ways, k=8, devices=CPU8)
    assert mesh.devices.shape == (8 // shard_ways, shard_ways)
    coder = MeshECCoder(8, 4, mesh)
    sharded = coder.shard_data(data)
    s, kl = data.shape[0] // (8 // shard_ways), 8 // shard_ways
    assert [[tuple(b.shape) for b in row] for row in sharded.blocks] == \
        [[(s, kl, N_ENC)] * shard_ways] * (8 // shard_ways)
    bm.reset_launches()
    parity = coder.encode(sharded)
    assert isinstance(parity, ShardedStripes)
    # stripe-sharded: one (s, m, N) block per stripe row
    assert [len(row) for row in parity.blocks] == [1] * (8 // shard_ways)
    got = parity.numpy()
    assert got.shape == (data.shape[0], 4, N_ENC)
    assert np.array_equal(got, want)
    assert coder.check_parity(data, parity)
    assert bm.LAUNCHES["gf_matmul"] == 0      # the CPU runs the plain version


@pytest.fixture(scope="module")
def decode_case(jax_devices):
    """The reference's k=4 m=2 coder on shard_ways 4, its data and
    parity, and every two-erasure pattern's reconstruction."""
    ref = RefMeshECCoder(DEC_K, DEC_M,
                         ref_make_mesh(8, shard_ways=4, k=DEC_K))
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, (4, DEC_K, N_DEC), dtype=np.uint8)
    parity = np.asarray(ref.encode(ref.shard_data(data)))
    full = np.concatenate([data, parity], axis=1)
    recs = {}
    for erasure in itertools.combinations(range(DEC_K + DEC_M), 2):
        idx = [i for i in range(DEC_K + DEC_M) if i not in erasure][:DEC_K]
        surv = ref.shard_data(np.ascontiguousarray(full[:, idx, :]))
        recs[erasure] = np.asarray(ref.decode(idx, list(erasure), surv))
    return full, recs


@pytest.fixture(scope="module")
def port_decoder():
    return MeshECCoder(DEC_K, DEC_M, make_mesh(8, shard_ways=4, k=DEC_K,
                                               devices=CPU8))


@pytest.mark.parametrize("erasure", list(itertools.combinations(
    range(DEC_K + DEC_M), 2)))
def test_mesh_decode_equals_reference(decode_case, port_decoder, erasure):
    full, recs = decode_case
    coder = port_decoder
    assert np.array_equal(
        coder.encode(coder.shard_data(full[:, :DEC_K])).numpy(),
        full[:, DEC_K:])
    idx = [i for i in range(DEC_K + DEC_M) if i not in erasure][:DEC_K]
    got = coder.decode(idx, list(erasure), coder.shard_data(
        np.ascontiguousarray(full[:, idx, :]))).numpy()
    assert np.array_equal(got, recs[erasure])
    for row, e in enumerate(erasure):
        assert np.array_equal(got[:, row], full[:, e])


def test_mesh_decode_operators_cached_per_signature():
    coder = MeshECCoder(DEC_K, DEC_M, make_mesh(8, shard_ways=4, k=DEC_K,
                                                devices=CPU8))
    data = np.random.default_rng(4).integers(0, 256, (2, DEC_K, 64),
                                             dtype=np.uint8)
    surv = coder.shard_data(data)
    coder.decode([0, 1, 2, 4], [3, 5], surv)
    assert len(coder._ops) == 4               # one operator per position
    coder.decode([0, 1, 2, 4], [3, 5], surv)
    assert len(coder._ops) == 4 and len(coder._dec) == 1
    coder.decode([0, 2, 3, 4], [1, 5], surv)
    assert len(coder._ops) == 8 and len(coder._dec) == 2


VALIDATION = {
    "shard_ways=3": (lambda: ref_make_mesh(8, shard_ways=3, k=8),
                     lambda: make_mesh(8, shard_ways=3, k=8, devices=CPU8)),
    "n=10000": (lambda: ref_make_mesh(10_000),
                lambda: make_mesh(10_000, devices=CPU8)),
    "k=5": (lambda: RefMeshECCoder(5, 2, ref_make_mesh(8, shard_ways=2, k=8)),
            lambda: MeshECCoder(5, 2, make_mesh(8, shard_ways=2, k=8,
                                                devices=CPU8))),
}


@pytest.mark.parametrize("case", list(VALIDATION))
def test_mesh_validation_as_reference(jax_devices, case):
    """The reference's three validation cases raise ValueError in both
    packages."""
    ref, port = VALIDATION[case]
    with pytest.raises(ValueError):
        ref()
    with pytest.raises(ValueError):
        port()


def test_mesh_default_is_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ICIFabric()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(8, devices=["cuda:0"] * 8)


def test_mesh_refuses_mixed_device_types(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="one type"):
        make_mesh(2, shard_ways=1, k=8, devices=["cpu", "cuda:0"])


def test_fabric_concurrent_stage_and_fetch():
    """tests/test_dist.py's concurrency case on the port's fabric and
    the port's `tpu` plugin: k+m shard fetches run concurrently with
    two more stages; the dispatch lock keeps one mesh step in flight,
    nothing deadlocks and every slice equals the host encode."""
    k, m, cs = 8, 4, 256
    ec = registry.factory("tpu", {"k": str(k), "m": str(m)}, device="cpu")
    fab = ICIFabric(8, devices=CPU8)
    assert fab.supports(ec)
    rng = np.random.default_rng(13)
    segs = {w: rng.integers(0, 256, 2 * k * cs, dtype=np.uint8)
            .tobytes() for w in range(3)}
    fab.stage_encode(("w", 0), ec, segs[0], cs)

    results: dict[tuple[int, int], bytes] = {}
    errors: list[BaseException] = []

    def fetch(write, shard):
        try:
            results[(write, shard)] = fab.fetch_chunk(("w", write), shard)
        except BaseException as ex:   # noqa: BLE001 — surfaced below
            errors.append(ex)

    def stage(write):
        try:
            fab.stage_encode(("w", write), ec, segs[write], cs)
            for s in range(k + m):
                fetch(write, s)
        except BaseException as ex:   # noqa: BLE001
            errors.append(ex)

    threads = [threading.Thread(target=fetch, args=(0, s), daemon=True)
               for s in range(k + m)]
    threads += [threading.Thread(target=stage, args=(w,), daemon=True)
                for w in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), \
        "fabric mesh dispatch deadlocked"
    assert not errors, errors
    for w, seg in segs.items():
        arr = np.frombuffer(seg, dtype=np.uint8).reshape(2, k, cs)
        parity = np.stack([ref_gf.gf_matmul_bytes(ec.encode_matrix[k:], a)
                           for a in arr])
        for s in range(k + m):
            want = (arr[:, s, :] if s < k
                    else parity[:, s - k, :]).tobytes()
            assert results[(w, s)] == want, (w, s)
    assert fab.stats["staged"] == 3 and fab.stats["fetched"] == 3 * (k + m)
    for w in segs:
        fab.release(("w", w))
    assert fab.staged_count() == 0
