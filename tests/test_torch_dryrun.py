"""The port's entry points (ceph_tpu_torch.dryrun) against the
reference's (`__graft_entry__.py`): `entry()`'s K1 output equals the
reference kernel's on the same batch, and `dryrun_multichip(8,
devices=["cpu"] * 8)` runs the mesh and then a mon, 16 OSDs and a client
each on its own TCP socket, at 1 MiB, with every stored chunk of the
fabric write equal to the reference `ecutil.encode` of the payload."""
import numpy as np
import pytest
import torch

from ceph_tpu.ec import registry as ref_registry
from ceph_tpu.osd import ecutil as ref_ecutil
from ceph_tpu_torch import dryrun
from test_torch_tcp import deadline  # noqa: F401  (per-test timeout)


def test_entry_equals_the_references_kernel():
    import __graft_entry__ as graft
    fn, (tables, mat, data) = dryrun.entry("cpu")
    assert fn.__name__ == "gf_matmul" and data.shape == (4, 8, 512)
    assert tables.dtype == torch.uint8 and mat.shape == (4, 8)
    batch = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (4, 8, 512), dtype=np.uint8))
    got = fn(tables, mat, batch).numpy()
    ref_fn, (bits, _zeros) = graft.entry()
    want = np.asarray(ref_fn(bits, batch.numpy()))
    assert got.dtype == np.uint8 and np.array_equal(got, want)


def test_entry_and_default_devices_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.entry()
    with pytest.raises(RuntimeError):
        dryrun.default_devices(8)


def test_dryrun_multichip_on_cpu_stores_the_references_chunks():
    res = dryrun.dryrun_multichip(8, devices=["cpu"] * 8)
    assert len(res["payload"]) == 1 << 20
    assert res["fabric"]["staged"] == 1 and res["fabric"]["fetched"] >= 11
    assert res["victim"] == [o for o in res["acting"] if o >= 0][-1]
    ec = ref_registry.factory("tpu", {"k": "8", "m": "4"})
    want = ref_ecutil.encode(ref_ecutil.StripeInfo(8, 8 * 4096), ec,
                             res["payload"])
    assert sorted(res["stored"]) == list(range(12))
    for s, got in res["stored"].items():
        assert got == bytes(want[s]), s
