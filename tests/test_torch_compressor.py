"""The port's compressor registry held to the reference's at tolerance 0:
the same blob bytes for every algorithm and ratio fallback, each
package decompressing the other's blobs, and the decompression cap."""
import zlib

import numpy as np
import pytest

from ceph_tpu import compressor as ref
from ceph_tpu_torch import compressor as port

ALGS = ["zlib", "bz2", "lzma", "none"]


def payloads():
    rng = np.random.default_rng(41)
    return {
        "text": b"the quick brown fox jumps over the lazy dog " * 400,
        "zeros": b"\0" * 70_000,
        "random": rng.integers(0, 256, 20_000, dtype=np.uint8).tobytes(),
        "empty": b"",
    }


@pytest.mark.parametrize("alg", ALGS)
@pytest.mark.parametrize("name", sorted(payloads()))
def test_blobs_equal_the_references(alg, name):
    data = payloads()[name]
    blob = port.compress(data, alg)
    assert blob == ref.compress(data, alg)
    assert port.decompress(ref.compress(data, alg)) == data
    assert ref.decompress(blob) == data


def test_registry_matches():
    assert port.registry.supported() == ref.registry.supported()
    with pytest.raises(ValueError):
        port.registry.create("zstd")


def test_decompression_cap_refuses_bombs():
    bomb = port.compress(b"\0" * (2 << 20), "zlib")
    with pytest.raises(ValueError):
        port.decompress(bomb, max_len=1 << 20)
    assert port.decompress(bomb, max_len=4 << 20) == b"\0" * (2 << 20)
    raw = port.compress(b"x" * 10, "none")
    with pytest.raises(ValueError):
        port.decompress(raw, max_len=5)
    with pytest.raises(ValueError):
        port.decompress(b"not a blob")
    with pytest.raises(zlib.error):
        port.decompress(b"ctpz\x01\x04zlib" + b"garbage!!")
