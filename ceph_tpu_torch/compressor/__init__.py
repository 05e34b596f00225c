"""Compressor plugins: the EC-registry pattern applied to compression.

(ref: src/compressor/Compressor.{h,cc} — `Compressor::create` factory
over a plugin registry; plugins zlib/snappy/zstd/lz4 under
src/compressor/<name>/; consumed by BlueStore's compress-on-write and
msgr v2 on-wire compression).

Plugins here wrap the stdlib codecs (zlib, lzma, bz2 — snappy/lz4
aren't in the image; the plugin surface is what parity needs).  Blobs
are self-describing: a one-line header names the algorithm, so
decompress needs no out-of-band hint (the reference stores the alg id
in the bluestore blob / frame header the same way).

The port's copy of `ceph_tpu.compressor`, whole: the registry, the
stdlib compressors, `compress`/`decompress` and the decompression cap.
Its blobs are byte-for-byte the reference's.
"""
from __future__ import annotations

import abc

_MAGIC = b"ctpz\x01"


class Compressor(abc.ABC):
    """(ref: src/compressor/Compressor.h:71)."""

    name: str = ""

    @abc.abstractmethod
    def compress(self, data: bytes) -> bytes: ...

    @abc.abstractmethod
    def decompress(self, blob: bytes) -> bytes: ...


class _StdlibCompressor(Compressor):
    def __init__(self, name: str, mod, level_kw: dict):
        self.name = name
        self._mod = mod
        self._kw = level_kw

    def compress(self, data: bytes) -> bytes:
        return self._mod.compress(bytes(data), **self._kw)

    def decompress(self, blob: bytes) -> bytes:
        return self._mod.decompress(blob)


class CompressorRegistry:
    """`Compressor::create` analogue: lazy plugin load by name
    (ref: Compressor.cc:115 create + the plugin dlopen path)."""

    def __init__(self):
        self._factories = {}
        self._register_builtins()

    def _register_builtins(self) -> None:
        import bz2
        import lzma
        import zlib
        self._factories["zlib"] = lambda: _StdlibCompressor(
            "zlib", zlib, {"level": 5})
        self._factories["bz2"] = lambda: _StdlibCompressor(
            "bz2", bz2, {"compresslevel": 5})
        # lzma stands in for zstd's ratio-over-speed point; the
        # reference's zstd/snappy/lz4 live in absent native libs
        self._factories["lzma"] = lambda: _StdlibCompressor(
            "lzma", lzma, {"preset": 1})
        self._factories["none"] = lambda: _Passthrough()

    def register(self, name: str, factory) -> None:
        self._factories[name] = factory

    def create(self, name: str) -> Compressor:
        try:
            return self._factories[name]()
        except KeyError:
            raise ValueError(f"unsupported compressor {name!r}") \
                from None

    def supported(self) -> list[str]:
        return sorted(self._factories)


class _Passthrough(Compressor):
    name = "none"

    def compress(self, data: bytes) -> bytes:
        return bytes(data)

    def decompress(self, blob: bytes) -> bytes:
        return bytes(blob)


registry = CompressorRegistry()


def compress(data: bytes, alg: str = "zlib",
             min_ratio: float = 0.95) -> bytes:
    """Self-describing compressed blob; falls back to stored-raw when
    the ratio isn't worth it (ref: BlueStore's
    compression_required_ratio check)."""
    c = registry.create(alg)
    packed = c.compress(data)
    if len(packed) >= len(data) * min_ratio:
        alg, packed = "none", bytes(data)
    tag = alg.encode()
    return _MAGIC + bytes([len(tag)]) + tag + packed


def decompress(blob: bytes, max_len: int | None = None) -> bytes:
    """`max_len` caps the DECOMPRESSED size (decompression-bomb guard
    for network input — the reference's frame layer bounds post-
    decompression size the same way)."""
    if len(blob) <= len(_MAGIC) or blob[:len(_MAGIC)] != _MAGIC:
        raise ValueError("not a compressed blob")
    n = blob[len(_MAGIC)]
    off = len(_MAGIC) + 1
    alg = blob[off:off + n].decode()
    body = blob[off + n:]
    if max_len is None:
        return registry.create(alg).decompress(body)
    return _decompress_capped(alg, body, max_len)


def _decompress_capped(alg: str, body: bytes, max_len: int) -> bytes:
    """Incremental decompression that refuses to inflate past
    max_len (stdlib decompressobj max_length)."""
    if alg == "none":
        if len(body) > max_len:
            raise ValueError("blob exceeds max_len")
        return bytes(body)
    import bz2
    import lzma
    import zlib
    d = {"zlib": zlib.decompressobj,
         "bz2": bz2.BZ2Decompressor,
         "lzma": lzma.LZMADecompressor}.get(alg)
    if d is None:
        raise ValueError(f"unsupported compressor {alg!r}")
    obj = d()
    # request one byte past the cap: an oversize stream shows up as
    # len(out) == max_len + 1 (the decompressor stops at max_length)
    out = obj.decompress(body, max_len + 1)
    if len(out) > max_len:
        raise ValueError("decompressed size exceeds max_len")
    return out
