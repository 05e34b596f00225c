"""Erasure-code plugin contract and shared base plumbing.

Python rendering of Ceph's EC plugin boundary with the exact method surface
of `ErasureCodeInterface` (ref: src/erasure-code/ErasureCodeInterface.h:170-462)
and the shared base-class behavior of `ErasureCode`
(ref: src/erasure-code/ErasureCode.{h,cc}):

* systematic codes: an object is split into k data chunks; m coding chunks
  are computed from them; any k of the k+m chunks recover the object;
* `get_chunk_size(object_size)` defines per-plugin padding/alignment;
* `encode` pads the input with zeros to k*chunk_size and delegates the math
  to `encode_chunks` (ref: ErasureCode.cc:151-207 encode_prepare/encode);
* `decode` fills in missing chunks then delegates to `decode_chunks`;
* an optional `mapping=` profile string remaps chunk positions
  (ref: ErasureCode.cc:274 to_mapping);
* `minimum_to_decode` defaults to "any k available chunks" greedy
  (ref: ErasureCode.cc:103 _minimum_to_decode).

Buffers are numpy uint8 arrays internally; `bytes` at the outer API.

The port's own copy of `ceph_tpu.ec.interface`.  Every plugin holds the
device its kernels run on (`self.device`, None -> cuda); the plugins'
own math (encode, interpreted decode) stays host numpy.
"""
from __future__ import annotations

import abc
from typing import Iterable, Mapping

import numpy as np

from .. import device as _device

ErasureCodeProfile = dict  # str -> str, like Ceph's ErasureCodeProfile

SIMD_ALIGN = 32  # ref: ErasureCode.cc:42 (buffer alignment; informational here)


class ErasureCodeError(Exception):
    """Raised where the C++ interface returns -EINVAL/-EIO/-ENOENT."""


def to_int(name: str, profile: ErasureCodeProfile, default: str) -> int:
    v = profile.setdefault(name, default)
    if v == "":
        v = profile[name] = default
    try:
        return int(v)
    except ValueError as e:
        raise ErasureCodeError(f"could not convert {name}={v!r} to int") from e


def to_bool(name: str, profile: ErasureCodeProfile, default: str) -> bool:
    v = str(profile.setdefault(name, default)).lower()
    return v in ("yes", "true", "1")


def sanity_check_k_m(k: int, m: int) -> None:
    if k < 2:
        raise ErasureCodeError(f"k={k} must be >= 2")
    if m < 1:
        raise ErasureCodeError(f"m={m} must be >= 1")


class ErasureCodeInterface(abc.ABC):
    """Abstract EC plugin contract (ErasureCodeInterface.h:170-462)."""

    @abc.abstractmethod
    def init(self, profile: ErasureCodeProfile) -> None:
        """Initialize from a profile; raises ErasureCodeError on bad profiles."""

    @abc.abstractmethod
    def get_profile(self) -> ErasureCodeProfile: ...

    @abc.abstractmethod
    def get_chunk_count(self) -> int:
        """k + m."""

    @abc.abstractmethod
    def get_data_chunk_count(self) -> int:
        """k."""

    def get_coding_chunk_count(self) -> int:
        return self.get_chunk_count() - self.get_data_chunk_count()

    def get_sub_chunk_count(self) -> int:
        """Sub-chunk granularity (1 except for regenerating codes like clay)."""
        return 1

    @abc.abstractmethod
    def get_chunk_size(self, object_size: int) -> int: ...

    @abc.abstractmethod
    def minimum_to_decode(self, want_to_read: set, available: set
                          ) -> dict[int, list[tuple[int, int]]]:
        """chunk id -> list of (sub-chunk offset, count) to read."""

    @abc.abstractmethod
    def minimum_to_decode_with_cost(self, want_to_read: set,
                                    available: Mapping[int, int]) -> set: ...

    def repair_schedule(self, erasures: set, available: set):
        """RepairPlan (ceph_tpu_torch.ec.repairc) for rebuilding
        `erasures` whole from partial helper reads, or None when this
        code has no better schedule than wholesale full-chunk recovery
        for the signature.  Plans feed the repair-schedule compiler: the
        OSD recovery paths lower a returned plan to one fused
        gather/matmul/scatter program, cached per signature."""
        return None

    @abc.abstractmethod
    def encode(self, want_to_encode: Iterable[int], data: bytes
               ) -> dict[int, np.ndarray]: ...

    @abc.abstractmethod
    def encode_chunks(self, want_to_encode: Iterable[int],
                      encoded: dict[int, np.ndarray]) -> None: ...

    @abc.abstractmethod
    def decode(self, want_to_read: Iterable[int],
               chunks: Mapping[int, np.ndarray], chunk_size: int = 0
               ) -> dict[int, np.ndarray]: ...

    @abc.abstractmethod
    def decode_chunks(self, want_to_read: Iterable[int],
                      chunks: Mapping[int, np.ndarray],
                      decoded: dict[int, np.ndarray]) -> None: ...

    @abc.abstractmethod
    def get_chunk_mapping(self) -> list[int]: ...

    @abc.abstractmethod
    def decode_concat(self, chunks: Mapping[int, np.ndarray]) -> bytes: ...

    def create_rule(self, name: str, crush) -> int:
        """Create a CRUSH rule suitable for this code (indep/erasure);
        implemented by the base class once a CrushWrapper is supplied."""
        raise NotImplementedError


def _as_chunk(buf, blocksize: int) -> np.ndarray:
    a = np.frombuffer(buf, dtype=np.uint8) if isinstance(buf, (bytes, bytearray, memoryview)) \
        else np.asarray(buf, dtype=np.uint8)
    if a.size == blocksize:
        return a
    out = np.zeros(blocksize, dtype=np.uint8)
    out[:a.size] = a
    return out


class ErasureCode(ErasureCodeInterface):
    """Shared plumbing mirroring src/erasure-code/ErasureCode.{h,cc}."""

    def __init__(self, device=None) -> None:
        self.device = _device.resolve(device)
        self._profile: ErasureCodeProfile = {}
        self.chunk_mapping: list[int] = []
        self.rule_root = "default"
        self.rule_failure_domain = "host"
        self.rule_device_class = ""

    # -- profile -----------------------------------------------------------
    def init(self, profile: ErasureCodeProfile) -> None:
        self.rule_root = profile.setdefault("crush-root", "default")
        self.rule_failure_domain = profile.setdefault("crush-failure-domain", "host")
        self.rule_device_class = profile.setdefault("crush-device-class", "")
        self._profile = profile

    def get_profile(self) -> ErasureCodeProfile:
        return self._profile

    def parse(self, profile: ErasureCodeProfile) -> None:
        """Base parse: the `mapping=` remap string (ErasureCode.cc:274)."""
        mapping = profile.get("mapping")
        if mapping:
            data_pos = [i for i, c in enumerate(mapping) if c == "D"]
            coding_pos = [i for i, c in enumerate(mapping) if c != "D"]
            self.chunk_mapping = data_pos + coding_pos

    def chunk_index(self, i: int) -> int:
        return self.chunk_mapping[i] if i < len(self.chunk_mapping) else i

    def get_chunk_mapping(self) -> list[int]:
        return self.chunk_mapping

    # -- minimum_to_decode -------------------------------------------------
    def _minimum_to_decode(self, want_to_read: set, available: set) -> set:
        if want_to_read <= available:
            return set(want_to_read)
        k = self.get_data_chunk_count()
        if len(available) < k:
            raise ErasureCodeError("EIO: not enough available chunks")
        return set(sorted(available)[:k])

    def minimum_to_decode(self, want_to_read: set, available: set
                          ) -> dict[int, list[tuple[int, int]]]:
        ids = self._minimum_to_decode(set(want_to_read), set(available))
        sub = [(0, self.get_sub_chunk_count())]
        return {i: list(sub) for i in ids}

    def minimum_to_decode_with_cost(self, want_to_read: set,
                                    available: Mapping[int, int]) -> set:
        return self._minimum_to_decode(set(want_to_read), set(available))

    # -- encode ------------------------------------------------------------
    def encode_prepare(self, data: bytes) -> dict[int, np.ndarray]:
        """Split + zero-pad into k data chunks, allocate m coding chunks
        (ref: ErasureCode.cc:151 encode_prepare)."""
        k = self.get_data_chunk_count()
        m = self.get_coding_chunk_count()
        blocksize = self.get_chunk_size(len(data))
        raw = np.frombuffer(data, dtype=np.uint8)
        encoded: dict[int, np.ndarray] = {}
        for i in range(k):
            encoded[self.chunk_index(i)] = _as_chunk(
                raw[i * blocksize:(i + 1) * blocksize], blocksize)
        for i in range(k, k + m):
            encoded[self.chunk_index(i)] = np.zeros(blocksize, dtype=np.uint8)
        return encoded

    def encode(self, want_to_encode: Iterable[int], data: bytes
               ) -> dict[int, np.ndarray]:
        want = set(want_to_encode)
        encoded = self.encode_prepare(data)
        self.encode_chunks(want, encoded)
        return {i: c for i, c in encoded.items() if i in want}

    # -- decode ------------------------------------------------------------
    def _decode(self, want_to_read: set, chunks: Mapping[int, np.ndarray]
                ) -> dict[int, np.ndarray]:
        chunks = {i: np.asarray(c, dtype=np.uint8) for i, c in chunks.items()}
        if want_to_read <= set(chunks):
            return {i: chunks[i] for i in want_to_read}
        if not chunks:
            raise ErasureCodeError("EIO: no chunks")
        k = self.get_data_chunk_count()
        m = self.get_coding_chunk_count()
        blocksize = len(next(iter(chunks.values())))
        decoded = {}
        for i in range(k + m):
            decoded[i] = (chunks[i].copy() if i in chunks
                          else np.zeros(blocksize, dtype=np.uint8))
        self.decode_chunks(want_to_read, chunks, decoded)
        return {i: decoded[i] for i in want_to_read}

    def decode(self, want_to_read: Iterable[int],
               chunks: Mapping[int, np.ndarray], chunk_size: int = 0
               ) -> dict[int, np.ndarray]:
        return self._decode(set(want_to_read), chunks)

    def decode_concat(self, chunks: Mapping[int, np.ndarray]) -> bytes:
        k = self.get_data_chunk_count()
        want = {self.chunk_index(i) for i in range(k)}
        decoded = self._decode(want, chunks)
        return b"".join(decoded[self.chunk_index(i)].tobytes() for i in range(k))

    # -- crush rule --------------------------------------------------------
    def create_rule(self, name: str, crush) -> int:
        """indep/erasure rule under crush-root with crush-failure-domain
        (ref: ErasureCode.cc:64 create_rule -> add_simple_rule).  The
        rule mask must admit pool.size == k+m — wide codes exceed the
        legacy default ceiling of 10."""
        return crush.add_simple_rule(
            name, self.rule_root, self.rule_failure_domain,
            self.rule_device_class, "indep", rule_type="erasure",
            max_size=self.get_chunk_count())
