"""EC stripe math + per-shard integrity hashes — the ECUtil analogue,
on the port's plugins.

Four pieces (ref: src/osd/ECUtil.{h,cc}):

* `StripeInfo` — the logical<->chunk offset algebra of `stripe_info_t`
  (ECUtil.h:27-79), verbatim semantics (pure integer math).
* `encode` / `decode` / `decode_concat` — stripe-batched plugin
  dispatch.  Where the reference loops stripe-by-stripe through the
  plugin (ECUtil.cc:120-159 encode, :9/:47 decode), this reshapes the
  whole buffer to (stripes, k, chunk) and runs ONE batched device
  launch (`encode_batch`/`decode_batch`) when the plugin supports it,
  falling back to the per-stripe loop for plugins with chunk
  remapping or sub-chunk semantics.
* repair — the plugin's partial-read plan (`repair_plan`) and the
  compiled rebuild of lost shard streams (`compiled_repair_streams`,
  K1 on the plugin's device), plus the interpreted sub-chunk path.
* `HashInfo` — cumulative per-shard crc32c (ECUtil.cc:161 append), the
  xattr-stored integrity metadata ECBackend checks on every sub-read.

The port's copy of `ceph_tpu.osd.ecutil`.
"""
from __future__ import annotations

import time
from typing import Iterable, Mapping

import numpy as np

from .. import device as _device
from ..common import devguard
from ..common.crc32c import crc32c
from ..ec.interface import ErasureCodeError
from ..ec.repairc import program_for


class StripeInfo:
    """Offset algebra between the logical object stream and per-shard
    chunk space (ref: ECUtil.h:27-79 stripe_info_t).

    stripe_size = k (data chunk count), stripe_width = k * chunk_size.
    """

    def __init__(self, stripe_size: int, stripe_width: int):
        if stripe_width % stripe_size != 0:
            raise ValueError("stripe_width must be divisible by stripe_size")
        self.stripe_width = stripe_width
        self.chunk_size = stripe_width // stripe_size

    def logical_offset_is_stripe_aligned(self, logical: int) -> bool:
        return logical % self.stripe_width == 0

    def logical_to_prev_chunk_offset(self, offset: int) -> int:
        return (offset // self.stripe_width) * self.chunk_size

    def logical_to_next_chunk_offset(self, offset: int) -> int:
        return ((offset + self.stripe_width - 1) // self.stripe_width) \
            * self.chunk_size

    def logical_to_prev_stripe_offset(self, offset: int) -> int:
        return offset - (offset % self.stripe_width)

    def logical_to_next_stripe_offset(self, offset: int) -> int:
        rem = offset % self.stripe_width
        return offset - rem + self.stripe_width if rem else offset

    def aligned_logical_offset_to_chunk_offset(self, offset: int) -> int:
        assert offset % self.stripe_width == 0
        return (offset // self.stripe_width) * self.chunk_size

    def aligned_chunk_offset_to_logical_offset(self, offset: int) -> int:
        assert offset % self.chunk_size == 0
        return (offset // self.chunk_size) * self.stripe_width

    def aligned_offset_len_to_chunk(
            self, off_len: tuple[int, int]) -> tuple[int, int]:
        off, length = off_len
        return (self.aligned_logical_offset_to_chunk_offset(off),
                self.aligned_logical_offset_to_chunk_offset(length))

    def offset_len_to_stripe_bounds(
            self, off_len: tuple[int, int]) -> tuple[int, int]:
        off, length = off_len
        start = self.logical_to_prev_stripe_offset(off)
        full_len = self.logical_to_next_stripe_offset((off - start) + length)
        return (start, full_len)


def _identity_mapping(ec) -> bool:
    mapping = ec.get_chunk_mapping()
    return not mapping or mapping == list(range(len(mapping)))


def _batchable(ec) -> bool:
    return (hasattr(ec, "encode_batch") and _identity_mapping(ec)
            and ec.get_sub_chunk_count() == 1)


def encode(sinfo: StripeInfo, ec, data: bytes,
           want: Iterable[int] | None = None) -> dict[int, bytes]:
    """Encode a stripe-aligned logical buffer into per-shard chunk
    streams (ref: ECUtil.cc:120-159).

    Returns {shard: bytes} where each shard's buffer is the
    concatenation of that shard's chunk from every stripe.  One batched
    device launch for matrix plugins; per-stripe plugin.encode
    otherwise.
    """
    k = ec.get_data_chunk_count()
    m = ec.get_coding_chunk_count()
    n = k + m
    if want is None:
        want = range(n)
    want = set(want)
    if len(data) % sinfo.stripe_width != 0:
        raise ValueError("logical size must be stripe-aligned")
    if not data:
        return {}
    nstripes = len(data) // sinfo.stripe_width
    cs = sinfo.chunk_size

    if _batchable(ec):
        arr = np.frombuffer(data, dtype=np.uint8).reshape(nstripes, k, cs)
        # one host->device copy in, one launch, one copy back; under the
        # device guard a host sync inside the launch is an error
        arr_dev = _device.as_u8(arr, ec.device)
        with devguard.guard_transfers(ec.device):
            parity_dev = ec.encode_batch(arr_dev)
        parity = parity_dev.cpu().numpy()               # (S, m, cs)
        out: dict[int, bytes] = {}
        # tobytes() on a strided view copies element by element; a
        # contiguous copy first is several times faster for the same bytes
        for shard in sorted(want):
            if shard < k:
                out[shard] = np.ascontiguousarray(arr[:, shard, :]).tobytes()
            else:
                out[shard] = np.ascontiguousarray(
                    parity[:, shard - k, :]).tobytes()
        return out

    # general path: per-stripe plugin encode (handles chunk remapping
    # and sub-chunk plugins)
    parts: dict[int, list] = {i: [] for i in want}
    for s in range(nstripes):
        stripe = data[s * sinfo.stripe_width:(s + 1) * sinfo.stripe_width]
        encoded = ec.encode(want, stripe)
        for i in want:
            chunk = encoded[i]
            assert len(chunk) == cs
            parts[i].append(np.asarray(chunk, dtype=np.uint8))
    return {i: np.concatenate(parts[i]).tobytes() for i in want}


def decode_concat(sinfo: StripeInfo, ec,
                  to_decode: Mapping[int, bytes],
                  timings: dict | None = None) -> bytes:
    """Rebuild the logical stream from >=k shard chunk streams
    (ref: ECUtil.cc:9 decode -> decode_concat per stripe).

    `timings`, when passed, receives {"stage": (t0, t1),
    "kernel": (t0, t1)} monotonic intervals separating the host-side
    survivor staging (reply buffers -> dense array layout) from the
    decode compute, so the read path's trace span can split into
    stage/kernel children."""
    if not to_decode:
        raise ValueError("decode of no shards")
    lengths = {len(v) for v in to_decode.values()}
    if len(lengths) != 1:
        raise ValueError("shard buffers differ in length")
    total = lengths.pop()
    if total % sinfo.chunk_size != 0:
        raise ValueError("shard length not chunk-aligned")
    if total == 0:
        return b""
    k = ec.get_data_chunk_count()
    nstripes = total // sinfo.chunk_size
    cs = sinfo.chunk_size

    if _batchable(ec):
        # identity mapping: shards 0..k-1 ARE the data chunks
        out = decode(sinfo, ec, to_decode, want=range(k),
                     timings=timings)
        arrs = [np.frombuffer(out[i], dtype=np.uint8).reshape(nstripes, cs)
                for i in range(k)]
        return np.ascontiguousarray(
            np.stack(arrs, axis=1)).tobytes()  # (S, k, cs) -> logical

    # general path: the plugin's decode_concat knows the chunk mapping
    # (ref: ECUtil.cc:31 per-stripe ec_impl->decode_concat)
    t0 = time.monotonic()
    views = {i: np.frombuffer(v, dtype=np.uint8)
             for i, v in to_decode.items()}
    parts = []
    for s in range(nstripes):
        chunks = {i: v[s * cs:(s + 1) * cs] for i, v in views.items()}
        stripe = ec.decode_concat(chunks)
        assert len(stripe) == sinfo.stripe_width
        parts.append(stripe)
    if timings is not None:       # per-stripe path: no separate stage
        timings["kernel"] = (t0, time.monotonic())
    return b"".join(parts)


def decode(sinfo: StripeInfo, ec, to_decode: Mapping[int, bytes],
           want: Iterable[int],
           timings: dict | None = None) -> dict[int, bytes]:
    """Reconstruct the `want` shards' chunk streams from available
    shard streams (ref: ECUtil.cc:47 decode(map out)).

    Batched: a single device launch reconstructs every stripe's
    missing chunks for matrix plugins.  `timings` (optional dict)
    receives "stage"/"kernel" monotonic intervals — see decode_concat.
    """
    want = sorted(set(want))
    avail = sorted(to_decode)
    if not to_decode:
        raise ValueError("decode of no shards")
    lengths = {len(v) for v in to_decode.values()}
    if len(lengths) != 1:
        raise ValueError("shard buffers differ in length")
    total = lengths.pop()
    if total == 0:
        return {i: b"" for i in want}
    cs = sinfo.chunk_size
    if total % cs != 0:
        raise ValueError("shard length not chunk-aligned")
    nstripes = total // cs
    k = ec.get_data_chunk_count()

    have = [i for i in want if i in to_decode]
    missing = [i for i in want if i not in to_decode]

    out: dict[int, bytes] = {i: to_decode[i] for i in have}
    if not missing:
        return out

    if _batchable(ec) and len(avail) >= k:
        decode_index = avail[:k]
        t0 = time.monotonic()
        stack = np.stack(
            [np.frombuffer(to_decode[i], dtype=np.uint8)
             .reshape(nstripes, cs) for i in decode_index], axis=1)
        t1 = time.monotonic()
        # .cpu() waits for the launch, so the kernel interval below
        # is copy in + compute + readback, never enqueue-only; the
        # launch alone is guarded, like encode's
        stack_dev = _device.as_u8(stack, ec.device)
        with devguard.guard_transfers(ec.device):
            rec_dev = ec.decode_batch(decode_index, missing, stack_dev)
        rec = rec_dev.cpu().numpy()
        t2 = time.monotonic()
        if timings is not None:
            timings["stage"] = (t0, t1)
            timings["kernel"] = (t1, t2)
        for pos, i in enumerate(missing):
            out[i] = np.ascontiguousarray(rec[:, pos, :]).tobytes()
        return out

    # general path: per-stripe plugin decode
    t0 = time.monotonic()
    parts: dict[int, list] = {i: [] for i in missing}
    for s in range(nstripes):
        chunks = {i: np.frombuffer(v, dtype=np.uint8)[s * cs:(s + 1) * cs]
                  for i, v in to_decode.items()}
        decoded = ec.decode(set(want), chunks, cs)
        for i in missing:
            parts[i].append(np.asarray(decoded[i], dtype=np.uint8))
    for i in missing:
        out[i] = np.concatenate(parts[i]).tobytes()
    if timings is not None:       # per-stripe path: no separate stage
        timings["kernel"] = (t0, time.monotonic())
    return out


# ---------------------------------------------------------------- repair
# Sub-chunk (network-optimal) single-shard repair: regenerating codes
# (clay) rebuild one lost chunk from q^(t-1)-of-q^t sub-chunk ranges
# of d helpers instead of k whole chunks (ref: ErasureCodeClay.cc:364
# get_repair_subchunks; "Fast Product-Matrix Regenerating Codes",
# arxiv 1412.3022).  These helpers translate the plugin's sub-chunk
# plan into byte extents over shard chunk STREAMS (many stripes per
# object) and drive the per-stripe repair decode.


def supports_subchunk_repair(ec) -> bool:
    """True when the plugin can rebuild a single shard from partial
    (sub-chunk) helper reads.  Non-regenerating plugins and
    sub_chunk_count == 1 codes fall back to full-chunk recovery.
    (Plan-driven recovery — repair_plan below — supersedes this gate
    for the OSD paths; it remains the sub-chunk capability probe.)"""
    return (ec.get_sub_chunk_count() > 1
            and hasattr(ec, "is_repair")
            and hasattr(ec, "minimum_to_repair")
            and hasattr(ec, "get_repair_subchunks"))


def repair_plan(ec, lost, avail):
    """The plugin's partial-read repair plan (ec.repair_schedule) for
    this erasure signature, or None — the caller then takes wholesale
    full-chunk recovery.  A plan names the helper shards, each
    helper's sub-chunk extents, and feeds the repair-schedule compiler
    (ec/repairc): clay ships q^(t-1)/q^t repair planes of d
    helpers, lrc the l whole chunks of the lost shard's local parity
    group, matrix codes k whole survivor chunks decoded straight to
    the lost shards."""
    hook = getattr(ec, "repair_schedule", None)
    if hook is None:
        return None
    try:
        return hook(set(lost), set(avail))
    except ErasureCodeError:
        return None


def compiled_repair_streams(ec, plan, chunk_size: int,
                            helper_bufs: Mapping[int, bytes],
                            backend: str | None = None,
                            device=None) -> dict[int, bytes]:
    """Rebuild every lost shard's chunk stream through the plan's
    compiled program (cached per erasure signature): gather the
    helpers' plane bytes, one GF(2^8) matmul (K1 on `device`, by
    default the plugin's own; "numpy" backend: the host oracle),
    scatter.  Byte-identical to the interpreted decode path (pinned by
    the tests/test_torch_repairc.py parity sweep)."""
    if device is None:
        device = getattr(ec, "device", None)
    return program_for(ec, plan).run(helper_bufs, chunk_size,
                                     backend=backend, device=device)


def repair_chunk_extents(ec, lost_shard: int,
                         chunk_size: int) -> list[tuple[int, int]]:
    """Byte extents WITHIN ONE CHUNK that helpers must serve to repair
    `lost_shard` (the plugin's sub-chunk plan scaled to bytes).  A
    shard stream repeats these per stripe (see ECSubRead.subchunks)."""
    sub_no = ec.get_sub_chunk_count()
    assert chunk_size % sub_no == 0
    ssz = chunk_size // sub_no
    nu = getattr(ec, "nu", 0)
    lost_node = lost_shard if lost_shard < ec.k else lost_shard + nu
    return [(idx * ssz, cnt * ssz)
            for idx, cnt in ec.get_repair_subchunks(lost_node)]


def expand_stream_extents(extents: list[tuple[int, int]],
                          chunk_size: int,
                          stream_len: int) -> list[tuple[int, int]]:
    """Per-chunk byte extents -> absolute extents over an
    nstripes x chunk_size shard stream."""
    if stream_len % chunk_size != 0:
        raise ValueError("shard stream not chunk-aligned")
    return [(s * chunk_size + off, length)
            for s in range(stream_len // chunk_size)
            for off, length in extents]


def repair_shard_stream(ec, chunk_size: int, lost_shard: int,
                        helper_bufs: Mapping[int, bytes]) -> bytes:
    """Rebuild `lost_shard`'s whole chunk stream from the helpers'
    CONCATENATED repair-plane bytes (one repair_blocksize block per
    stripe, as handle_sub_read assembles them).  Byte-identical to the
    chunk a full-decode + re-encode would produce."""
    extents = repair_chunk_extents(ec, lost_shard, chunk_size)
    rb = sum(length for _, length in extents)   # repair bytes / stripe
    lengths = {len(v) for v in helper_bufs.values()}
    if len(lengths) != 1:
        raise ValueError("helper repair buffers differ in length")
    total = lengths.pop()
    if rb == 0 or total % rb != 0:
        raise ValueError("helper buffer not repair-block aligned")
    nstripes = total // rb
    views = {s: np.frombuffer(v, dtype=np.uint8)
             for s, v in helper_bufs.items()}
    parts = []
    for st in range(nstripes):
        chunks = {s: v[st * rb:(st + 1) * rb] for s, v in views.items()}
        rebuilt = ec.decode({lost_shard}, chunks, chunk_size)
        # the plugin's own interpreted decode: host numpy, no device
        parts.append(np.asarray(rebuilt[lost_shard], dtype=np.uint8))
    return b"".join(p.tobytes() for p in parts)


class HashInfo:
    """Cumulative per-shard crc32c of everything ever appended to each
    shard (ref: ECUtil.cc:161 HashInfo::append; stored as an object
    xattr and checked by ECBackend::handle_sub_read ECBackend.cc:1059).

    Seed is -1 per shard (matching the reference's default-constructed
    cumulative_shard_hashes of (uint32_t)-1).
    """

    def __init__(self, num_chunks: int = 0):
        self.total_chunk_size = 0
        self.cumulative_shard_hashes = [0xFFFFFFFF] * num_chunks
        self.projected_total_chunk_size = 0

    def has_chunk_hash(self) -> bool:
        return bool(self.cumulative_shard_hashes)

    def append(self, old_size: int, to_append: Mapping[int, bytes]) -> None:
        if old_size != self.total_chunk_size:
            raise ValueError(
                f"append at {old_size} but shard size is "
                f"{self.total_chunk_size}")
        sizes = {len(v) for v in to_append.values()}
        if len(sizes) != 1:
            raise ValueError("shard appends differ in length")
        size_to_append = sizes.pop()
        if self.has_chunk_hash():
            if len(to_append) != len(self.cumulative_shard_hashes):
                raise ValueError("append must cover every shard")
            for shard, buf in to_append.items():
                self.cumulative_shard_hashes[shard] = crc32c(
                    self.cumulative_shard_hashes[shard], buf)
        self.total_chunk_size += size_to_append
        self.projected_total_chunk_size = max(
            self.projected_total_chunk_size, self.total_chunk_size)

    def append_shard(self, shard: int, old_size: int,
                     buf: bytes) -> None:
        """Shard-local cumulative append: when the chunk bytes exist
        only on the shard that fetched them, each shard advances ITS
        hash; other entries in this copy are never consulted on this
        shard (handle_sub_read and scrub both check
        `get_chunk_hash(self.shard)` only)."""
        if old_size != self.total_chunk_size:
            raise ValueError(
                f"append at {old_size} but shard size is "
                f"{self.total_chunk_size}")
        if self.has_chunk_hash():
            self.cumulative_shard_hashes[shard] = crc32c(
                self.cumulative_shard_hashes[shard], buf)
        self.total_chunk_size += len(buf)
        self.projected_total_chunk_size = max(
            self.projected_total_chunk_size, self.total_chunk_size)

    def get_chunk_hash(self, shard: int) -> int:
        return self.cumulative_shard_hashes[shard]

    def get_total_chunk_size(self) -> int:
        return self.total_chunk_size

    # xattr codec (JSON-ish dict instead of the reference's binary
    # ENCODE_START framing; ref: ECUtil.cc:181 encode/decode)
    def to_dict(self) -> dict:
        return {"total_chunk_size": self.total_chunk_size,
                "cumulative_shard_hashes": list(
                    self.cumulative_shard_hashes)}

    @classmethod
    def from_dict(cls, d: dict) -> "HashInfo":
        hi = cls()
        hi.total_chunk_size = d["total_chunk_size"]
        hi.cumulative_shard_hashes = list(d["cumulative_shard_hashes"])
        hi.projected_total_chunk_size = hi.total_chunk_size
        return hi

    def __eq__(self, other) -> bool:
        return (isinstance(other, HashInfo)
                and self.total_chunk_size == other.total_chunk_size
                and self.cumulative_shard_hashes
                == other.cumulative_shard_hashes)

    def __repr__(self) -> str:
        hashes = " ".join(hex(h) for h in self.cumulative_shard_hashes)
        return f"HashInfo(tcs={self.total_chunk_size} {hashes})"
