"""EC stripe math — the ECUtil analogue, on the port's plugins.

Two pieces (ref: src/osd/ECUtil.{h,cc}):

* `StripeInfo` — the logical<->chunk offset algebra of `stripe_info_t`
  (ECUtil.h:27-79), verbatim semantics (pure integer math).
* `encode` / `decode` / `decode_concat` — stripe-batched plugin
  dispatch.  Where the reference loops stripe-by-stripe through the
  plugin (ECUtil.cc:120-159 encode, :9/:47 decode), this reshapes the
  whole buffer to (stripes, k, chunk) and runs ONE batched device
  launch (`encode_batch`/`decode_batch`) when the plugin supports it,
  falling back to the per-stripe loop for plugins with chunk
  remapping or sub-chunk semantics.

The port's copy of `ceph_tpu.osd.ecutil` up to the repair helpers;
sub-chunk repair and `HashInfo` come with later parts of the port.
"""
from __future__ import annotations

import time
from typing import Iterable, Mapping

import numpy as np


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
        # one host->device copy in, one launch, one copy back
        parity = ec.encode_batch(arr).cpu().numpy()     # (S, m, cs)
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
        # is copy in + compute + readback, never enqueue-only
        rec = ec.decode_batch(decode_index, missing, stack).cpu().numpy()
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
