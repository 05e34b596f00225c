"""ArtifactStore: paged model artifacts (checkpoints, KV-cache page
pools) on RADOS.

The serving workload (ref: Ragged Paged Attention, arxiv 2604.15464)
needs two access patterns from the same bytes:

* **checkpoint streaming** — N readers each pull a shard front to
  back as fast as the pool allows; sequential readahead wins.
* **KV-cache page gets** — ragged lists of page ids in attention
  order, latency-bound; readahead is waste, residency is managed by
  the caller (pin/unpin), and the fetch must be ONE parallel aio
  wave, not a read-per-page loop (the SSD-array EC study, arxiv
  1709.05365: small-op amplification dominates at scale).

Layout: shard bytes are a fixed page grid striped over epoch-
versioned objects by the osdc Striper; the manifest (see
manifest.py) is the commit point.  Because data objects are
immutable once the manifest names them, the page wave submits its
reads `unordered` — the objecter's per-object ordering would
serialize N same-object reads that have nothing to order.

The port's copy of `ceph_tpu.serve.store`.
"""
from __future__ import annotations

import contextlib
import logging

from ..client.rados import IoCtx, RadosError
from ..common.options import global_config
from ..common.tracing import Tracer, child_of, current_trace, \
    new_trace, trace_scope
from ..osdc.object_cacher import ObjectCacher
from ..osdc.striper import StripeLayout, Striper
from .manifest import ArtifactManifest, ShardInfo, data_oid, \
    manifest_oid, paginate, shard_from_pages

#: default artifact page (KV block / fetch granule) — 64 KiB, the
#: ObjectCacher's native page size
DEFAULT_PAGE = 1 << 16


def default_layout(page_size: int = DEFAULT_PAGE) -> StripeLayout:
    """Stripe pages over 2 objects per set, 4 pages per stripe unit:
    wide enough that a stream fans out and a page wave spreads over
    PGs, small enough that tests stay cheap."""
    return StripeLayout(stripe_unit=4 * page_size, stripe_count=2,
                        object_size=16 * page_size)


class ArtifactStore:
    """Pool-level artifact catalog + page fetch engine."""

    def __init__(self, ioctx: IoCtx, page_size: int = DEFAULT_PAGE,
                 layout: StripeLayout | None = None):
        self.io = ioctx
        self.page_size = page_size
        self.layout = layout or default_layout(page_size)
        self.layout.validate()
        self.tracer = Tracer("serve")

    # ------------------------------------------------------------ write
    def put(self, name: str,
            shards: dict[str, bytes] | None = None,
            pages: dict[str, list[bytes]] | None = None
            ) -> ArtifactManifest:
        """Publish an artifact.  `shards` maps shard name -> byte
        stream (checkpoint shards: pages full except a ragged tail);
        `pages` maps shard name -> explicit page list (KV blocks: any
        page ragged).  Data objects land under a FRESH epoch, the
        manifest write is the commit, then the prior epoch's objects
        are removed best-effort — a reader mid-stream on the old
        manifest still sees consistent bytes until its next open."""
        shards = shards or {}
        pages = pages or {}
        if not shards and not pages:
            raise ValueError("put() needs shards= and/or pages=")
        dup = set(shards) & set(pages)
        if dup:
            raise ValueError(f"shard(s) in both shards= and pages=: "
                             f"{sorted(dup)}")
        old = self._manifest_or_none(name)
        epoch = (old.epoch + 1) if old is not None else 1

        info: dict[str, ShardInfo] = {}
        page_lists: dict[str, list[bytes]] = {}
        for s, blob in shards.items():
            n, size, vlens = paginate(blob, self.page_size)
            info[s] = ShardInfo(n_pages=n, size=size, vlens=vlens)
            page_lists[s] = [
                blob[p * self.page_size:(p + 1) * self.page_size]
                for p in range(n)]
        for s, plist in pages.items():
            info[s] = shard_from_pages(plist, self.page_size)
            page_lists[s] = plist

        m = ArtifactManifest(name=name, epoch=epoch,
                             page_size=self.page_size,
                             layout=self.layout, shards=info)
        # compose whole objects host-side, ONE write_full per data
        # object (EC-friendly: no partial-stripe overwrites), then a
        # single parallel write wave
        bufs: dict[str, bytearray] = {}
        for s, plist in page_lists.items():
            for pid, blob in enumerate(plist):
                pos = 0
                for ext in m.page_extents(s, pid):
                    oid = data_oid(name, epoch, s, ext.objectno)
                    buf = bufs.setdefault(oid, bytearray())
                    end = ext.offset + ext.length
                    if len(buf) < end:
                        buf.extend(b"\0" * (end - len(buf)))
                    buf[ext.offset:end] = blob[pos:pos + ext.length]
                    pos += ext.length
        futs = [self.io.aio_write_full(oid, bytes(buf))
                for oid, buf in sorted(bufs.items())]
        for fut in futs:
            self.io._wait(fut)
        self.io.write_full(manifest_oid(name), m.to_json())
        if old is not None:
            self._remove_epoch(old)
        return m

    def _remove_epoch(self, m: ArtifactManifest) -> int:
        futs = [self.io.aio_remove(oid) for oid in m.data_oids()]
        gone = 0
        for fut in futs:
            try:
                self.io._wait(fut)
                gone += 1
            except RadosError as e:
                # already gone is the goal; anything else is garbage
                # we must not fail a successful put over — the next
                # epoch flip retries nothing (objects are orphaned),
                # so at least surface it
                if e.errno_name != "ENOENT":
                    logging.getLogger("ceph_tpu_torch.serve").warning(
                        "epoch cleanup: %s", e)
        return gone

    def delete(self, name: str) -> int:
        """Remove the artifact: data objects then the manifest.
        Returns the number of objects removed."""
        m = self.manifest(name)
        gone = self._remove_epoch(m)
        self.io.remove(manifest_oid(name))
        return gone + 1

    # ------------------------------------------------------------- read
    def manifest(self, name: str) -> ArtifactManifest:
        return ArtifactManifest.from_json(
            self.io.read(manifest_oid(name)))

    def _manifest_or_none(self, name: str
                          ) -> ArtifactManifest | None:
        try:
            return self.manifest(name)
        except RadosError as e:
            if e.errno_name != "ENOENT":
                raise
            return None

    def stat(self, name: str) -> dict:
        m = self.manifest(name)
        return {
            "name": m.name, "epoch": m.epoch,
            "page_size": m.page_size,
            "layout": {"stripe_unit": m.layout.stripe_unit,
                       "stripe_count": m.layout.stripe_count,
                       "object_size": m.layout.object_size},
            "objects": len(m.data_oids()),
            "bytes": sum(si.size for si in m.shards.values()),
            "shards": {s: {"size": si.size, "n_pages": si.n_pages,
                           "ragged_pages": len(si.vlens)}
                       for s, si in sorted(m.shards.items())},
        }

    def _read_one(self, oid: str, off: int, length: int) -> bytes:
        """Backing read with sparse semantics: a never-written range
        (ragged-page gap, zero page) reads as empty."""
        try:
            return self.io.read(oid, length, off)
        except RadosError as e:
            if e.errno_name != "ENOENT":
                raise
            return b""

    def read_wave(self, fetches: list[tuple[str, int, int]]
                  ) -> list[bytes]:
        """One parallel aio read wave: ALL submits go out before any
        wait, and each read is `unordered` so same-object reads don't
        serialize behind the objecter's per-object queue.  This is
        both the page-fetch engine and the ObjectCacher read_many_fn
        the serve handles mount."""
        futs = [self.io.aio_read(oid, length, off, unordered=True)
                for oid, off, length in fetches]
        out: list[bytes] = []
        for fut in futs:
            try:
                out.append(self.io._wait(fut).data)
            except RadosError as e:
                if e.errno_name != "ENOENT":
                    raise
                out.append(b"")         # sparse: unwritten reads empty
        return out

    def fetch_pages(self, name: str, shard: str,
                    page_ids: list[int], batched: bool = True,
                    manifest: ArtifactManifest | None = None
                    ) -> list[bytes]:
        """Fetch a ragged page-id list, results in page-id order,
        each byte-exact (ragged pages come back at their valid
        length).  `batched=True` (the real path) coalesces adjacent
        extents per object and issues ONE parallel read wave;
        `batched=False` is the read-per-page loop the wave replaces,
        kept as the bench baseline."""
        m = manifest or self.manifest(name)
        si = m.shards[shard]        # KeyError = no such shard
        # segment plan: (oid, obj_off, length, page_index, dest_off)
        segs: list[tuple[str, int, int, int, int]] = []
        sizes: list[int] = []
        for i, pid in enumerate(page_ids):
            sizes.append(si.vlen(pid, m.page_size))
            dest = 0
            for ext in m.page_extents(shard, pid):
                segs.append((data_oid(m.name, m.epoch, shard,
                                      ext.objectno),
                             ext.offset, ext.length, i, dest))
                dest += ext.length
        span = None
        ctx = current_trace()
        if global_config()["blkin_trace_all"]:
            ctx = child_of(ctx) if ctx else new_trace()
            span = self.tracer.start_span(
                ctx, f"serve_fetch:{name}/{shard}")
        scope = trace_scope(ctx) if span is not None \
            else contextlib.nullcontext()
        with scope:
            if batched:
                chunks = self._wave_coalesced(segs, span)
            else:
                chunks = [self._read_one(oid, off, ln)
                          for oid, off, ln, _, _ in segs]
        bufs = [bytearray(sz) for sz in sizes]
        for (_, _, ln, i, dest), chunk in zip(segs, chunks):
            chunk = chunk[:ln]
            bufs[i][dest:dest + len(chunk)] = chunk
        self.tracer.finish(span)
        return [bytes(b) for b in bufs]

    def _wave_coalesced(self, segs, span=None) -> list[bytes]:
        """Coalesce overlapping/adjacent same-object segments into
        runs, read the runs in one wave, slice segments back out."""
        order = sorted(range(len(segs)),
                       key=lambda i: (segs[i][0], segs[i][1]))
        runs: list[list[int]] = []      # [oid, start, end]
        where: dict[int, tuple[int, int]] = {}  # seg -> (run, delta)
        for i in order:
            oid, off, ln = segs[i][:3]
            if runs and runs[-1][0] == oid and off <= runs[-1][2]:
                runs[-1][2] = max(runs[-1][2], off + ln)
            else:
                runs.append([oid, off, off + ln])
            where[i] = (len(runs) - 1, off - runs[-1][1])
        datas = self.read_wave([(oid, start, end - start)
                                for oid, start, end in runs])
        if span is not None:
            span.event(f"pages={len(set(s[3] for s in segs))} "
                       f"segs={len(segs)} runs={len(runs)}")
        out: list[bytes] = []
        for i in range(len(segs)):
            run_i, delta = where[i]
            ln = segs[i][2]
            out.append(datas[run_i][delta:delta + ln])
        return out

    # ---------------------------------------------------------- handles
    def open(self, name: str, policy: str = "checkpoint",
             cache_bytes: int = 32 << 20,
             max_readahead: int = 512 << 10) -> "ArtifactHandle":
        """Open for reading with a per-handle readahead policy:
        `checkpoint` (sequential-doubling) for streaming,
        `kvcache` (no readahead, pin/refcount) for page gets."""
        return ArtifactHandle(self, self.manifest(name), policy,
                              cache_bytes=cache_bytes,
                              max_readahead=max_readahead)


def _ro_write(oid: str, off: int, data: bytes) -> None:
    raise RadosError("EROFS", "serve artifact handles are read-only")


class ArtifactHandle:
    """A read session pinned to one manifest epoch: an ObjectCacher
    over the artifact's data objects with the chosen readahead
    policy, plus pin/unpin residency control for KV pages."""

    def __init__(self, store: ArtifactStore, m: ArtifactManifest,
                 policy: str = "checkpoint",
                 cache_bytes: int = 32 << 20,
                 max_readahead: int = 512 << 10):
        self.store = store
        self.m = m
        self.policy = policy
        self.cacher = ObjectCacher(
            store._read_one, _ro_write,
            max_size=cache_bytes,
            page=min(m.page_size, m.layout.stripe_unit),
            max_readahead=max_readahead, policy=policy,
            read_many_fn=store.read_wave)

    @property
    def stats(self) -> dict:
        return self.cacher.stats

    def _stream_shard(self, shard: str) -> ShardInfo:
        si = self.m.shards[shard]
        if any(k != si.n_pages - 1 for k in si.vlens):
            raise ValueError(
                f"shard {shard!r} has interior ragged pages — a page "
                f"pool, not a stream; use get_pages()")
        return si

    def read(self, shard: str, offset: int = 0,
             length: int | None = None) -> bytes:
        """Stream read of a checkpoint shard's byte range (pages full
        except the ragged tail, so shard bytes == logical bytes
        [0, size))."""
        si = self._stream_shard(shard)
        if length is None:
            length = si.size - offset
        length = max(0, min(length, si.size - offset))
        if length == 0:
            return b""
        parts = []
        for ext in Striper.file_to_extents(self.m.layout, offset,
                                           length):
            oid = data_oid(self.m.name, self.m.epoch, shard,
                           ext.objectno)
            parts.append(self.cacher.read(oid, ext.offset,
                                          ext.length))
        return b"".join(parts)

    def read_shard(self, shard: str, chunk: int = 1 << 20) -> bytes:
        """Whole shard, streamed through the cache in `chunk` steps
        (exercises the policy's sequential detector the way a real
        loader would)."""
        si = self._stream_shard(shard)
        parts = []
        off = 0
        while off < si.size:
            n = min(chunk, si.size - off)
            parts.append(self.read(shard, off, n))
            off += n
        return b"".join(parts)

    def _page_segs(self, shard: str, page_ids: list[int]):
        segs = []       # (oid, off, ln) per extent, page-major order
        sizes = []
        bounds = []     # per page: (first_seg_index, n_segs)
        si = self.m.shards[shard]
        for pid in page_ids:
            sizes.append(si.vlen(pid, self.m.page_size))
            first = len(segs)
            for ext in self.m.page_extents(shard, pid):
                segs.append((data_oid(self.m.name, self.m.epoch,
                                      shard, ext.objectno),
                             ext.offset, ext.length))
            bounds.append((first, len(segs) - first))
        return segs, sizes, bounds

    def get_pages(self, shard: str, page_ids: list[int],
                  pin: bool = False) -> list[bytes]:
        """Batched page get through the cache: one read_many wave
        (one cacher lock acquisition; cold fills batched via the
        store's parallel read wave).  `pin=True` refcounts the pages
        resident until unpin_pages()."""
        segs, sizes, bounds = self._page_segs(shard, page_ids)
        chunks = self.cacher.read_many([s for s in segs])
        out = []
        for (first, n), size in zip(bounds, sizes):
            buf = b"".join(chunks[first:first + n])
            out.append(buf[:size])
        if pin:
            for oid, off, ln in segs:
                self.cacher.pin(oid, off, ln)
        return out

    def unpin_pages(self, shard: str, page_ids: list[int]) -> None:
        segs, _, _ = self._page_segs(shard, page_ids)
        for oid, off, ln in segs:
            self.cacher.unpin(oid, off, ln)

    def close(self) -> None:
        self.cacher.invalidate()
