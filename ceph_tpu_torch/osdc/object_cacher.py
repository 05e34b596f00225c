"""ObjectCacher: a write-back object extent cache shared by librbd
images and CephFS file handles (ref: src/osdc/ObjectCacher.{h,cc} —
the BufferHead extent cache both libraries mount on top of the
Objecter).  The port's copy of `ceph_tpu.osdc.object_cacher`; its users
in the port are the paged artifact store (serve/store.py), rbd images
(rbd/image.py) and the cephfs client (fs/client.py: one cache per
inode, whose coherence protocol is the MDS's caps: writes buffer under
CAP_EXCL, reads are served under CAP_CACHE, and a revoke flushes and
invalidates it).

Model (page-granular BufferHeads):

* Each cached object holds fixed-size **pages** (default 64 KiB) with
  a valid set and a dirty set.  A partial-page write to an uncached
  page write-allocates: the page is first read from the backing store
  (read-modify-write), so flushing always writes fully-valid pages —
  flushing a partially-known page would overwrite backing bytes that
  were never cached.
* **Write-back**: writes land in pages and return; `flush()` pushes
  dirty pages (consecutive runs coalesced into one backing write) in
  object order.  Exceeding `max_dirty` triggers an inline flush of
  the oldest dirty object (the reference's dirty/tx throttle).
* **Bounded memory**: an LRU across objects; past `max_size`, clean
  pages of the least-recently-used objects are evicted (dirty pages
  flush first).
* **Coherence contract**: single writer per object range — exactly
  what the callers' concurrency machinery guarantees (librbd's
  exclusive lock, CephFS's CAP_EXCL/CAP_CACHE capabilities).  Cap
  revocation / lock release MUST `flush()` + `invalidate()` (the
  flush-ordering obligation ObjectCacher places on its users).

The backing store is abstracted as two callables, so the same cacher
serves rbd (object reads with parent fall-through + copyup writes)
and cephfs (striped file objects):

    read_fn(oid, off, length) -> bytes   # short/empty = sparse zeros
    write_fn(oid, off, data)  -> None

An optional third callable batches cold fills for `read_many`:

    read_many_fn([(oid, off, length), ...]) -> [bytes, ...]

Readahead is a pluggable **policy** per cacher (selectable per serve
handle): `checkpoint` is the historical sequential-doubling window,
`kvcache` is the random-page policy — no readahead, pages pinned /
refcounted by the caller, LRU eviction only among unpinned pages.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable

from ..common.lockdep import make_lock


class _CachedObject:
    __slots__ = ("pages", "valid", "dirty", "vlen", "seq_end",
                 "ra_window", "pins")

    def __init__(self):
        self.pages: dict[int, bytearray] = {}
        self.valid: set[int] = set()
        self.dirty: set[int] = set()
        #: per-page count of bytes known to exist in the backing (from
        #: the fill read) or written through this cache.  Flushing
        #: truncates a run's FINAL page to this, so a 10-byte file
        #: never grows to a 64 KiB backing object of trailing zeros
        #: (the reference's BufferHeads are byte-granular for the same
        #: reason; ref: src/osdc/ObjectCacher.h bh lengths)
        self.vlen: dict[int, int] = {}
        #: sequential-read detector (ref: src/common/Readahead.cc):
        #: where the last read ended, and the current readahead window
        self.seq_end: int = -1
        self.ra_window: int = 0
        #: page -> pin refcount; pinned pages never evict (kvcache
        #: policy: a page handed to attention kernels must stay
        #: resident until the caller unpins it)
        self.pins: dict[int, int] = {}


class ReadaheadPolicy:
    """Per-read fill-overshoot decision.  `on_read` sees the request
    and the object's detector state and returns how many bytes PAST
    the request the fill may fetch (0 = exactly the request)."""
    name = "none"

    def on_read(self, o: _CachedObject, off: int, length: int,
                page: int, max_readahead: int) -> int:
        o.seq_end = off + length
        return 0


class CheckpointReadahead(ReadaheadPolicy):
    """Sequential-resume streaming (checkpoint shards read front to
    back): a read starting where the last one ended doubles the
    window up to max_readahead; any random jump resets it — so
    amplification only ever follows a proven sequential pattern
    (ref: src/common/Readahead.cc update)."""
    name = "checkpoint"

    def on_read(self, o, off, length, page, max_readahead):
        if max_readahead and off == o.seq_end:
            o.ra_window = min(max(o.ra_window * 2, page),
                              max_readahead)
        else:
            o.ra_window = 0
        o.seq_end = off + length
        return o.ra_window


class KVCacheReadahead(ReadaheadPolicy):
    """Random-page KV-cache gets: page ids arrive in attention order,
    not address order, so readahead is pure waste — never overshoot.
    Residency is the caller's business via pin()/unpin(); eviction
    runs LRU among the unpinned only."""
    name = "kvcache"

    def on_read(self, o, off, length, page, max_readahead):
        o.seq_end = off + length
        o.ra_window = 0
        return 0


READAHEAD_POLICIES: dict[str, type[ReadaheadPolicy]] = {
    "none": ReadaheadPolicy,
    "checkpoint": CheckpointReadahead,
    "kvcache": KVCacheReadahead,
}


class ObjectCacher:
    def __init__(self, read_fn: Callable, write_fn: Callable,
                 max_dirty: int = 8 << 20, max_size: int = 32 << 20,
                 page: int = 1 << 16, max_readahead: int = 512 << 10,
                 policy: "ReadaheadPolicy | str" = "checkpoint",
                 read_many_fn: Callable | None = None):
        self._read = read_fn
        self._write = write_fn
        #: batched cold-fill: read_many() hands ALL missing runs of a
        #: wave to this in one call (the serve store wires the
        #: objecter's parallel aio fan-out here); absent, runs fill
        #: one read_fn call each
        self._read_many = read_many_fn
        self.max_dirty = max_dirty
        self.max_size = max_size
        self.page = page
        #: sequential readahead cap (ref: rbd_readahead_max_bytes /
        #: ObjectCacher's max_readahead); 0 disables
        self.max_readahead = max_readahead
        if isinstance(policy, str):
            policy = READAHEAD_POLICIES[policy]()
        self.policy = policy
        self._objs: "OrderedDict[str, _CachedObject]" = OrderedDict()
        self._lock = make_lock("osdc.object_cacher")
        # O(1) accounting: page counts maintained at every transition
        # (a per-write full scan would sit on the hot path)
        self._n_pages = 0
        self._n_dirty = 0
        self.stats = {"hit": 0, "miss": 0, "flush_writes": 0,
                      "write_back": 0, "evicted_pages": 0,
                      "readahead_pages": 0}

    # -- accounting -----------------------------------------------------
    def dirty_bytes(self) -> int:
        return self._n_dirty * self.page

    def cached_bytes(self) -> int:
        return self._n_pages * self.page

    # -- internals ------------------------------------------------------
    def _obj(self, oid: str) -> _CachedObject:
        o = self._objs.get(oid)
        if o is None:
            o = self._objs[oid] = _CachedObject()
        self._objs.move_to_end(oid)          # LRU touch
        return o

    def _install(self, o: _CachedObject, p: int,
                 buf: bytearray, vlen: int = 0) -> None:
        if p not in o.valid:
            self._n_pages += 1
        o.pages[p] = buf
        o.valid.add(p)
        o.vlen[p] = max(o.vlen.get(p, 0), vlen)

    def _fill_page(self, oid: str, o: _CachedObject, p: int) -> None:
        """Write-allocate: fetch the page so a later flush writes only
        fully-valid bytes (short backing reads zero-fill = sparse)."""
        if p in o.valid:
            return
        data = self._read(oid, p * self.page, self.page) or b""
        buf = bytearray(self.page)
        buf[:len(data)] = data
        self._install(o, p, buf, vlen=len(data))

    def _fill_span(self, oid: str, o: _CachedObject,
                   pages: list[int]) -> None:
        """Cold-read fill: ONE backing read spanning the whole missing
        window, sliced into pages — per-page reads would serialize a
        cold object read into dozens of round-trips (the aio fan-out
        the uncached path had).  Already-valid pages (possibly dirty)
        are never overwritten."""
        missing = [p for p in pages if p not in o.valid]
        if not missing:
            return
        lo, hi = min(missing), max(missing)
        data = self._read(oid, lo * self.page,
                          (hi - lo + 1) * self.page) or b""
        for p in range(lo, hi + 1):
            if p in o.valid:
                continue
            base = (p - lo) * self.page
            buf = bytearray(self.page)
            chunk = data[base:base + self.page]
            buf[:len(chunk)] = chunk
            self._install(o, p, buf, vlen=len(chunk))

    def _page_range(self, off: int, length: int):
        return range(off // self.page,
                     (off + length - 1) // self.page + 1)

    # -- data path ------------------------------------------------------
    def read(self, oid: str, off: int, length: int) -> bytes:
        if length <= 0:
            return b""
        with self._lock:
            o = self._obj(oid)
            pages = list(self._page_range(off, length))
            # the policy decides the fill overshoot — not the returned
            # bytes — past the request (checkpoint: sequential-doubling
            # window per src/common/Readahead.cc; kvcache/none: 0)
            overshoot = self.policy.on_read(o, off, length, self.page,
                                            self.max_readahead)
            fill_pages = pages
            if overshoot:
                fill_pages = list(self._page_range(
                    off, length + overshoot))
            if all(p in o.valid for p in pages):
                self.stats["hit"] += 1
            else:
                self.stats["miss"] += 1
                # count only overshoot pages the fill actually
                # fetches — a full hit (or an overshoot into already-
                # cached pages) reads nothing ahead
                self.stats["readahead_pages"] += sum(
                    1 for p in fill_pages[len(pages):]
                    if p not in o.valid)
                self._fill_span(oid, o, fill_pages)
            out = bytearray()
            for p in pages:
                out += o.pages[p]
            base = off - pages[0] * self.page
            self._maybe_evict()
            return bytes(out[base:base + length])

    def read_many(self, reqs: list[tuple[str, int, int]]
                  ) -> list[bytes]:
        """Batched multi-range read: the whole page-fetch wave hits
        the cache under ONE lock acquisition.  Missing pages across
        all requests are unioned per object, grouped into contiguous
        runs, and fetched in a single read_many_fn wave (per-run
        read_fn calls when no batcher is wired).  Results come back
        in request order.

        Accounting: one hit/miss per request (a request whose pages
        arrive via ANOTHER request's fill in the same batch is still
        a miss — it needed backing bytes); `readahead_pages` counts
        only policy-overshoot pages no request in the batch asked
        for, so a page "prefetched" for a sibling request is demand,
        not readahead."""
        if not reqs:
            return []
        with self._lock:
            plans = []          # (oid, o, pages, off, length)
            need: dict[str, set[int]] = {}     # demand pages per oid
            fill: dict[str, set[int]] = {}     # demand + overshoot
            for oid, off, length in reqs:
                if length <= 0:
                    plans.append((oid, None, [], off, length))
                    continue
                o = self._obj(oid)
                pages = list(self._page_range(off, length))
                overshoot = self.policy.on_read(
                    o, off, length, self.page, self.max_readahead)
                plans.append((oid, o, pages, off, length))
                need.setdefault(oid, set()).update(pages)
                fill.setdefault(oid, set()).update(pages)
                if overshoot:
                    fill[oid].update(self._page_range(
                        off, length + overshoot))
            # hit/miss judged against pre-fill validity
            for oid, o, pages, _, length in plans:
                if length <= 0:
                    continue
                key = "hit" if all(p in o.valid for p in pages) \
                    else "miss"
                self.stats[key] += 1
            # readahead = overshoot pages nobody demanded, not yet
            # cached, that the fill will actually fetch
            for oid, want in fill.items():
                o = self._objs[oid]
                self.stats["readahead_pages"] += sum(
                    1 for p in want - need.get(oid, set())
                    if p not in o.valid)
            # contiguous missing runs per object -> one backing wave
            fetches: list[tuple[str, int, int]] = []
            runs: list[tuple[str, int, int]] = []   # (oid, lo, n)
            for oid, want in fill.items():
                o = self._objs[oid]
                missing = sorted(p for p in want if p not in o.valid)
                lo = prev = None
                for p in missing + [None]:
                    if lo is not None and (p is None or p != prev + 1):
                        runs.append((oid, lo, prev - lo + 1))
                        fetches.append((oid, lo * self.page,
                                        (prev - lo + 1) * self.page))
                        lo = None
                    if p is not None:
                        if lo is None:
                            lo = p
                        prev = p
            if fetches:
                if self._read_many is not None:
                    datas = self._read_many(fetches)
                else:
                    datas = [self._read(oid, off, ln) or b""
                             for oid, off, ln in fetches]
                for (oid, lo, n), data in zip(runs, datas):
                    data = data or b""
                    o = self._objs[oid]
                    for p in range(lo, lo + n):
                        if p in o.valid:
                            continue
                        base = (p - lo) * self.page
                        buf = bytearray(self.page)
                        chunk = data[base:base + self.page]
                        buf[:len(chunk)] = chunk
                        self._install(o, p, buf, vlen=len(chunk))
            out: list[bytes] = []
            for oid, o, pages, off, length in plans:
                if length <= 0:
                    out.append(b"")
                    continue
                blob = bytearray()
                for p in pages:
                    blob += o.pages[p]
                base = off - pages[0] * self.page
                out.append(bytes(blob[base:base + length]))
            self._maybe_evict()
            return out

    # -- pinning (kvcache policy) ---------------------------------------
    def pin(self, oid: str, off: int, length: int) -> None:
        """Make [off, off+length) resident and bump each page's pin
        refcount; pinned pages are exempt from LRU eviction until the
        matching unpin()."""
        if length <= 0:
            return
        with self._lock:
            o = self._obj(oid)
            pages = list(self._page_range(off, length))
            self._fill_span(oid, o, pages)
            for p in pages:
                o.pins[p] = o.pins.get(p, 0) + 1

    def unpin(self, oid: str, off: int, length: int) -> None:
        """Drop one pin ref per page; at zero the page rejoins the
        LRU.  Unbalanced unpins are a caller bug -> ValueError."""
        if length <= 0:
            return
        with self._lock:
            o = self._objs.get(oid)
            if o is None:
                raise ValueError(f"unpin of uncached object {oid!r}")
            for p in self._page_range(off, length):
                n = o.pins.get(p, 0)
                if n <= 0:
                    raise ValueError(
                        f"unpin without pin: {oid!r} page {p}")
                if n == 1:
                    del o.pins[p]
                else:
                    o.pins[p] = n - 1

    def pinned_bytes(self) -> int:
        with self._lock:
            return sum(len(o.pins) for o in self._objs.values()) \
                * self.page

    def write(self, oid: str, off: int, data: bytes) -> None:
        if not data:
            return
        with self._lock:
            o = self._obj(oid)
            self.stats["write_back"] += 1
            pos = 0
            for p in self._page_range(off, len(data)):
                p_start = p * self.page
                lo = max(off, p_start) - p_start
                hi = min(off + len(data), p_start + self.page) - p_start
                if lo > 0 or hi < self.page:
                    self._fill_page(oid, o, p)     # partial page: RMW
                elif p not in o.valid:
                    self._install(o, p, bytearray(self.page))
                o.pages[p][lo:hi] = data[pos:pos + (hi - lo)]
                o.vlen[p] = max(o.vlen.get(p, 0), hi)
                pos += hi - lo
                if p not in o.dirty:
                    o.dirty.add(p)
                    self._n_dirty += 1
            if self.dirty_bytes() > self.max_dirty:
                self._flush_oldest_dirty()
            self._maybe_evict()

    def discard(self, oid: str, off: int, length: int) -> None:
        """Drop cached pages fully inside [off, off+len) and zero the
        overlap of boundary pages (the caller zeroed the backing)."""
        with self._lock:
            o = self._objs.get(oid)
            if o is None:
                return
            for p in list(self._page_range(off, length)):
                p_start = p * self.page
                lo = max(off, p_start) - p_start
                hi = min(off + length, p_start + self.page) - p_start
                if lo == 0 and hi == self.page:
                    if p in o.valid:
                        self._n_pages -= 1
                    if p in o.dirty:
                        self._n_dirty -= 1
                    o.pages.pop(p, None)
                    o.valid.discard(p)
                    o.dirty.discard(p)
                    o.vlen.pop(p, None)
                    o.pins.pop(p, None)   # discard outranks pins
                elif p in o.valid:
                    o.pages[p][lo:hi] = b"\0" * (hi - lo)

    # -- flush / invalidate ---------------------------------------------
    def _flush_obj(self, oid: str, o: _CachedObject) -> int:
        wrote = 0
        run: list[int] = []
        for p in sorted(o.dirty) + [None]:
            if run and (p is None or p != run[-1] + 1):
                start = run[0] * self.page
                blob = b"".join(bytes(o.pages[q]) for q in run)
                # truncate the run's tail to the last page's known
                # length: writing the zero padding would extend the
                # backing object past its logical size
                tail = o.vlen.get(run[-1], self.page)
                blob = blob[:(len(run) - 1) * self.page + tail]
                self._write(oid, start, blob)
                self.stats["flush_writes"] += 1
                wrote += len(blob)
                run = []
            if p is not None:
                run.append(p)
        self._n_dirty -= len(o.dirty)
        o.dirty.clear()
        return wrote

    def flush(self, oid: str | None = None) -> int:
        """Push dirty pages to the backing store; returns bytes
        written.  MUST run before a cap/lock is surrendered."""
        with self._lock:
            items = [(oid, self._objs[oid])] if oid is not None and \
                oid in self._objs else \
                ([] if oid is not None else list(self._objs.items()))
            return sum(self._flush_obj(k, o) for k, o in items
                       if o.dirty)

    def _flush_oldest_dirty(self) -> None:
        for oid, o in self._objs.items():      # LRU order
            if o.dirty:
                self._flush_obj(oid, o)
                return

    def invalidate(self, oid: str | None = None,
                   discard_dirty: bool = False) -> None:
        """Drop cached state.  Dirty pages are flushed first unless
        the caller explicitly discards them (rollback/resize paths)."""
        with self._lock:
            oids = [oid] if oid is not None else list(self._objs)
            for k in oids:
                o = self._objs.get(k)
                if o is None:
                    continue
                if o.dirty and not discard_dirty:
                    self._flush_obj(k, o)
                self._n_pages -= len(o.valid)
                self._n_dirty -= len(o.dirty)
                del self._objs[k]

    def _maybe_evict(self) -> None:
        """LRU eviction of clean UNPINNED pages once past max_size
        (pinned pages are promised-resident until unpin)."""
        while self.cached_bytes() > self.max_size:
            for oid, o in self._objs.items():
                clean = [p for p in o.valid
                         if p not in o.dirty and not o.pins.get(p)]
                if clean:
                    for p in clean:
                        o.pages.pop(p, None)
                        o.valid.discard(p)
                        o.vlen.pop(p, None)
                        self._n_pages -= 1
                        self.stats["evicted_pages"] += 1
                    if not o.pages:
                        del self._objs[oid]
                    break
            else:
                # everything is dirty: flush the oldest, then retry
                before = self.dirty_bytes()
                self._flush_oldest_dirty()
                if self.dirty_bytes() >= before:
                    return                      # cannot make progress
