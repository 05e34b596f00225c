"""Artifact manifest: the durable catalog of a paged artifact.

An artifact (a model checkpoint, a KV-cache block pool) is a set of
named **shards**, each a sequence of fixed-size **pages** striped
over RADOS objects by the osdc Striper.  Ragged pages (the tail of a
checkpoint shard, short KV blocks) are carried byte-exact via
per-page valid lengths — the page GRID stays uniform so the layout
math stays uniform, only the byte counts differ (the same trick the
ObjectCacher's per-page vlen plays; ref: src/osdc/ObjectCacher.h
byte-granular BufferHeads).

The manifest itself is one JSON object (`<name>.manifest`) written
LAST by put(): data objects are epoch-versioned
(`<name>.e<epoch>.<shard>.<objectno:016x>`) and never overwritten, so
the manifest flip is the commit point and readers holding an older
manifest keep reading consistent bytes mid-republish.

The port's copy of `ceph_tpu.serve.manifest`: the same JSON bytes and
object names, so either package reads what the other wrote.
"""
from __future__ import annotations

import json

from dataclasses import dataclass, field

from ..osdc.striper import ObjectExtent, StripeLayout, Striper

#: current manifest encoding version (bump on incompatible change)
MANIFEST_VERSION = 1


def manifest_oid(name: str) -> str:
    return f"{name}.manifest"


def data_oid(name: str, epoch: int, shard: str, objectno: int) -> str:
    """Epoch-versioned data object name: a re-put writes a fresh
    epoch's objects and flips the manifest, never overwriting live
    ones (which is what makes unordered page reads safe)."""
    return f"{name}.e{epoch}.{shard}.{objectno:016x}"


@dataclass
class ShardInfo:
    """One shard's page accounting.

    `vlens` holds ONLY the ragged pages (valid length < page_size);
    absent pages are full.  `size` is the shard's total valid bytes
    (== sum of per-page valid lengths).
    """
    n_pages: int
    size: int
    vlens: dict[int, int] = field(default_factory=dict)

    def vlen(self, page_id: int, page_size: int) -> int:
        return self.vlens.get(page_id, page_size)

    def to_json(self) -> dict:
        return {"n_pages": self.n_pages, "size": self.size,
                "vlens": {str(k): v for k, v in
                          sorted(self.vlens.items())}}

    @classmethod
    def from_json(cls, d: dict) -> "ShardInfo":
        return cls(n_pages=int(d["n_pages"]), size=int(d["size"]),
                   vlens={int(k): int(v)
                          for k, v in d.get("vlens", {}).items()})


@dataclass
class ArtifactManifest:
    name: str
    epoch: int
    page_size: int
    layout: StripeLayout
    shards: dict[str, ShardInfo]

    def to_json(self) -> bytes:
        return json.dumps({
            "version": MANIFEST_VERSION,
            "name": self.name,
            "epoch": self.epoch,
            "page_size": self.page_size,
            "layout": {"stripe_unit": self.layout.stripe_unit,
                       "stripe_count": self.layout.stripe_count,
                       "object_size": self.layout.object_size},
            "shards": {s: si.to_json()
                       for s, si in sorted(self.shards.items())},
        }, sort_keys=True).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "ArtifactManifest":
        d = json.loads(raw.decode())
        ver = int(d.get("version", 0))
        if ver > MANIFEST_VERSION:
            raise ValueError(f"manifest version {ver} from the future")
        lay = d["layout"]
        return cls(
            name=d["name"], epoch=int(d["epoch"]),
            page_size=int(d["page_size"]),
            layout=StripeLayout(stripe_unit=int(lay["stripe_unit"]),
                                stripe_count=int(lay["stripe_count"]),
                                object_size=int(lay["object_size"])),
            shards={s: ShardInfo.from_json(si)
                    for s, si in d["shards"].items()})

    # ---------------------------------------------------- layout math
    def page_extents(self, shard: str, page_id: int
                     ) -> list[ObjectExtent]:
        """Object extents holding page `page_id`'s VALID bytes.  Page
        p lives at logical [p*page_size, p*page_size + vlen) of the
        shard's striped address space; a ragged page simply maps to
        shorter extents (the grid slot past vlen is never stored)."""
        si = self.shards[shard]
        if not 0 <= page_id < si.n_pages:
            raise IndexError(
                f"page {page_id} out of range (shard {shard!r} has "
                f"{si.n_pages} pages)")
        v = si.vlen(page_id, self.page_size)
        if v == 0:
            return []
        return Striper.file_to_extents(
            self.layout, page_id * self.page_size, v)

    def shard_objects(self, shard: str) -> list[int]:
        """All objectnos a shard's pages touch (delete/cleanup set)."""
        si = self.shards[shard]
        objs: set[int] = set()
        for p in range(si.n_pages):
            for ext in self.page_extents(shard, p):
                objs.add(ext.objectno)
        return sorted(objs)

    def data_oids(self) -> list[str]:
        return [data_oid(self.name, self.epoch, shard, objno)
                for shard in sorted(self.shards)
                for objno in self.shard_objects(shard)]


def paginate(data: bytes, page_size: int) -> tuple[int, int,
                                                   dict[int, int]]:
    """Stream -> (n_pages, size, ragged vlens): every page full
    except a ragged tail when len(data) is not page-aligned."""
    size = len(data)
    n_pages = max(1, -(-size // page_size))
    vlens: dict[int, int] = {}
    tail = size - (n_pages - 1) * page_size
    if tail != page_size:
        vlens[n_pages - 1] = tail
    return n_pages, size, vlens


def shard_from_pages(pages: list[bytes], page_size: int) -> ShardInfo:
    """Explicit page list (KV-cache blocks): any page may be ragged,
    each carried byte-exact via its valid length."""
    vlens: dict[int, int] = {}
    size = 0
    for i, pg in enumerate(pages):
        if len(pg) > page_size:
            raise ValueError(
                f"page {i}: {len(pg)} bytes > page_size {page_size}")
        size += len(pg)
        if len(pg) != page_size:
            vlens[i] = len(pg)
    return ShardInfo(n_pages=len(pages), size=size, vlens=vlens)
