"""Sharded datalog: the durable change feed behind multisite sync.

The reference keeps a data log of bucket-index mutations that remote
zones tail to find what changed (ref: src/rgw/rgw_datalog.cc sharded
omap logs; cls_rgw's bilog for the per-bucket variant).  Here the two
collapse into one: every bucket-index shard object carries its own log
under reserved omap keys (`.dl.<seq>` + `.dlmeta`), appended by the
cls_rgw methods **in the same OSD transaction as the index write** —
so an index mutation and its replication record commit atomically (a
separate log object could lose one side of the pair on a crash).

This module is the client half: cursor-based reads (`list` returns
entries after a marker plus the shard head, one exec), head probes for
lag accounting, and trim.  The OSD half lives in `ceph_tpu_torch/cls/rgw.py`
(`_dl_append`, `dl_list`, `dl_trim`).

The port's copy of `ceph_tpu.rgw.datalog`.
"""
from __future__ import annotations

import hashlib

from ..client import RadosError
from ..cls.rgw import DL_META, DL_PREFIX, dl_key, is_dl_key  # noqa: F401
# re-exported: gateway listings filter is_dl_key; tests poke dl_key


def shard_obj(bucket: str, shard: int = 0) -> str:
    """Index shard object name — the one place the layout is spelled
    (gateway and datalog must agree or sync reads the wrong log)."""
    return f".rgw.index.{bucket}.{shard}"


def shard_of_key(key: str, nshards: int) -> int:
    """Stable key -> shard placement (ref: rgw_shard_id — hash mod).
    Lives here with the layout: the sync agent must place a peer's
    key with the PEER's shard count, not the local one."""
    if nshards <= 1:
        return 0
    h = hashlib.md5(key.encode()).digest()
    return int.from_bytes(h[:4], "big") % nshards


class DataLog:
    """Cursor reads + trim over a bucket's per-shard datalogs."""

    def __init__(self, io):
        self.io = io

    def list(self, bucket: str, shard: int, marker: int = 0,
             max_entries: int = 64) -> tuple[list[dict], int]:
        """Entries with seq > marker (at most max_entries) and the
        shard's head sequence.  A missing shard object reads as an
        empty log (bucket created elsewhere, nothing written yet)."""
        try:
            out = self.io.exec(shard_obj(bucket, shard), "rgw",
                               "dl_list", {"marker": marker,
                                           "max": max_entries}) or {}
        except RadosError as e:
            if e.errno_name != "ENOENT":
                raise       # a shard READ failure (EIO injection,
                # peering trouble) must not masquerade as an empty,
                # caught-up log — head 0 zeroes the very lag gauge
                # that exists to expose it
            return [], 0
        return out.get("entries", []), out.get("head", 0)

    def head(self, bucket: str, shard: int) -> int:
        _, head = self.list(bucket, shard, marker=0, max_entries=0)
        return head

    def heads(self, bucket: str, nshards: int) -> dict[int, int]:
        return {s: self.head(bucket, s) for s in range(nshards)}

    def trim(self, bucket: str, shard: int, upto: int) -> int:
        """Drop entries with seq <= upto; returns how many went.  The
        caller owns the safety argument (every peer's marker has
        passed `upto`) — the reference's datalog trim is likewise an
        admin/trimmer decision, not the log's."""
        out = self.io.exec(shard_obj(bucket, shard), "rgw", "dl_trim",
                           {"upto": upto}) or {}
        return out.get("trimmed", 0)
