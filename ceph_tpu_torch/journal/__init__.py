"""Journal library: an append-only replicated log over RADOS objects.

The src/journal/ analogue (ref: Journaler/JournalMetadata/
ObjectRecorder — the generic journal librbd journaling and rbd-mirror
are built on): a journal is a header object carrying the registered
clients and their commit positions, plus a chain of numbered data
objects holding crc-framed entries.

* `append(tag, data)` frames an entry (crc32c + typed-codec payload)
  onto the active data object, rolling to the next object at
  `object_size` (ref: ObjectRecorder append + overflow);
* readers `replay(handler, from_pos)` from any position — a torn tail
  (crash mid-append) fails its crc and cleanly ends the stream
  (ref: JournalPlayer fetch/replay);
* every consumer registers a client and advances its commit position
  (header omap, ref: JournalMetadata::committed);
* `trim()` removes whole data objects all clients have passed
  (ref: JournalTrimmer).

The port's copy of `ceph_tpu.journal`: the same header omap, frames and
data objects, byte for byte.  One rule differs: where the reference
swallows a `RadosError` (an idempotent create, a best-effort removal),
the port does the same and also counts each such error whose errno is
not ENOENT or EEXIST in `SWALLOWED`, by site.
"""
from __future__ import annotations

import struct
from collections import Counter
from typing import Callable

from ..client import RadosError
from ..common.crc32c import crc32c
from ..msg import encoding as wire

_FRAME = struct.Struct("!II")        # length, crc32c

#: swallowed RadosErrors other than ENOENT/EEXIST, by site
SWALLOWED: Counter = Counter()


def _swallow(site: str, err: RadosError) -> None:
    if err.errno_name not in ("ENOENT", "EEXIST"):
        SWALLOWED[site] += 1


def header_obj(journal_id: str) -> str:
    return f"journal.{journal_id}"


def data_obj(journal_id: str, objno: int) -> str:
    return f"journal_data.{journal_id}.{objno:08x}"


class JournalError(Exception):
    pass


class Journaler:
    """One client's handle on a journal (ref: src/journal/Journaler.h)."""

    def __init__(self, ioctx, journal_id: str, client_id: str,
                 object_size: int = 1 << 22):
        self.io = ioctx
        self.jid = journal_id
        self.client_id = client_id
        self.object_size = object_size
        self._hdr = header_obj(journal_id)

    # -- lifecycle ------------------------------------------------------
    def create(self) -> None:
        """Create the journal (idempotent)."""
        try:
            self.io.create(self._hdr)
            self.io.set_omap(self._hdr, {
                "active": b"0", "first": b"0"})
        except RadosError as err:
            _swallow("create", err)

    def exists(self) -> bool:
        try:
            self.io.stat(self._hdr)
            return True
        except RadosError as err:
            _swallow("exists", err)
            return False

    def remove(self) -> None:
        first, active = self._range()
        for objno in range(first, active + 1):
            try:
                self.io.remove(data_obj(self.jid, objno))
            except RadosError as err:
                _swallow("remove", err)
        try:
            self.io.remove(self._hdr)
        except RadosError as err:
            _swallow("remove", err)

    # -- clients (ref: JournalMetadata register/unregister_client) ------
    def register_client(self) -> None:
        key = f"client.{self.client_id}"
        vals = self.io.get_omap_vals_by_keys(self._hdr, [key])
        if key not in vals:
            self.io.set_omap(self._hdr, {
                key: wire.encode({"pos": (0, 0)})})

    def unregister_client(self) -> None:
        try:
            self.io.remove_omap_keys(self._hdr,
                                     [f"client.{self.client_id}"])
        except RadosError as err:
            _swallow("unregister_client", err)

    def clients(self) -> dict[str, dict]:
        vals, _ = self.io.get_omap_vals(self._hdr)
        return {k[len("client."):]: wire.decode(v)
                for k, v in vals.items() if k.startswith("client.")}

    # -- positions ------------------------------------------------------
    def _range(self) -> tuple[int, int]:
        vals, _ = self.io.get_omap_vals(self._hdr)
        if "active" not in vals:
            raise JournalError(f"no journal {self.jid!r}")
        return int(vals.get("first", b"0")), int(vals["active"])

    def commit_position(self) -> tuple[int, int]:
        key = f"client.{self.client_id}"
        vals = self.io.get_omap_vals_by_keys(self._hdr, [key])
        if key not in vals:
            raise JournalError(f"client {self.client_id!r} not "
                               "registered")
        return tuple(wire.decode(vals[key])["pos"])

    def commit(self, pos: tuple[int, int]) -> None:
        """Advance this client's committed position."""
        self.io.set_omap(self._hdr, {
            f"client.{self.client_id}": wire.encode({"pos": tuple(pos)})})

    # -- append (ref: ObjectRecorder) -----------------------------------
    def append(self, tag: str, data) -> tuple[int, int]:
        """Frame + append one entry; returns the position AFTER it."""
        _first, active = self._range()
        body = wire.encode({"tag": tag, "data": data})
        frame = _FRAME.pack(len(body), crc32c(0, body)) + body
        try:
            size = self.io.stat(data_obj(self.jid, active))["size"]
        except RadosError as err:
            _swallow("append", err)
            size = 0
        if size >= self.object_size:
            active += 1
            self.io.set_omap(self._hdr,
                             {"active": str(active).encode()})
            size = 0
        self.io.append(data_obj(self.jid, active), frame)
        return (active, size + len(frame))

    # -- replay (ref: JournalPlayer) ------------------------------------
    def replay(self, handler: Callable[[str, object], None],
               from_pos: tuple[int, int] | None = None
               ) -> tuple[int, int]:
        """Feed entries after `from_pos` (default: this client's commit
        position) to `handler(tag, data)`; returns the new position.
        A torn tail ends the stream cleanly."""
        pos = tuple(from_pos) if from_pos is not None \
            else self.commit_position()
        first, active = self._range()
        objno, off = pos
        if objno < first:
            # the position's object was trimmed away: resume at the
            # start of the first surviving object — carrying the old
            # byte offset into a different object would land mid-frame
            # and read as a permanently torn tail
            objno, off = first, 0
        while objno <= active:
            try:
                raw = self.io.read(data_obj(self.jid, objno))
            except RadosError as err:
                _swallow("replay", err)
                raw = b""
            while off + _FRAME.size <= len(raw):
                n, crc = _FRAME.unpack_from(raw, off)
                body = raw[off + _FRAME.size: off + _FRAME.size + n]
                if len(body) < n or crc32c(0, body) != crc:
                    return (objno, off)     # torn tail
                ent = wire.decode(body)
                handler(ent["tag"], ent["data"])
                off += _FRAME.size + n
            if objno == active:
                break
            objno += 1
            off = 0
        return (objno, off)

    # -- trim (ref: JournalTrimmer) -------------------------------------
    def trim(self) -> int:
        """Remove whole data objects every client has committed past;
        returns how many were removed."""
        first, active = self._range()
        clients = self.clients()
        if not clients:
            return 0
        min_obj = min(c["pos"][0] for c in clients.values())
        removed = 0
        for objno in range(first, min(min_obj, active)):
            try:
                self.io.remove(data_obj(self.jid, objno))
            except RadosError as err:
                _swallow("trim", err)
            removed += 1
        if removed:
            self.io.set_omap(self._hdr, {
                "first": str(first + removed).encode()})
        return removed
