"""rbd-mirror: journal-based image replication with failover.

The rbd-mirror model (ref: src/tools/rbd_mirror/ ImageReplayer +
librbd journaling, src/librbd/journal/): a journaled image appends
every mutation to its journal BEFORE applying it (write-ahead, so a
replica replaying the journal converges to the primary's state); a
mirror process registers as a journal client, replays new events onto
the secondary image, commits its position, and trims.

Failover (ref: librbd mirror promote/demote + ImageReplayer's
split-brain handling):

* every image carries a mirror state `{"primary": bool, "epochs":
  [promotion ids]}`; a demoted image refuses local writes;
* **demote/promote** hand primacy over cleanly: promotion appends a
  fresh epoch id, so the promotion CHAIN records the handoff history;
* **force promotion** (primary died) also appends an epoch — when the
  old primary returns, `sync()` compares chains and journal
  positions: a dst that was primary with journal events nobody
  replayed has diverged — **split-brain** — and raises
  `SplitBrainError` until `resync()` rebuilds it from the current
  primary, re-registering at the live journal position.

The port's copy of `ceph_tpu.rbd.mirror`: the same mirror state, journal
replay and refusals.  Promotion epochs stay `uuid.uuid4()` ids.  Where
the reference swallows a `RadosError` in `resync`, the port also counts
it in `ceph_tpu_torch.rbd.image.SWALLOWED` unless its errno is ENOENT.
"""
from __future__ import annotations

import json
import uuid

from ..journal import Journaler, data_obj
from ..client.rados import RadosError
from .image import RBD, Image, RBDError, _swallow, data_name, header_name


def journal_id(image_name: str) -> str:
    return f"rbd.{image_name}"


def _head_pos(j: Journaler) -> tuple[int, int]:
    """The journal's live (object, offset) head — what a fully-caught-
    up client's commit position equals."""
    _first, active = j._range()
    try:
        size = j.io.stat(data_obj(j.jid, active))["size"]
    except RadosError as ex:
        if ex.errno_name != "ENOENT":
            raise       # an EIO here must NOT read as "caught up"
        size = 0        # head object not written yet: genuinely empty
    return (active, size)


class SplitBrainError(RBDError):
    def __init__(self, msg: str):
        super().__init__(11, f"split-brain: {msg} (resync required)")


# -- mirror image state (ref: librbd::api::Mirror) ----------------------

def _load_meta(ioctx, name: str) -> dict:
    try:
        raw = ioctx.read(header_name(name))
    except RadosError as ex:
        if ex.errno_name != "ENOENT":
            raise       # EIO keeps its errno — only a true miss maps
        raise RBDError(2, f"image {name!r} does not exist") from ex
    try:
        return json.loads(raw.decode())
    except ValueError as ex:
        # a corrupt header is NOT "does not exist": callers that
        # recreate on ENOENT would overwrite a live (damaged) image
        raise RBDError(5, f"image {name!r}: undecodable metadata "
                          f"header") from ex


def _store_meta(ioctx, name: str, meta: dict) -> None:
    ioctx.write_full(header_name(name), json.dumps(meta).encode())


def mirror_state(ioctx, name: str) -> dict | None:
    return _load_meta(ioctx, name).get("mirror")


def mirror_enable(ioctx, name: str) -> None:
    """Mark the image mirrored + primary (journaling required)."""
    meta = _load_meta(ioctx, name)
    if not meta.get("journaling"):
        raise RBDError(22, f"image {name!r} has no journal "
                           "(enable journaling)")
    meta.setdefault("mirror", {"primary": True,
                               "epochs": [uuid.uuid4().hex]})
    _store_meta(ioctx, name, meta)


def demote(ioctx, name: str) -> None:
    """Primary -> non-primary: local writes refuse from here on
    (ref: librbd mirror_image_demote)."""
    meta = _load_meta(ioctx, name)
    m = meta.setdefault("mirror", {"primary": True, "epochs": []})
    m["primary"] = False
    _store_meta(ioctx, name, meta)


def promote(ioctx, name: str, force: bool = False) -> str:
    """Non-primary -> primary with a fresh promotion epoch.  A clean
    promotion requires the local journal fully replayed (every
    registered client caught up); `force` skips that — the disaster
    path whose divergence sync() later detects
    (ref: librbd mirror_image_promote)."""
    meta = _load_meta(ioctx, name)
    m = meta.setdefault("mirror", {"primary": False, "epochs": []})
    if m.get("primary"):
        return m["epochs"][-1] if m["epochs"] else ""
    if not force:
        # clean promotion requires an orderly handoff, provable one of
        # two ways (ref: the demotion-tag ownership check in librbd's
        # promote):
        #  * we are a sync TARGET that replayed from a demoted source
        #    (`src_demoted` recorded by the draining sync); or
        #  * we are the just-demoted image itself (failover abort) and
        #    our OWN journal is fully consumed by every registered
        #    client — nothing of ours can be lost.
        # Residual limit of the single-cluster view: if the remote
        # side was force-promoted AFTER our last sync, this flag is
        # stale — the next sync's split-brain gate catches the
        # divergence, but dual primaries exist until then.
        ok = bool(m.get("src_demoted"))
        if not ok:
            j = Journaler(ioctx, journal_id(name), "promote-check")
            if j.exists():
                clients = j.clients()
                head = _head_pos(j)
                ok = bool(clients) and all(
                    tuple(c.get("pos") or (0, 0)) >= head
                    for c in clients.values())
        if not ok:
            raise RBDError(16, "source not demoted/drained — demote "
                               "the primary and sync first (or force)")
    epoch = uuid.uuid4().hex
    m["primary"] = True
    m.pop("src_demoted", None)
    m.setdefault("epochs", []).append(epoch)
    if force:
        m["force_promoted"] = True
    # a fresh primary journals its own mutations
    if not meta.get("journaling"):
        meta["journaling"] = True
        Journaler(ioctx, journal_id(name), "master").create()
    _store_meta(ioctx, name, meta)
    return epoch


class ImageMirror:
    """Replays one journaled image onto a secondary pool/cluster
    (ref: rbd_mirror ImageReplayer)."""

    def __init__(self, src_ioctx, dst_ioctx, image_name: str,
                 client_id: str = "mirror"):
        self.src = src_ioctx
        self.dst = dst_ioctx
        self.name = image_name
        self.journaler = Journaler(src_ioctx, journal_id(image_name),
                                   client_id)

    def _ensure_dst(self, src_img: Image) -> Image:
        try:
            return Image(self.dst, self.name)
        except RBDError:
            RBD().create(self.dst, self.name, size=src_img.size,
                         order=src_img.order)
            return Image(self.dst, self.name)

    def _check_split_brain(self, src_img: Image, dst: Image) -> None:
        """Divergence gate (ref: ImageReplayer's tag-chain compare):
        the secondary's promotion chain must be a prefix of the
        primary's, AND a secondary that used to be primary must not
        hold journal events nobody ever replayed — those writes exist
        on no other cluster."""
        src_m = src_img.mirror or {}
        dst_m = dst.mirror or {}
        se, de = src_m.get("epochs", []), dst_m.get("epochs", [])
        if de and se[:len(de)] != de:
            raise SplitBrainError(
                f"promotion chains diverged ({de[-1][:8]} vs "
                f"{se[-1][:8] if se else '-'})")
        if len(de) < len(se) and dst.journaling:
            # the dst was primary at epoch de[-1]; if its own journal
            # holds events no client consumed, they were never
            # replicated anywhere — force promotion left them behind
            j = Journaler(self.dst, journal_id(self.name), "sb-check")
            if j.exists():
                head = _head_pos(j)
                consumed = max(
                    (tuple(c.get("pos") or (0, 0))
                     for c in j.clients().values()), default=(0, 0))
                if head > consumed:
                    raise SplitBrainError(
                        "unreplicated events on the demoted image "
                        f"(head {head} > consumed {consumed})")

    def sync(self) -> int:
        """Replay new journal events onto the secondary; returns the
        number of events applied.  Raises SplitBrainError when the
        secondary's history diverged from the primary's."""
        src_img = Image(self.src, self.name)
        try:
            if not src_img.journaling:
                raise RBDError(22, f"image {self.name!r} has no "
                                   "journal (enable journaling)")
            dst = self._ensure_dst(src_img)
            try:
                return self._sync_into(src_img, dst)
            finally:
                # error paths (split-brain, replay failure) must not
                # leak the dst's watch/lock state
                dst.close()
        finally:
            src_img.close()

    def _sync_into(self, src_img: Image, dst: Image) -> int:
        self._check_split_brain(src_img, dst)
        dst._replaying = True          # bypass the non-primary gate
        self.journaler.register_client()
        applied = 0

        def handler(tag, ev):
            nonlocal applied
            applied += 1
            try:
                if tag == "write":
                    dst.write(ev["off"], bytes(ev["data"]))
                elif tag == "discard":
                    dst.discard(ev["off"], ev["len"])
                elif tag == "resize":
                    dst.resize(ev["size"])
                elif tag == "snap_create":
                    dst.snap_create(ev["name"])
                elif tag == "snap_remove":
                    dst.snap_remove(ev["name"])
                elif tag == "snap_rollback":
                    dst.snap_rollback(ev["name"])
                elif tag == "snap_protect":
                    dst.snap_protect(ev["name"])
                elif tag == "snap_unprotect":
                    dst.snap_unprotect(ev["name"])
            except RBDError as ex:
                # replay idempotency: a crash between replay and
                # commit re-delivers entries — EEXIST/ENOENT on
                # snap verbs means the effect already applied
                # (ref: rbd-mirror replay tolerates the same)
                if ex.errno not in (2, 17):
                    raise

        pos = self.journaler.replay(handler)
        dst.flush()
        self.journaler.commit(pos)
        self.journaler.trim()
        # adopt the primary's promotion chain: the secondary's state
        # records every handoff it has replicated through.  A sync
        # that drained a DEMOTED source marks the orderly-handoff
        # gate clean promotion checks.
        if src_img.mirror is not None:
            dmeta = _load_meta(self.dst, self.name)
            dmeta["mirror"] = {
                "primary": False,
                "epochs": list(src_img.mirror.get("epochs", [])),
                "src_demoted":
                    not src_img.mirror.get("primary", True)}
            _store_meta(self.dst, self.name, dmeta)
        return applied

    def resync(self) -> int:
        """Split-brain recovery (ref: rbd mirror image resync +
        ImageReplayer bootstrap): discard the secondary wholesale,
        full-copy the primary's current data, adopt its promotion
        chain as non-primary, and re-register at the LIVE journal
        position so subsequent syncs replay only post-resync events.
        Data-only: the primary's snapshots are not re-created.
        Returns bytes copied."""
        src_img = Image(self.src, self.name)
        try:
            # capture the journal position BEFORE copying: events
            # appended during the copy must replay afterwards (at
            # worst redundantly), never be skipped
            self.journaler.register_client()
            resume_pos = _head_pos(self.journaler)
            # destroy the local copy (its divergent history included)
            try:
                old = Image(self.dst, self.name)
            except RBDError:
                old = None              # nothing local: plain bootstrap
            if old is not None:
                if old.mirror is not None and \
                        old.mirror.get("primary", False):
                    old.close()
                    # the reference's resync refuses on a primary the
                    # same way: inverted direction would wholesale
                    # destroy the image holding the acked writes
                    raise RBDError(
                        16, "refusing to resync a PRIMARY image — "
                            "reverse the mirror direction")
                span = old._object_span()
                snap_ids = [s["id"] for s in old.snaps.values()]
                old.close()
                for objno in range(span):
                    try:
                        self.dst.remove(data_name(self.name, objno))
                    except RadosError as err:
                        # best-effort: object may not exist
                        _swallow("resync", err)
                j = Journaler(self.dst, journal_id(self.name), "rs")
                if j.exists():
                    j.remove()
                # stale object maps would mark objects the rebuilt
                # image does not have (phantom du/fast-diff extents)
                from .image import object_map_name
                for om in ([object_map_name(self.name)] +
                           [object_map_name(self.name, s)
                            for s in snap_ids]):
                    try:
                        self.dst.remove(om)
                    except RadosError as err:
                        # best-effort: map may not exist
                        _swallow("resync", err)
                try:
                    self.dst.remove(header_name(self.name))
                except RadosError as err:
                    # best-effort: header may not exist
                    _swallow("resync", err)
            RBD().create(self.dst, self.name, size=src_img.size,
                         order=src_img.order)
            dst = Image(self.dst, self.name)
            dst._replaying = True
            copied = 0
            step = 1 << src_img.order
            off = 0
            while off < src_img.size:
                n = min(step, src_img.size - off)
                buf = src_img.read(off, n)
                if any(buf):
                    dst.write(off, buf)
                    copied += n
                off += n
            dst.flush()
            dst.close()
            dmeta = _load_meta(self.dst, self.name)
            dmeta["mirror"] = {
                "primary": False,
                "epochs": list((src_img.mirror or {})
                               .get("epochs", []))}
            _store_meta(self.dst, self.name, dmeta)
            # resume FROM the pre-copy journal position: events that
            # landed mid-copy replay on the next sync
            self.journaler.commit(resume_pos)
            return copied
        finally:
            src_img.close()
