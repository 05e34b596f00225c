"""librados-like synchronous API over the Objecter.

The user-facing client surface (ref: src/librados/librados_cxx.cc /
src/include/rados/librados.hpp: Rados::connect, ioctx_create,
IoCtx::write/write_full/read/remove/stat): a Rados handle owns the
Objecter + mon session; IoCtx binds a pool and exposes synchronous
object IO; every call is an Objecter op under the hood, so target
recalc/resend on map changes is inherited.

The port's copy of `ceph_tpu.client.rados`: `Rados.connect`,
`pool_create`, `pool_lookup`, `list_pools`, `mon_command`, `open_ioctx`,
`pg_scrub` and `shutdown` (cephx through `auth_secret`); `IoCtx.write`,
`write_full`, `read` (at a pool snapshot with `snapid=`), `remove`,
`stat`, `append`, `truncate`, `zero`, `create`, `operate` with `WriteOp`
compound operations, the xattr verbs (`set_xattr`, `get_xattr`,
`rm_xattr`, `get_xattrs`), the omap verbs (replicated pools),
`list_objects`, pool and self-managed snapshots (`snap_create` ...
`list_snaps`, the write snap context of `set_write_snapc`), watch/notify
(`watch`, `unwatch`, `notify`), object-class calls (`exec`), and the
`aio_` forms of those the reference has.
"""
from __future__ import annotations

import itertools
import time

from ..msg.messenger import LocalNetwork
from .objecter import Objecter, OpFuture

#: watch-cookie mint (process-wide: cookies must be unique per client
#: name even when several IoCtx instances race)
_cookie_seq = itertools.count(1)

ERRNO = {"EIO": 5, "ENOENT": 2, "EINVAL": 22, "ESTALE": 116}


class RadosError(OSError):
    def __init__(self, errno_name: str, msg: str = ""):
        super().__init__(ERRNO.get(errno_name, 5),
                         f"{errno_name}: {msg}" if msg else errno_name)
        self.errno_name = errno_name


class Rados:
    """Cluster handle (ref: librados::Rados)."""

    def __init__(self, network: LocalNetwork, name: str | None = None,
                 mon="mon.0", op_timeout: float = 30.0,
                 threaded: bool = True, auth_secret: str | None = None):
        self.objecter = Objecter(network, name=name, mon=mon,
                                 threaded=threaded,
                                 auth_secret=auth_secret)
        self.op_timeout = op_timeout
        self._connected = False

    def connect(self, timeout: float = 30.0) -> "Rados":
        self.objecter.start()
        self.objecter.wait_for_map(1, timeout)
        self._connected = True
        return self

    def shutdown(self) -> None:
        self.objecter.shutdown()
        self._connected = False

    # -- pools ---------------------------------------------------------
    def pool_lookup(self, name: str) -> int:
        for pid, n in self.objecter.osdmap.pool_names.items():
            if n == name:
                return pid
        raise RadosError("ENOENT", f"pool {name!r}")

    def list_pools(self) -> list[str]:
        m = self.objecter.osdmap
        return [m.pool_names[p] for p in sorted(m.pools)]

    def pool_create(self, name: str, pg_num: int = 32,
                    pool_type: str = "replicated",
                    erasure_code_profile: str = "") -> None:
        cmd = {"prefix": "osd pool create", "pool": name,
               "pg_num": pg_num, "pool_type": pool_type}
        if erasure_code_profile:
            cmd["erasure_code_profile"] = erasure_code_profile
        r, outs, _ = self.objecter.mon_command(cmd)
        if r != 0:
            raise RadosError("EINVAL", outs)
        # wait until our map shows the pool (the mon pushes the inc to
        # subscribers; it may land before or after the command ack)
        end = time.monotonic() + self.op_timeout
        while time.monotonic() < end:
            if any(n == name
                   for n in self.objecter.osdmap.pool_names.values()):
                return
            try:
                self.objecter.wait_for_map(
                    self.objecter.osdmap.epoch + 1,
                    min(0.5, end - time.monotonic()))
            except TimeoutError:
                pass
        raise RadosError("EIO", f"pool {name!r} never appeared in map")

    def mon_command(self, cmd: dict) -> tuple[int, str, object]:
        return self.objecter.mon_command(cmd, self.op_timeout)

    def open_ioctx(self, pool_name: str) -> "IoCtx":
        return IoCtx(self, self.pool_lookup(pool_name))

    def pg_scrub(self, pool_id: int, ps: int,
                 repair: bool = False) -> dict:
        """Deep-scrub one PG at its primary; returns
        {inconsistent, repaired, unrepairable} (and `verified` after a
        repair) (ref: `ceph pg deep-scrub` / `ceph pg repair`)."""
        fut = self.objecter.submit(
            pool_id, "", "scrub-repair" if repair else "scrub",
            pg_ps=ps)
        if not self.objecter.wait_sync(fut.done, self.op_timeout,
                                       ev=fut._ev):
            raise TimeoutError("scrub timed out")
        if fut.result < 0:
            raise RadosError(fut.errno_name or "EIO")
        return fut.attrs


class IoCtx:
    """Pool IO context (ref: librados::IoCtx)."""

    def __init__(self, rados: Rados, pool_id: int):
        self.rados = rados
        self.pool_id = pool_id
        #: self-managed write SnapContext (ref: rados_ioctx_
        #: selfmanaged_snap_set_write_ctx): when set, it rides with
        #: every mutation from this IoCtx instead of the pool's
        self.write_snapc: dict | None = None

    def set_write_snapc(self, seq: int, snaps) -> None:
        """(ref: selfmanaged_snap_set_write_ctx)."""
        self.write_snapc = {"seq": int(seq),
                            "snaps": sorted(int(s) for s in snaps)}

    def _margs(self, extra: dict | None = None) -> dict | None:
        """args for a mutating op: inject the self-managed snapc."""
        if self.write_snapc is None:
            return extra
        out = dict(extra or {})
        out["snapc"] = self.write_snapc
        return out

    # -- async ---------------------------------------------------------
    def aio_write(self, oid: str, data: bytes, offset: int = 0
                  ) -> OpFuture:
        return self.rados.objecter.submit(self.pool_id, oid, "write",
                                          offset=offset, data=data,
                                          args=self._margs())

    def aio_write_full(self, oid: str, data: bytes) -> OpFuture:
        return self.rados.objecter.submit(self.pool_id, oid,
                                          "write_full", data=data,
                                          args=self._margs())

    def aio_read(self, oid: str, length: int = 0, offset: int = 0,
                 snapid: int | None = None,
                 unordered: bool = False) -> OpFuture:
        """`unordered=True` skips per-object op ordering so N reads of
        one object parallelize — only for objects immutable while the
        reads are in flight (serve artifact pages)."""
        args = {"snapid": snapid} if snapid is not None else None
        return self.rados.objecter.submit(self.pool_id, oid, "read",
                                          offset=offset, length=length,
                                          args=args,
                                          unordered=unordered)

    def aio_remove(self, oid: str) -> OpFuture:
        return self.rados.objecter.submit(self.pool_id, oid, "delete",
                                          args=self._margs())

    def aio_append(self, oid: str, data: bytes) -> OpFuture:
        return self.rados.objecter.submit(self.pool_id, oid, "append",
                                          data=data, args=self._margs())

    def aio_operate(self, oid: str, op: "WriteOp") -> OpFuture:
        """Atomic compound mutation (ref: librados
        ObjectWriteOperation / IoCtx::operate)."""
        return self.rados.objecter.submit(
            self.pool_id, oid, "writev",
            args=self._margs({"ops": list(op.ops)}))

    # -- sync ----------------------------------------------------------
    def _wait(self, fut: OpFuture) -> OpFuture:
        ob = self.rados.objecter
        if not ob.wait_sync(fut.done, self.rados.op_timeout,
                            ev=fut._ev):
            raise TimeoutError("op timed out")
        if fut.result < 0:
            raise RadosError(fut.errno_name or "EIO")
        return fut

    def write(self, oid: str, data: bytes, offset: int = 0) -> None:
        self._wait(self.aio_write(oid, data, offset))

    def write_full(self, oid: str, data: bytes) -> None:
        self._wait(self.aio_write_full(oid, data))

    def read(self, oid: str, length: int = 0, offset: int = 0,
             snapid: int | None = None) -> bytes:
        """snapid reads the object's state at that pool snapshot
        (ref: IoCtx::snap_set_read + read)."""
        return self._wait(self.aio_read(oid, length, offset,
                                        snapid)).data

    def remove(self, oid: str) -> None:
        self._wait(self.aio_remove(oid))

    def stat(self, oid: str) -> dict:
        fut = self.rados.objecter.submit(self.pool_id, oid, "stat")
        return self._wait(fut).attrs

    def _sync(self, op: str, oid: str, **kw) -> OpFuture:
        # snapc is injected unconditionally: mutating ops need it for
        # COW and the OSD ignores it on reads — an allowlist here
        # would silently drop it for any op added later
        if self.write_snapc is not None:
            kw["args"] = self._margs(kw.get("args"))
        return self._wait(self.rados.objecter.submit(
            self.pool_id, oid, op, **kw))

    def append(self, oid: str, data: bytes) -> None:
        self._wait(self.aio_append(oid, data))

    def truncate(self, oid: str, size: int) -> None:
        self._sync("truncate", oid, args={"size": size})

    def zero(self, oid: str, offset: int, length: int) -> None:
        """Zero a byte range without changing the object size
        (ref: CEPH_OSD_OP_ZERO)."""
        self._sync("zero", oid, offset=offset, length=length)

    def create(self, oid: str, exclusive: bool = False) -> None:
        self._sync("create", oid, args={"exclusive": exclusive})

    def operate(self, oid: str, op: "WriteOp") -> None:
        self._wait(self.aio_operate(oid, op))

    # -- pool snapshots (ref: librados IoCtx::snap_* family) -----------
    _MON_ERRNO = {-2: "ENOENT", -17: "EEXIST", -22: "EINVAL",
                  -95: "EOPNOTSUPP"}

    def snap_create(self, name: str) -> None:
        """(ref: rados_ioctx_snap_create -> osd pool mksnap)."""
        pool = self._pool_name()
        rc, outs, _ = self.rados.mon_command(
            {"prefix": "osd pool mksnap", "pool": pool, "snap": name})
        if rc < 0:
            raise RadosError(self._MON_ERRNO.get(rc, "EINVAL"), outs)
        # wait for the map carrying the snap (snap_lookup + the COW
        # context both come from it)
        if not self.rados.objecter.wait_sync(
                lambda: name in self.list_pool_snaps().values(),
                self.rados.op_timeout):
            raise TimeoutError(f"snap {name} never appeared in map")

    def snap_remove(self, name: str) -> None:
        pool = self._pool_name()
        rc, outs, _ = self.rados.mon_command(
            {"prefix": "osd pool rmsnap", "pool": pool, "snap": name})
        if rc < 0:
            raise RadosError(self._MON_ERRNO.get(rc, "EINVAL"), outs)
        if not self.rados.objecter.wait_sync(
                lambda: name not in self.list_pool_snaps().values(),
                self.rados.op_timeout):
            raise TimeoutError(f"snap {name} never left the map")

    def snap_lookup(self, name: str) -> int:
        """snap name -> snapid from the client's map
        (ref: rados_ioctx_snap_lookup)."""
        pool = self.rados.objecter.osdmap.pools.get(self.pool_id)
        for sid, n in (pool.snaps if pool else {}).items():
            if n == name:
                return sid
        raise RadosError("ENOENT", f"snap {name}")

    def list_pool_snaps(self) -> dict[int, str]:
        pool = self.rados.objecter.osdmap.pools.get(self.pool_id)
        return dict(pool.snaps) if pool else {}

    def snap_rollback(self, oid: str, snap_name: str) -> None:
        """(ref: rados_ioctx_snap_rollback)."""
        self._sync("rollback", oid,
                   args={"snapid": self.snap_lookup(snap_name)})

    def selfmanaged_snap_create(self) -> int:
        """Allocate a client-managed snapid (ref:
        rados_ioctx_selfmanaged_snap_create); the caller maintains the
        write snapc via set_write_snapc."""
        rc, outs, sid = self.rados.mon_command(
            {"prefix": "osd pool selfmanaged-snap create",
             "pool": self._pool_name()})
        if rc < 0:
            raise RadosError(self._MON_ERRNO.get(rc, "EINVAL"), outs)
        return int(sid)

    def selfmanaged_snap_remove(self, snapid: int) -> None:
        rc, outs, _ = self.rados.mon_command(
            {"prefix": "osd pool selfmanaged-snap rm",
             "pool": self._pool_name(), "snapid": int(snapid)})
        if rc < 0:
            raise RadosError(self._MON_ERRNO.get(rc, "EINVAL"), outs)

    def rollback_to_snapid(self, oid: str, snapid: int) -> None:
        """Self-managed rollback by raw snapid."""
        self._sync("rollback", oid, args={"snapid": int(snapid)})

    def list_snaps(self, oid: str) -> dict:
        """Per-object snapshot state: clone tags -> covered snapids
        (ref: rados_ioctx_snap_list / listsnaps)."""
        return self._sync("list_snaps", oid).attrs

    def _pool_name(self) -> str:
        m = self.rados.objecter.osdmap
        name = m.pool_names.get(self.pool_id)
        if name is None:
            raise RadosError("ENOENT", f"pool {self.pool_id}")
        return name

    # -- watch/notify (ref: librados IoCtx::watch2/notify2/unwatch2) ---
    def watch(self, oid: str, callback, cookie: str | None = None
              ) -> str:
        """Register `callback(notify_id, notifier, payload) -> reply`
        on the object; returns the watch cookie.  The watch survives
        primary moves (client-side linger re-registration)."""
        cookie = cookie or \
            f"{self.rados.objecter.name}.w{next(_cookie_seq)}"
        fut = self.rados.objecter.watch_register(
            self.pool_id, oid, cookie, callback)
        try:
            self._wait(fut)
        except Exception:
            self.rados.objecter.watches.pop(cookie, None)
            raise
        return cookie

    def unwatch(self, oid: str, cookie: str) -> None:
        self._wait(self.rados.objecter.watch_unregister(
            self.pool_id, oid, cookie))

    def notify(self, oid: str, payload=None, timeout: float = 10.0
               ) -> tuple[dict, list]:
        """Fan a notification out to every watcher; returns
        (replies, timed_out) keyed "client/cookie"."""
        fut = self.rados.objecter.submit(
            self.pool_id, oid, "notify",
            args={"payload": payload, "timeout": timeout})
        ob = self.rados.objecter
        if not ob.wait_sync(fut.done,
                            max(self.rados.op_timeout, timeout + 5.0),
                            ev=fut._ev):
            raise TimeoutError("notify timed out")
        if fut.result < 0:
            raise RadosError(fut.errno_name or "EIO")
        return fut.attrs["replies"], fut.attrs["timeouts"]

    def exec(self, oid: str, cls: str, method: str, indata=None):
        """Invoke an object-class method on the object's primary OSD
        (ref: librados IoCtx::exec / CEPH_OSD_OP_CALL)."""
        return self._sync("exec", oid,
                          args={"cls": cls, "method": method,
                                "indata": indata}).attrs.get("out")

    def aio_exec(self, oid: str, cls: str, method: str,
                 indata=None) -> OpFuture:
        return self.rados.objecter.submit(
            self.pool_id, oid, "exec",
            args={"cls": cls, "method": method, "indata": indata})

    # -- xattrs (ref: librados::IoCtx::{get,set,rm}xattr) --------------
    def set_xattr(self, oid: str, name: str, value: bytes) -> None:
        self._sync("setxattr", oid,
                   args={"name": name, "value": bytes(value)})

    def get_xattr(self, oid: str, name: str) -> bytes:
        return self._sync("getxattr", oid,
                          args={"name": name}).attrs["value"]

    def rm_xattr(self, oid: str, name: str) -> None:
        self._sync("rmxattr", oid, args={"name": name})

    def get_xattrs(self, oid: str) -> dict[str, bytes]:
        return self._sync("getxattrs", oid).attrs["xattrs"]

    # -- omap (replicated pools; ref: librados omap op surface) --------
    def set_omap(self, oid: str, kv: dict[str, bytes]) -> None:
        self._sync("omap_setkeys", oid, args={"kv": dict(kv)})

    def remove_omap_keys(self, oid: str, keys: list[str]) -> None:
        self._sync("omap_rmkeys", oid, args={"keys": list(keys)})

    def clear_omap(self, oid: str) -> None:
        self._sync("omap_clear", oid)

    def set_omap_header(self, oid: str, data: bytes) -> None:
        self._sync("omap_set_header", oid, args={"data": bytes(data)})

    def get_omap_header(self, oid: str) -> bytes:
        return self._sync("omap_get_header", oid).attrs["header"]

    def get_omap_vals(self, oid: str, after: str = "",
                      max_return: int = 1 << 30
                      ) -> tuple[dict[str, bytes], bool]:
        """Returns ({key: value}, more) with pagination like
        rados_omap_get_vals2."""
        a = self._sync("omap_get_vals", oid,
                       args={"after": after,
                             "max": max_return}).attrs
        return a["vals"], a["more"]

    def get_omap_keys(self, oid: str, after: str = "",
                      max_return: int = 1 << 30
                      ) -> tuple[list[str], bool]:
        a = self._sync("omap_get_keys", oid,
                       args={"after": after,
                             "max": max_return}).attrs
        return a["keys"], a["more"]

    def get_omap_vals_by_keys(self, oid: str,
                              keys: list[str]) -> dict[str, bytes]:
        return self._sync("omap_get_vals_by_keys", oid,
                          args={"keys": list(keys)}).attrs["vals"]

    def list_objects(self) -> list[str]:
        """Pool object listing: one pgls per PG
        (ref: librados NObjectIterator -> Objecter pg_read)."""
        pool = self.rados.objecter.osdmap.pools.get(self.pool_id)
        if pool is None:
            raise RadosError("ENOENT", f"pool {self.pool_id} gone")
        futs = [self.rados.objecter.submit(self.pool_id, "", "pgls",
                                           pg_ps=ps)
                for ps in range(pool.pg_num)]
        names: set[str] = set()
        for fut in futs:
            names.update(self._wait(fut).attrs.get("objects", []))
        return sorted(names)


class WriteOp:
    """A batched atomic mutation (ref: librados
    ObjectWriteOperation): every queued mutation applies in one
    transaction on the primary — all replicas/shards see all of it or
    none of it."""

    def __init__(self):
        self.ops: list[tuple] = []

    def write(self, data: bytes, offset: int = 0) -> "WriteOp":
        self.ops.append(("write", offset, bytes(data)))
        return self

    def write_full(self, data: bytes) -> "WriteOp":
        self.ops.append(("writefull", bytes(data)))
        return self

    def append(self, data: bytes) -> "WriteOp":
        self.ops.append(("append", bytes(data)))
        return self

    def truncate(self, size: int) -> "WriteOp":
        self.ops.append(("truncate", int(size)))
        return self

    def zero(self, offset: int, length: int) -> "WriteOp":
        self.ops.append(("zero", int(offset), int(length)))
        return self

    def create(self) -> "WriteOp":
        self.ops.append(("create",))
        return self

    def set_xattr(self, name: str, value: bytes) -> "WriteOp":
        self.ops.append(("setxattrs", {name: bytes(value)}))
        return self

    def rm_xattr(self, name: str) -> "WriteOp":
        self.ops.append(("rmxattr", name))
        return self

    def set_omap(self, kv: dict) -> "WriteOp":
        self.ops.append(("omap_setkeys", dict(kv)))
        return self

    def remove_omap_keys(self, keys) -> "WriteOp":
        self.ops.append(("omap_rmkeys", list(keys)))
        return self

    def clear_omap(self) -> "WriteOp":
        self.ops.append(("omap_clear",))
        return self

    def set_omap_header(self, data: bytes) -> "WriteOp":
        self.ops.append(("omap_setheader", bytes(data)))
        return self
