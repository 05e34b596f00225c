"""librados-like synchronous API over the Objecter.

The user-facing client surface (ref: src/librados/librados_cxx.cc /
src/include/rados/librados.hpp: Rados::connect, ioctx_create,
IoCtx::write/write_full/read/remove/stat): a Rados handle owns the
Objecter + mon session; IoCtx binds a pool and exposes synchronous
object IO; every call is an Objecter op under the hood, so target
recalc/resend on map changes is inherited.

The port's copy of `ceph_tpu.client.rados` in part: `Rados.connect`,
`pool_create`, `pool_lookup`, `list_pools`, `mon_command`, `open_ioctx`
and `shutdown` (cephx through `auth_secret`); `IoCtx.write`,
`write_full`, `read`, `remove`, `stat`
and `append`, and the `aio_` forms of those the reference has.  Left
out: snapshots (pool and self-managed), xattrs, omap, object classes
(`exec`), watch/notify, `WriteOp` compound operations, object listing
and `pg_scrub`.
"""
from __future__ import annotations

import time

from ..msg.messenger import LocalNetwork
from .objecter import Objecter, OpFuture

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


class IoCtx:
    """Pool IO context (ref: librados::IoCtx)."""

    def __init__(self, rados: Rados, pool_id: int):
        self.rados = rados
        self.pool_id = pool_id

    # -- async ---------------------------------------------------------
    def aio_write(self, oid: str, data: bytes, offset: int = 0
                  ) -> OpFuture:
        return self.rados.objecter.submit(self.pool_id, oid, "write",
                                          offset=offset, data=data)

    def aio_write_full(self, oid: str, data: bytes) -> OpFuture:
        return self.rados.objecter.submit(self.pool_id, oid,
                                          "write_full", data=data)

    def aio_read(self, oid: str, length: int = 0, offset: int = 0,
                 unordered: bool = False) -> OpFuture:
        """`unordered=True` skips per-object op ordering so N reads of
        one object parallelize — only for objects immutable while the
        reads are in flight."""
        return self.rados.objecter.submit(self.pool_id, oid, "read",
                                          offset=offset, length=length,
                                          unordered=unordered)

    def aio_remove(self, oid: str) -> OpFuture:
        return self.rados.objecter.submit(self.pool_id, oid, "delete")

    def aio_append(self, oid: str, data: bytes) -> OpFuture:
        return self.rados.objecter.submit(self.pool_id, oid, "append",
                                          data=data)

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

    def read(self, oid: str, length: int = 0, offset: int = 0) -> bytes:
        return self._wait(self.aio_read(oid, length, offset)).data

    def remove(self, oid: str) -> None:
        self._wait(self.aio_remove(oid))

    def stat(self, oid: str) -> dict:
        fut = self.rados.objecter.submit(self.pool_id, oid, "stat")
        return self._wait(fut).attrs

    def append(self, oid: str, data: bytes) -> None:
        self._wait(self.aio_append(oid, data))
