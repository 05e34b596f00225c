"""RadosStriper: striped large-object API over an IoCtx.

The libradosstriper analogue (ref: src/libradosstriper/
RadosStriperImpl.cc): one logical "striped object" is spread over
RADOS objects `<soid>.%016x`; the striper's layout and the logical
size live as xattrs on the first object (ref: RadosStriperImpl's
XATTR_LAYOUT_STRIPE_UNIT/..._COUNT/XATTR_SIZE on object 0), so any
client can open it without external metadata.

The port's copy of `ceph_tpu.osdc.rados_striper`.  One rule differs:
where the reference reads a failed metadata read as ENOENT, or drops a
failed object removal, the port does the same and also counts every
such error whose errno is not ENOENT or ENODATA in `swallowed`.
"""
from __future__ import annotations

import json

from ..client import RadosError
from .striper import StripeLayout, Striper

SIZE_XATTR = "striper.size"
LAYOUT_XATTR = "striper.layout"


def _obj(soid: str, objectno: int) -> str:
    return f"{soid}.{objectno:016x}"


class RadosStriper:
    """(ref: libradosstriper::RadosStriper)."""

    def __init__(self, ioctx,
                 layout: StripeLayout | None = None):
        self.io = ioctx
        self.default_layout = layout or StripeLayout(
            stripe_unit=1 << 16, stripe_count=4, object_size=1 << 18)
        self.default_layout.validate()
        #: errors other than ENOENT/ENODATA read as absent or dropped
        self.swallowed = 0

    def _swallow(self, err: RadosError) -> None:
        if err.errno_name not in ("ENOENT", "ENODATA"):
            self.swallowed += 1

    # -- metadata on object 0 (ref: RadosStriperImpl xattrs) -----------
    def _meta(self, soid: str) -> tuple[StripeLayout, int]:
        try:
            lay = json.loads(self.io.get_xattr(_obj(soid, 0),
                                               LAYOUT_XATTR))
            size = int(self.io.get_xattr(_obj(soid, 0), SIZE_XATTR))
        except RadosError as err:
            self._swallow(err)
            raise RadosError("ENOENT", f"striped object {soid}")
        return StripeLayout(**lay), size

    def _write_meta(self, soid: str, layout: StripeLayout,
                    size: int) -> None:
        first = _obj(soid, 0)
        try:
            self.io.stat(first)
        except RadosError:
            self.io.create(first)
        self.io.set_xattr(first, LAYOUT_XATTR, json.dumps(
            layout.__dict__).encode())
        self.io.set_xattr(first, SIZE_XATTR, str(size).encode())

    # -- io -------------------------------------------------------------
    def write(self, soid: str, data: bytes, offset: int = 0) -> None:
        try:
            layout, size = self._meta(soid)
        except RadosError:
            layout, size = self.default_layout, 0
        futs = []
        for ext in Striper.file_to_extents(layout, offset, len(data)):
            buf = data[ext.logical_offset - offset:
                       ext.logical_offset - offset + ext.length]
            futs.append(self.io.aio_write(_obj(soid, ext.objectno),
                                          buf, offset=ext.offset))
        for f in futs:
            self.io._wait(f)
        self._write_meta(soid, layout,
                         max(size, offset + len(data)))

    def write_full(self, soid: str, data: bytes) -> None:
        try:
            self.remove(soid)
        except RadosError:
            pass
        self.write(soid, data, 0)

    def read(self, soid: str, length: int = 0,
             offset: int = 0) -> bytes:
        layout, size = self._meta(soid)
        if length == 0 or offset + length > size:
            length = max(0, size - offset)
        if length == 0:
            return b""
        out = bytearray(length)
        pend = []
        for ext in Striper.file_to_extents(layout, offset, length):
            pend.append((ext, self.io.aio_read(
                _obj(soid, ext.objectno), length=ext.length,
                offset=ext.offset)))
        for ext, fut in pend:
            try:
                buf = self.io._wait(fut).data
            except RadosError as ex:
                if ex.errno_name != "ENOENT":
                    raise
                buf = b""
            dst = ext.logical_offset - offset
            out[dst:dst + len(buf)] = buf
        return bytes(out)

    def stat(self, soid: str) -> dict:
        layout, size = self._meta(soid)
        return {"size": size, "stripe_unit": layout.stripe_unit,
                "stripe_count": layout.stripe_count,
                "object_size": layout.object_size}

    def remove(self, soid: str) -> None:
        layout, size = self._meta(soid)
        objnos = {0}
        if size:
            objnos |= {e.objectno for e in
                       Striper.file_to_extents(layout, 0, size)}
        for n in sorted(objnos, reverse=True):   # object 0 last: meta
            try:
                self.io.remove(_obj(soid, n))
            except RadosError as err:
                self._swallow(err)
