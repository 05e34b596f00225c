"""Client access layer: Objecter (target calc + resend engine) and the
librados-like Rados/IoCtx API (ref: src/osdc/Objecter.cc,
src/librados/).  The port's copy of `ceph_tpu.client`."""
from .objecter import Objecter, OpFuture
from .rados import IoCtx, Rados, RadosError, WriteOp

__all__ = ["Objecter", "OpFuture", "Rados", "IoCtx", "RadosError",
           "WriteOp"]
