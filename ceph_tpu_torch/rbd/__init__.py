"""RBD: block images striped over RADOS objects (ref: src/librbd/).
The port's copy of `ceph_tpu.rbd`."""
from .image import RBD, Image, RBDError

__all__ = ["RBD", "Image", "RBDError"]
