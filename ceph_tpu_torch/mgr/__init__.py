"""Manager daemon: cluster optimization services over the mon
(ref: src/mgr/, src/pybind/mgr/balancer)."""
from .daemon import MgrDaemon

__all__ = ["MgrDaemon"]
