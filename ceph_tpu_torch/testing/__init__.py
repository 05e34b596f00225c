"""Test/QA harnesses (the qa/ tier analogues): the port's MiniCluster
and OSDThrasher."""
from .cluster import MiniCluster
from .thrasher import OSDThrasher

__all__ = ["MiniCluster", "OSDThrasher"]
