"""Test/QA harnesses (the qa/ tier analogues): the port's MiniCluster,
OSDThrasher and ChaosRunner, and the fault plane they drive."""
from ..msg.faults import FaultPlane
from .chaos import ChaosRunner, InvariantViolation
from .cluster import MiniCluster
from .thrasher import OSDThrasher

__all__ = ["ChaosRunner", "FaultPlane", "InvariantViolation",
           "MiniCluster", "OSDThrasher"]
