"""Test/QA harnesses (the qa/ tier analogues): the port's MiniCluster,
OSDThrasher and ChaosRunner."""
from .chaos import ChaosRunner, InvariantViolation
from .cluster import MiniCluster
from .thrasher import OSDThrasher

__all__ = ["ChaosRunner", "InvariantViolation", "MiniCluster",
           "OSDThrasher"]
