"""Test/QA harnesses (the qa/ tier analogues): the port's MiniCluster."""
from .cluster import MiniCluster

__all__ = ["MiniCluster"]
