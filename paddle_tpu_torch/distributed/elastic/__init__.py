"""Elastic membership (the port of `paddle_tpu/distributed/elastic/`): a
file-backed pod registry with TTL leases and incarnation epochs, and the
manager over it. The serving fleet keeps its replicas' leases here."""
from .manager import ElasticManager
from .store import MembershipStore

__all__ = ["MembershipStore", "ElasticManager"]
