"""Monitor: the cluster's map authority (ref: src/mon/).

The port's copy of `ceph_tpu.mon` as far as one EC cluster needs it: a
versioned store (MonitorStore), the Paxos commit pipeline
(Paxos/PaxosService), the OSDMonitor command engine (pool/EC-profile/osd
state/upmap commands), the crash table (CrashService), the PG-stat digest
(PGMap), the rank-based Elector, and the Monitor daemon, alone or in a
quorum, speaking MMonCommand/MMonSubscribe/MOSDBoot/MOSDFailure/
MOSDPGTemp/MPGStats and the quorum's election, lease, forward and sync
messages over the messenger.
"""
from .store import MonitorStore, StoreTransaction
from .paxos import Paxos, PaxosService
from .osd_monitor import OSDMonitor
from .monitor import Monitor, build_initial

__all__ = ["MonitorStore", "StoreTransaction", "Paxos", "PaxosService",
           "OSDMonitor", "Monitor", "build_initial"]
