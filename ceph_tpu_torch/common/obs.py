"""Shared daemon observability surface: the op-tracker + tracer admin
commands every daemon type serves.

The reference registers dump_ops_in_flight / dump_historic_ops /
dump_historic_slow_ops / dump_blocked_ops on each daemon's admin
socket from the shared OpTracker (ref: TrackedOp.cc
OpTracker::register_commands style hookup in OSD.cc / MDSDaemon.cc /
rgw_main.cc); `dump_traces` serves the daemon's blkin span ring.  One
helper, so mon/mgr/mds/rgw get an identical surface to the OSD's.

The port's copy of `ceph_tpu.common.obs`, whole.
"""
from __future__ import annotations

from .admin_socket import AdminSocket
from .tracing import Tracer
from .tracked_op import OpTracker


def register_obs_commands(asok: AdminSocket, tracker: OpTracker,
                          tracer: Tracer) -> None:
    asok.register("dump_ops_in_flight", "ops currently executing",
                  lambda c: (0, tracker.dump_in_flight()))
    asok.register("dump_historic_ops", "recently completed ops",
                  lambda c: (0, tracker.dump_historic()))
    asok.register("dump_historic_slow_ops",
                  "recently completed ops over the complaint age",
                  lambda c: (0, tracker.dump_historic_slow()))
    asok.register("dump_blocked_ops", "ops over the complaint age",
                  lambda c: (0, tracker.slow_ops()))
    asok.register("dump_traces", "finished blkin spans "
                  "(optionally trace_id=...)",
                  lambda c: (0, tracer.dump(c.get("trace_id"))))
