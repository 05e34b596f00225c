"""encode_roofline: the least time the card could take for the traced
calls' work (portbench/work.py: rows needed read once, rows made written
once, over peaks.json) as a percent of the time every kernel in the
traced window ran, whichever kernels those are."""
from portbench.work import bound_s

SOURCE = "device_trace"


def read(r):
    if r.cell.op != "encode" or r.timeline is None:
        return None
    kernel_s = r.timeline.busy_s(("kernel",))
    bound, _ = bound_s(r.work_per_call * r.traced.calls, r.kind)
    return 100.0 * bound / kernel_s
