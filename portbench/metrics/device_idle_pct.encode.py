"""device_idle_pct.encode: percent of the traced window in which the
card ran no kernel, no copy and no fill, from the profiler's timeline."""
SOURCE = "device_trace"


def read(r):
    if r.cell.op != "encode" or r.timeline is None:
        return None
    return 100.0 * (1.0 - r.timeline.busy_s() / r.timeline.window_s)
