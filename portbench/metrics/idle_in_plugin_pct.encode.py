"""idle_in_plugin_pct.encode: percent of the traced window in which the
card ran no kernel, copy or fill (the union device_idle_pct.encode leaves
out) while the host was inside one of the program's `ec.*` root
spans, placed on the profiler's timeline by portbench/spans.py.
device_idle_pct.encode less this is the idle the harness or the
interpreter outside the program caused.  Both read the traced stretch,
where the program's spans record and add their cost to the host's."""
from portbench import spans

SOURCE = "device_trace"


def read(r):
    if r.cell.op != "encode":
        return None
    s = spans.read(r)
    return None if s is None else spans.idle_inside_pct(s, r.timeline)
