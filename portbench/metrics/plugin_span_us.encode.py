"""plugin_span_us.encode: mean host microseconds of the plugin's own
`ec.encode_batch` root spans inside the traced window, from entry to
return: the program's span log (ceph_tpu_torch.common.tracing) placed
on the profiler's timeline by portbench/spans.py.  Unlike
plugin_call_us.encode it holds none of the harness's Python, but it reads
the traced stretch's pace: under the profiler, which adds to each
launch, and with the spans recording, which add their own cost.  So it
is compared with its own readings in traced runs, not with
plugin_call_us.encode, which reads the untraced window."""
from portbench import spans

SOURCE = "program_span"


def read(r):
    if r.cell.op != "encode":
        return None
    s = spans.read(r)
    return None if s is None else s.mean_us("ec.encode_batch")
