"""launch_us.encode: mean host microseconds of the `ec.launch` spans of
`ec.encode_batch` calls inside the traced window: the operator's
reshape, output allocation and the ctypes launch of its kernel, from the
program's span log placed on the profiler's timeline (portbench/spans.py).
It reads the traced stretch's pace, under the profiler (which adds to
each launch) with the spans recording, not the untraced window's."""
from portbench import spans

SOURCE = "program_span"


def read(r):
    if r.cell.op != "encode":
        return None
    s = spans.read(r)
    if s is None:
        return None
    return s.mean_us("ec.launch", under="ec.encode_batch")
