"""decode_table_miss_pct: percent of the plugin's decode-table lookups
inside the traced window that missed the cache and built the operator:
the `ec.decode_table` spans whose argument is 1, from the program's span
log placed on the profiler's timeline (portbench/spans.py)."""
from portbench import spans

SOURCE = "program_counter"


def read(r):
    if r.cell.op != "decode":
        return None
    s = spans.read(r)
    return None if s is None else s.arg_pct("ec.decode_table", 1)
