"""decode_MBps: MB (2^20 bytes, as qa/workunits/erasure-code/bench.sh
converts) of objects decoded per second: every call of the window over
the whole window's seconds, from the first submission to the moment the
host saw the last call complete."""
SOURCE = "host_clock"


def read(r):
    if r.cell.op != "decode":
        return None
    return r.window.calls * r.shape.call_bytes / 2**20 / r.window.seconds
