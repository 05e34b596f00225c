"""plugin_call_us.decode: mean host microseconds spent inside each call
into the plugin's decode entry in the window, from entry to return: what
the host pays to enqueue one call (the kernel runs after it returns)."""
SOURCE = "host_clock"


def read(r):
    if r.cell.op != "decode" or not r.window.calls:
        return None
    return r.window.enqueue_s / r.window.calls * 1e6
