"""setup_s: host seconds from the start of the process to the start of
the window: imports, the kernels' build or load, the plugin, the working
set made on the device, and the warm-up of every shape and pattern."""
SOURCE = "host_clock"


def read(r):
    return r.setup_s
