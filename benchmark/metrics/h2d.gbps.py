"""h2d.gbps (GB/s): bytes of the host-to-device copies in the traced
window over the device time of those copies (the profiler's memcpy
events); nothing when the window has none."""


def read(run):
    if run.trace is None:
        return None
    nbytes, secs = run.trace.host_to_device()
    if nbytes <= 0 or secs <= 0:
        return None
    return nbytes / secs / 1e9
