"""kernels_roofline (%): the configuration's work bound for the traced
units over the summed device time of every kernel in them.

The bound is max(bytes / HBM rate, operations / FP32 rate) at the H100's
published peaks (``benchmark/peaks.py``), from the work the system's
work function counts for the configuration's shapes; whatever
implements the work, it reads the same work.  Nothing when the trace
holds no kernel."""

from benchmark.peaks import work_bound_s


def read(run):
    if run.trace is None or run.trace.kernel_s <= 0:
        return None
    bound, _ = work_bound_s(*run.work)
    return 100.0 * bound / run.trace.kernel_s
