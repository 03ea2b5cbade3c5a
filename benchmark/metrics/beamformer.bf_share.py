"""beamformer.bf_share (%): the summed device time of the kernels launched
inside the port's span ``beamformer.bf`` (the TAB products and their
detection, as ``beamformer.bf_roofline`` finds them) over the summed
device time of every kernel of the traced units.  Nothing when the trace
holds no such span or kernel."""

from benchmark.harness import module

SPAN = "beamformer.bf"


def read(run):
    if run.trace is None or run.trace.kernel_s <= 0:
        return None
    secs, _ = module("metrics", "correlator.x_roofline").launched_inside(
        run.trace, SPAN)
    if secs <= 0:
        return None
    return 100.0 * secs / run.trace.kernel_s
