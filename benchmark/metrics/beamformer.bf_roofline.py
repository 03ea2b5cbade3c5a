"""beamformer.bf_roofline (%): the beamformer's TAB products and detection
bound for the traced units over the summed device time of the kernels
launched inside the port's span ``beamformer.bf``
(``BeamformStations.task``: the spectra laid out for the product, the
batched complex matrix product, the Stokes I detection).

A kernel belongs to the span when the host operation that launched it,
which the profiler links to it by ``External id``, ran inside a
``beamformer.bf`` span on the same thread (``correlator.x_roofline``'s
``launched_inside``).  The bound is max(bytes / HBM rate, operations /
FP32 rate) at the H100's published peaks of the span's share of the
run's work, which ``benchmark/systems/lofar_lotaas_tabs.py`` counts
(``bf_work``: the stacked spectra read once, the Stokes I sums written
once, 8 operations a TAB a complex sample, 4 a beam sample detected) and
carries under the name ``beamformer.bf`` (``Work.kernels``).  The sums'
update after the span (the absorbed Integrate's ``index_add_``) is not
in it.  Nothing when the trace holds no such span or kernel or the run's
work does not count it."""

from benchmark.harness import module
from benchmark.peaks import work_bound_s

SPAN = "beamformer.bf"


def read(run):
    if run.trace is None:
        return None
    work = [getattr(w, "kernels", {}).get(SPAN) for w in run.work]
    if None in work:
        return None
    secs, _ = module("metrics", "correlator.x_roofline").launched_inside(
        run.trace, SPAN)
    if secs <= 0:
        return None
    bound, _ = work_bound_s(*work)
    return 100.0 * bound / secs
