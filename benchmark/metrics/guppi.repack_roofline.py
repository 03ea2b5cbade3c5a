"""guppi.repack_roofline (%): the ``guppi_repack`` kernel's work bound for
the traced units over the summed device time of its launches.

The bound is bytes / HBM rate at the H100's published peak of the
kernel's share of the run's work, which
``benchmark/systems/guppi_b1937_stokes.py`` counts (``repack_work``: the
GUPPI words read once and both plane-packed planes written once; no
operations) and carries under the launch name ``guppi_repack``
(``Work.kernels``).  Nothing when the trace holds no such kernel or the
run's work does not count it."""

from benchmark.peaks import work_bound_s

KERNEL = "guppi_repack_kernel"


def read(run):
    if run.trace is None:
        return None
    work = [getattr(w, "kernels", {}).get("guppi_repack") for w in run.work]
    secs = sum(float(e["dur"]) for e in run.trace.kernels
               if KERNEL in e.get("name", "")) * 1e-6
    if None in work or secs <= 0:
        return None
    bound, _ = work_bound_s(*work)
    return 100.0 * bound / secs
