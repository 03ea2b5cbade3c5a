"""k3_stokes.roofline (%): K3 Stokes' work bound for the traced units over
the summed device time of its launches (the kernels named
``k3_fold_kernel<true, float, ...>``, the float32 full-Stokes fold).

The bound is max(bytes / HBM rate, operations / FP32 rate) at the H100's
published peaks of the kernel's share of the run's work, which
``benchmark/systems/guppi_b1937_stokes.py`` counts (``k3_stokes_work``:
both planes read once, plus the partner column a tile reads, the profile
written once; the inverse FFTs over N1 rows and the Stokes products) and
carries under the launch name ``k3_fold_stokes`` (``Work.kernels``).
Nothing when the trace holds no such kernel or the run's work does not
count it."""

from benchmark.peaks import work_bound_s

KERNEL = "k3_fold_kernel<true, float"


def read(run):
    if run.trace is None:
        return None
    work = [getattr(w, "kernels", {}).get("k3_fold_stokes")
            for w in run.work]
    secs = sum(float(e["dur"]) for e in run.trace.kernels
               if KERNEL in e.get("name", "")) * 1e-6
    if None in work or secs <= 0:
        return None
    bound, _ = work_bound_s(*work)
    return 100.0 * bound / secs
