"""correlator.x_roofline (%): the correlator's X stage bound for the
traced units over the summed device time of the kernels launched inside
the port's span ``correlator.x`` (``CrossMultiply.task``: the two
baseline gathers and the products).

A kernel belongs to the span when the host operation that launched it,
which the profiler links to it by ``External id``, ran inside a
``correlator.x`` span on the same thread.  The bound is max(bytes / HBM
rate, operations / FP32 rate) at the H100's published peaks of the X
stage's share of the run's work, which
``benchmark/systems/lofar_hba_cobalt.py`` counts (``x_stage_work``: the
stacked spectra read once, the visibilities written once, 8 operations a
complex product) and carries under the name ``correlator.x``
(``Work.kernels``).  The sums' update after the span (the absorbed
Integrate's ``index_add_``) is not in it.  Nothing when the trace holds
no such span or kernel or the run's work does not count it."""

import bisect
from collections import defaultdict

from benchmark.peaks import work_bound_s

SPAN = "correlator.x"


def launched_inside(trace, name):
    """The device time (s) of the kernels whose launching host operation
    lies inside a span ``name`` on its thread, and the number of them."""
    spans = defaultdict(list)
    for e in trace.host:
        if e.get("cat") == "user_annotation" and e.get("name") == name:
            a = float(e["ts"])
            spans[e.get("tid")].append((a, a + float(e["dur"])))
    if not spans:
        return 0.0, 0
    for v in spans.values():
        v.sort()
    starts = {tid: [a for a, _ in v] for tid, v in spans.items()}
    ids = set()
    for e in trace.host:
        tid = e.get("tid")
        ext = (e.get("args") or {}).get("External id")
        if e.get("cat") != "cpu_op" or tid not in spans or ext is None:
            continue
        a = float(e["ts"])
        k = bisect.bisect_right(starts[tid], a) - 1
        if k >= 0 and a + float(e.get("dur", 0)) <= spans[tid][k][1]:
            ids.add(ext)
    found = [float(e["dur"]) for e in trace.kernels
             if (e.get("args") or {}).get("External id") in ids]
    return sum(found) * 1e-6, len(found)


def read(run):
    if run.trace is None:
        return None
    work = [getattr(w, "kernels", {}).get(SPAN) for w in run.work]
    if None in work:
        return None
    secs, _ = launched_inside(run.trace, SPAN)
    if secs <= 0:
        return None
    bound, _ = work_bound_s(*work)
    return 100.0 * bound / secs
