"""compiled.idle_pct (%): the share of the traced window in which the card
was idle in gaps that began while a ``compiled.call`` span of the port
(the body of ``CompiledPipeline.run_fn``'s call) was open: the gaps
between the window's device activity and at its ends, each put down to
the call open when it began, as ``wideband.idle_pct`` does for the
flagship's entry.  ``device.idle`` less this is the idle time that began
in the benchmark's own code (the fetch) or under no host span.  Nothing
when the trace holds no ``compiled.call`` (a program without the
executor's spans) or no device activity (a run on the CPU)."""

import bisect


def _calls(trace):
    """The union of the ``compiled.call`` spans, as sorted intervals."""
    out = []
    for a, b in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in trace.host
                       if e.get("cat") == "user_annotation"
                       and e.get("name") == "compiled.call"):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read(run):
    tr = run.trace
    if tr is None or tr.t1 <= tr.t0 or not tr.device:
        return None
    calls = _calls(tr)
    if not calls:
        return None
    starts = [a for a, _ in calls]
    gaps, last = [], tr.t0
    for a, b in tr.busy:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    if last < tr.t1:
        gaps.append((last, tr.t1))
    idle = 0.0
    for a, b in gaps:
        k = bisect.bisect_right(starts, a) - 1
        if k >= 0 and calls[k][1] > a:
            idle += b - a
    return 100.0 * idle / (tr.t1 - tr.t0)
