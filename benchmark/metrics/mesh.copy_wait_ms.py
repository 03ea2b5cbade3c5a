"""mesh.copy_wait_ms (ms): host time a call of the flagship entry spends
waiting for its own copies from pinned host memory to the card, the
port's span ``mesh.copy_wait`` (at the end of the call, after its steps
are queued), summed over the ``mesh.copy_wait`` spans that lie inside a
``wideband.call`` span on the same thread and divided by the number of
``wideband.call`` spans.  Nothing when the trace holds no
``wideband.call`` or no ``mesh.copy_wait`` (a program without the span,
or inputs already on the card)."""


def _spans(trace, name):
    """(thread, start, end) of every span ``name``, in trace us."""
    return [(e.get("tid"), float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in trace.host
            if e.get("cat") == "user_annotation" and e.get("name") == name]


def read(run):
    if run.trace is None:
        return None
    calls = _spans(run.trace, "wideband.call")
    waits = _spans(run.trace, "mesh.copy_wait")
    if not calls or not waits:
        return None
    total = sum(b - a for tid, a, b in waits
                if any(t == tid and s <= a and b <= e for t, s, e in calls))
    return 1e-3 * total / len(calls)
