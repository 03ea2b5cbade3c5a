"""mesh.shard_ms (ms): host time a call of the flagship entry spends
splitting its input over the mesh and moving it to the card, the port's
span ``mesh.shard`` (a synchronous ``.to(device)`` of each block), summed
over the ``mesh.shard`` spans that lie inside a ``wideband.call`` span on
the same thread and divided by the number of ``wideband.call`` spans.
Nothing when the trace holds no ``wideband.call`` (a program without the
port's spans)."""


def _spans(trace, name):
    """(thread, start, end) of every span ``name``, in trace us."""
    return [(e.get("tid"), float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in trace.host
            if e.get("cat") == "user_annotation" and e.get("name") == name]


def read(run):
    if run.trace is None:
        return None
    calls = _spans(run.trace, "wideband.call")
    if not calls:
        return None
    total = sum(b - a for tid, a, b in _spans(run.trace, "mesh.shard")
                if any(t == tid and s <= a and b <= e for t, s, e in calls))
    return 1e-3 * total / len(calls)
