"""wideband.prep_ms (ms): host time a call of the flagship entry spends
in its per-call preamble, the port's span ``wideband.prep`` (the chirps,
the zero edges, the offset scalar, the two accumulators), summed over
the traced window and divided by the number of ``wideband.call`` spans.
Nothing when the trace holds no ``wideband.call`` (a program without the
port's spans)."""


def _spans(trace, name):
    return [e for e in trace.host
            if e.get("cat") == "user_annotation" and e.get("name") == name]


def read(run):
    if run.trace is None:
        return None
    calls = _spans(run.trace, "wideband.call")
    if not calls:
        return None
    prep = _spans(run.trace, "wideband.prep")
    return 1e-3 * sum(float(e["dur"]) for e in prep) / len(calls)
