"""wideband.step_ms (ms): host time of one step of the flagship entry's
loop, the port's span ``wideband.step`` (the step's launches, the offset
carry, the accumulation), summed over the traced window and divided by
the number of ``wideband.step`` spans.  Nothing when the trace holds no
``wideband.call`` or no step (a program without the port's spans)."""


def _spans(trace, name):
    return [e for e in trace.host
            if e.get("cat") == "user_annotation" and e.get("name") == name]


def read(run):
    if run.trace is None or not _spans(run.trace, "wideband.call"):
        return None
    steps = _spans(run.trace, "wideband.step")
    if not steps:
        return None
    return 1e-3 * sum(float(e["dur"]) for e in steps) / len(steps)
