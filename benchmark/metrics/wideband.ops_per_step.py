"""wideband.ops_per_step (ops): device operations (kernels, copies,
fills) that start inside the traced window, over the number of the
port's ``wideband.step`` spans in it: the launches a step of the
flagship entry costs, with the per-call and per-unit ones spread over
its steps.  Nothing when the trace holds no ``wideband.call`` or no step
(a program without the port's spans)."""


def _count(trace, name):
    return sum(1 for e in trace.host
               if e.get("cat") == "user_annotation" and e.get("name") == name)


def read(run):
    tr = run.trace
    if tr is None or not _count(tr, "wideband.call"):
        return None
    steps = _count(tr, "wideband.step")
    if not steps:
        return None
    ops = sum(1 for e in tr.device if tr.t0 <= float(e["ts"]) < tr.t1)
    return ops / steps
