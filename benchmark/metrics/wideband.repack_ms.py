"""wideband.repack_ms (ms): host time a call of the flagship entry spends
repacking GUPPI words into K1p's planes, the port's span
``wideband.repack`` (the ``guppi_repack`` launch of each shard), summed
over the traced window and divided by the number of ``wideband.call``
spans.  Nothing when the trace holds no ``wideband.call`` or no
``wideband.repack`` (a program without the span, or plane-packed
input)."""


def _spans(trace, name):
    return [e for e in trace.host
            if e.get("cat") == "user_annotation" and e.get("name") == name]


def read(run):
    if run.trace is None:
        return None
    calls = _spans(run.trace, "wideband.call")
    repack = _spans(run.trace, "wideband.repack")
    if not calls or not repack:
        return None
    return 1e-3 * sum(float(e["dur"]) for e in repack) / len(calls)
