"""compiled.block_ms (ms): host time of one block of the compiled
executor's loop, the port's span ``compiled.block`` (a block's step and
its reduction update in ``CompiledPipeline.run_fn``), summed over the
traced window and divided by the number of ``compiled.block`` spans.
Nothing when the trace holds no ``compiled.call`` or no block (a program
without the executor's spans), or no device activity (a run on the CPU,
where a block's span times its computation, not its launches)."""


def _spans(trace, name):
    return [e for e in trace.host
            if e.get("cat") == "user_annotation" and e.get("name") == name]


def read(run):
    if run.trace is None or not run.trace.device \
            or not _spans(run.trace, "compiled.call"):
        return None
    blocks = _spans(run.trace, "compiled.block")
    if not blocks:
        return None
    return 1e-3 * sum(float(e["dur"]) for e in blocks) / len(blocks)
