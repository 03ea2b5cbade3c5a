"""wideband.enqueue_ms (ms): host time per pipeline step spent inside the
flagship entry's call (``run_fn``'s ``run``) before it returns, from the
benchmark's span ``wideband.run`` around each call (weighted by its
steps) over the window's untraced units."""


def read(run):
    rec = run.spans.get("wideband.run")
    if not rec:
        return None
    return 1e3 * sum(s for s, _ in rec) / sum(w for _, w in rec)
