"""device.idle (%): the share of the traced window in which the card ran
no kernel, copy or fill (``benchmark/trace.py``)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
