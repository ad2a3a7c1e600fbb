"""device_idle_pct: the share of the traced slice in which nothing ran on
the device (no kernel, copy or memset)."""


def read(run):
    if run.trace is None or run.trace["span_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["span_s"])
