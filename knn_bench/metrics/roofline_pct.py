"""roofline_pct: the traced batches' least time (knn_bench.roofline: the
function's operations and bytes against the card's peaks, whatever tier
ran) over the device's busy time in the traced slice."""


def read(run):
    if run.trace is None or run.least_s is None or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * run.trace["batches"] * run.least_s / run.trace["busy_s"]
