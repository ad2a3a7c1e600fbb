"""host_syncs_per_batch: CUDA runtime calls in which the host waits for the
device (knn_bench.trace.SYNC_CALLS) in the traced slice, over its batches;
the benchmark's own wait for each batch's answers is one of them."""


def read(run):
    if run.trace is None:
        return None
    return run.trace["syncs"] / run.trace["batches"]
