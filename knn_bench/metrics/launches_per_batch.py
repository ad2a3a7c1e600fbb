"""launches_per_batch: kernels run on the device in the traced slice (one a
launch), over its batches."""


def read(run):
    if run.trace is None:
        return None
    return run.trace["kernels"] / run.trace["batches"]
