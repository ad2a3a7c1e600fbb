"""p95_ms: the 95th percentile, over every batch of the window, of the time
from handing the batch to the port until its answers are in host memory,
on the device's clock (a CUDA event recorded before the call and one after
the answers' copy to the host)."""

import numpy as np


def read(run):
    if not run.latencies_ms:
        return None
    return float(np.percentile(np.asarray(run.latencies_ms, dtype=np.float64), 95))
