"""v0 — the serial-semantics oracle (tpu_knn/oracle.py's NumPy path, cache-blocked).

The port carries its own copy so that it runs without tpu_knn installed;
tests/test_torch_harness.py holds it against tpu_knn's on the same inputs.
It reimplements the reference's ground-truth version (core.cu:25-63) with
bit-identical float32 semantics, vectorized in NumPy:

- squared-L2 distance accumulated in float32, one k term at a time, in k
  order (matching the C loop's rounding exactly; NumPy's pairwise `sum`
  would not),
- running minimum over n with a strict `>` update, i.e. ties resolve to the
  lowest reference index (core.cu:50-54),
- no sqrt (compared as squared sums).

The work is cut into blocks of ROW_BLOCK query rows by ``chunk`` reference
points, small enough to stay in the host's caches, so large reference sets
never materialize an m*n matrix; every (row, point) distance is the same
float32 chain as unblocked, and the chunk fold keeps the lowest-index tie
rule because `np.argmin` returns the first minimum and the cross-chunk
update is a strict `<` on a stream of increasing indices.
"""

from __future__ import annotations

import numpy as np

#: Query rows per block (with the default chunk, 1 MB of distances).
ROW_BLOCK = 32


def oracle_knn(search: np.ndarray, ref: np.ndarray, chunk: int = 1 << 13,
               return_distances: bool = False):
    """Exact 1-NN argmin indices with v0 semantics: (m,) int32, and the
    (m,) float32 squared distances of the winners if ``return_distances``.
    ``chunk`` is the n-axis chunk size (memory only; result-invariant)."""
    search = np.ascontiguousarray(search, dtype=np.float32)
    ref = np.ascontiguousarray(ref, dtype=np.float32)
    m, k = search.shape
    n = ref.shape[0]

    best_d = np.full((m,), np.inf, dtype=np.float32)
    best_i = np.zeros((m,), dtype=np.int32)
    acc = np.empty((min(m, ROW_BLOCK), min(n, chunk)), dtype=np.float32)
    diff = np.empty_like(acc)
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        ref_t = np.ascontiguousarray(ref[start:stop].T)          # (k, c)
        for r0 in range(0, m, ROW_BLOCK):
            rows = search[r0:r0 + ROW_BLOCK]
            d, t = acc[:rows.shape[0], :stop - start], diff[:rows.shape[0], :stop - start]
            # Accumulated in k order like the reference's inner loop
            # (core.cu:44-49).
            d.fill(0)
            for kk in range(k):
                np.subtract(rows[:, kk, None], ref_t[kk], out=t)
                np.multiply(t, t, out=t)
                d += t
            local_i = np.argmin(d, axis=1)  # first minimum => lowest index
            local_d = d[np.arange(rows.shape[0]), local_i]
            held = best_d[r0:r0 + ROW_BLOCK]
            take = local_d < held  # strict: earlier chunk wins ties
            best_i[r0:r0 + ROW_BLOCK] = np.where(take, local_i + start, best_i[r0:r0 + ROW_BLOCK])
            best_d[r0:r0 + ROW_BLOCK] = np.where(take, local_d, held)

    if return_distances:
        return best_i, best_d
    return best_i


def oracle_callback(k: int, m: int, n: int, search: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """The uniform version-callback signature (reference core.h:30-69)."""
    assert search.shape == (m, k) and ref.shape == (n, k)
    return oracle_knn(search, ref)
