"""Public API — the `cudaCallback` contract (reference core.h:71) on PyTorch
(counterpart of tpu_knn/api.py).

`knn_callback` dispatches like tpu_knn's: the best registered version in
production preference order (v7 in the port). `nearest_neighbors` is the
array-first wrapper. Torch tensors run on their own device; anything else
is placed on ``device`` (utils/platform.py).
"""

from __future__ import annotations

import numpy as np

from tpu_knn_torch.engine.registry import best_available_version, get_version
from tpu_knn_torch.utils.platform import as_f32_pair


def knn_callback(k: int, m: int, n: int, search, ref, version: str | None = None,
                 device="cuda") -> np.ndarray:
    """Exact 1-NN with the reference's contract: (m,k)/(n,k) float32
    inputs, (m,) int32 argmin indices out (on the host), squared-L2
    distance, lowest-index ties."""
    if m == 0:
        return np.empty((0,), np.int32)
    if n == 0:
        raise ValueError("reference set is empty (n=0): no nearest neighbor exists")
    v = get_version(version) if version is not None else best_available_version()
    search, ref = as_f32_pair(search, ref, device)
    return v(k, m, n, search, ref)


def nearest_neighbors(search, ref, version: str | None = None,
                      neighbors: int | None = None, device="cuda") -> np.ndarray:
    """Array-first wrapper: search (m,k), ref (n,k) -> (m,) int32 indices.

    neighbors=K returns (m, K) indices — including K=1 — each row
    ascending by exact (squared distance, index): v0's tie rule extended
    to K results (kernels/topk.py). `version` selects among the 1-NN
    engines and is incompatible with it."""
    search, ref = as_f32_pair(search, ref, device)
    m, k = search.shape
    n, k2 = ref.shape
    if k != k2:
        raise ValueError(f"dimension mismatch: search k={k}, ref k={k2}")
    if neighbors is not None:
        if version is not None:
            raise ValueError(
                "neighbors>1 uses the banded top-K pipeline; it cannot be "
                "combined with an explicit 1-NN version")
        from tpu_knn_torch.kernels.topk import PASSES_MAX_NEIGHBORS, topk_knn

        # Validate before the empty-batch early return, so the contract is
        # the same at every m.
        if not (1 <= neighbors <= min(n, PASSES_MAX_NEIGHBORS)):
            raise ValueError(
                f"neighbors must be in [1, min(n, "
                f"{PASSES_MAX_NEIGHBORS})] = "
                f"[1, {min(n, PASSES_MAX_NEIGHBORS)}], got {neighbors}")
        if m == 0:
            return np.empty((0, neighbors), np.int32)
        idx, _d2 = topk_knn(search, ref, neighbors)
        return idx.cpu().numpy().astype(np.int32)
    return knn_callback(k, m, n, search, ref, version=version, device=device)
