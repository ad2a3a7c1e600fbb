"""Public API — the `cudaCallback` contract (reference core.h:71) on PyTorch
(counterpart of tpu_knn/api.py).

`knn_callback` dispatches like tpu_knn's: the best registered version in
production preference order (v8, which hands one card to v7), or the
``version`` named (v0–v11; engine/registry.py). `nearest_neighbors` is the
array-first wrapper. Torch tensors run on their own device; anything else
is placed on ``device`` (utils/platform.py).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_knn_torch.engine.registry import best_available_version, get_version
from tpu_knn_torch.utils.platform import as_f32, as_f32_pair


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


def _graph_compact(idx, d2, neighbors: int):
    """K+1 -> K self-compaction for knn_graph: drop one slot per row, the
    row's own index or, where it is absent, the trailing runner-up:
    out[j] = in[j] for j < drop, else in[j + 1] (an elementwise select
    between two slices; no sort)."""
    n = idx.shape[0]
    pos = torch.arange(neighbors + 1, dtype=torch.int32, device=idx.device)[None]
    own = torch.arange(n, dtype=idx.dtype, device=idx.device)[:, None]
    drop = torch.where(idx == own, pos, neighbors).min(dim=1, keepdim=True).values
    keep = pos[:, :neighbors] < drop
    return (torch.where(keep, idx[:, :neighbors], idx[:, 1:]),
            torch.where(keep, d2[:, :neighbors], d2[:, 1:]))


def knn_graph(points, neighbors: int, *, mesh=None, device="cuda"):
    """Exact K-nearest-neighbor graph of a point set: for each point, the
    K nearest other points (the manifold-learning / UMAP-style input).

    Self-exclusion is by index, not by distance: duplicate points remain
    each other's neighbors. The set is queried against itself for K+1
    results through the exact top-K engines (the batch regime routes to
    the seeded engine), then each row drops its own index, or the
    trailing runner-up where K+1 exact duplicates precede it.

    Returns (idx (n, K) int32, d2 (n, K) f32) tensors, rows ascending by
    exact (d2, index). A tensor stays on its device; anything else is
    placed on ``device``.

    mesh: a distributed.mesh.Mesh runs the self-join sharded
    (distributed/sharded.py): the point rows split over "dp" as queries
    while the same set shards over the reference axes, global rebase and
    top-K merge; the rows come back on the mesh's first device (a NumPy
    set goes there first) and are compacted there.
    """
    from tpu_knn_torch.kernels.topk import PASSES_MAX_NEIGHBORS, topk_knn

    if mesh is not None and not isinstance(points, torch.Tensor):
        device = mesh.home
    points = as_f32(points, device)
    n = points.shape[0]
    if not (1 <= neighbors <= min(n - 1, PASSES_MAX_NEIGHBORS - 1)):
        raise ValueError(
            f"neighbors must be in [1, min(n - 1, "
            f"{PASSES_MAX_NEIGHBORS - 1})] = "
            f"[1, {min(n - 1, PASSES_MAX_NEIGHBORS - 1)}], "
            f"got {neighbors} (each point needs K OTHER points)")
    if mesh is not None:
        from tpu_knn_torch.distributed.sharded import sharded_topk_knn

        idx, d2 = sharded_topk_knn(points, points, neighbors + 1, mesh=mesh)
    else:
        idx, d2 = topk_knn(points, points, neighbors + 1)
    return _graph_compact(idx, d2, neighbors)
