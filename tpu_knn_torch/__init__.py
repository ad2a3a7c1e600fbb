"""tpu_knn_torch — the PyTorch + CUDA port of tpu_knn for one NVIDIA H100.

Exact 1-NN under squared L2 with lowest-index ties (reference contract,
core.h:71), through the same entry points as tpu_knn. The port imports
torch and never jax; tpu_knn stays the reference it is tested against.

    >>> import tpu_knn_torch
    >>> idx = tpu_knn_torch.nearest_neighbors(queries, refs)   # v8; v7 on one card
    >>> idx = tpu_knn_torch.nearest_neighbors(queries, refs, version="v5")
    >>> index = tpu_knn_torch.NNIndex(refs, strategy="fused")  # or "auto", "projection", "kdtree"
    >>> idx, d2 = index.query(queries)
    >>> idx, d2 = index.query(queries, neighbors=16)           # exact top-K
    >>> index = tpu_knn_torch.NNIndex(refs, metric="cosine")   # or "ip"; store="bf16"/"int8",
    >>> view = index.filtered_view(keep)                       # mutable=True (add/remove/compact)
    >>> idx, d2 = tpu_knn_torch.topk_knn(queries, refs, 16)
    >>> idx, d2 = tpu_knn_torch.knn_graph(points, 15)            # K-NN graph
    >>> index.save("index.npz"); index = tpu_knn_torch.NNIndex.load("index.npz")
    >>> from tpu_knn_torch.distributed.sharded import default_mesh
    >>> mesh = default_mesh(dp=1, sp=4)                         # four cards, one a shard
    >>> idx, d2 = tpu_knn_torch.sharded_knn(queries, refs, mesh=mesh)
    >>> index = tpu_knn_torch.NNIndex(refs, strategy="sharded", mesh=mesh)

The version ladder is tpu_knn's, v0–v11 (v8 the points sharded over every
visible card, delegating to v7 on one), and the harness CLI is
``python -m tpu_knn_torch.harness.runner``. NumPy inputs go to
``device=`` (default "cuda"); torch tensors run where they are. The
hand-written kernels (B1–B12 in csrc/*_kernels.cu, B8/B9 one compactor,
with B1's AoS and constant-query variants, and v10's KD-tree traversal)
run on an sm_90 card; on the CPU their plain torch versions run instead.
The host KD-trees (v9, strategy="kdtree") are a native library built by
g++ on first use (tpu_knn_torch/native).
"""

from tpu_knn_torch.api import knn_callback, knn_graph, nearest_neighbors
from tpu_knn_torch.engine.registry import get_version, list_versions, register_version

#: Lazily-imported public symbols (PEP 562), as in tpu_knn.
_LAZY = {
    "NNIndex": ("tpu_knn_torch.engine.index", "NNIndex"),
    "topk_knn": ("tpu_knn_torch.kernels.topk", "topk_knn"),
    "within_radius": ("tpu_knn_torch.kernels.topk", "within_radius"),
    "within_radius_complete": ("tpu_knn_torch.kernels.topk",
                               "within_radius_complete"),
    "sharded_knn": ("tpu_knn_torch.distributed.sharded", "sharded_knn"),
    "sharded_topk_knn": ("tpu_knn_torch.distributed.sharded", "sharded_topk_knn"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'tpu_knn_torch' has no attribute {name!r}")


__version__ = "0.1.0"

__all__ = [
    "nearest_neighbors",
    "knn_callback",
    "knn_graph",
    "NNIndex",
    "topk_knn",
    "within_radius",
    "within_radius_complete",
    "sharded_knn",
    "sharded_topk_knn",
    "get_version",
    "list_versions",
    "register_version",
    "__version__",
]
