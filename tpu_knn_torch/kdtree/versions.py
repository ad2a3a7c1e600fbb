"""v9/v10 registry entries (counterpart of tpu_knn/kdtree/versions.py).

v9 (reference core.cu:960-1050): host KD-tree build and the native host
query (OpenMP over queries).
v10 (reference core.cu:1051-1191): the same host build, the tree arrays
placed on the queries' device and the batched traversal run there (on the
card the hand-written kernel, csrc/kdtree_kernels.cu).

v9 guards k <= 16 and falls back to v0, the reference's
curse-of-dimensionality cutoff (core.cu:1035-1036). v10 keeps the
reference's own guard, k <= 16 (core.cu:1177-1178), and falls back to v9;
tpu_knn's k <= 8 was a TPU watchdog fact (a near-exhaustive while_loop
crashed its worker), which the card does not share.
"""

from __future__ import annotations

import numpy as np

from tpu_knn_torch.engine.registry import register_version
from tpu_knn_torch.kdtree.build import build_kdtree
from tpu_knn_torch.kdtree.traversal import KERNEL_MAX_K, DeviceKDTree


def _k_guard(k: int, m: int, n: int) -> bool:
    return k <= 16 and n >= 1


def _v10_guard(k: int, m: int, n: int) -> bool:
    return k <= KERNEL_MAX_K and n >= 1


def v9_callback(k, m, n, search, ref) -> np.ndarray:
    from tpu_knn_torch import native

    ref_h = ref.cpu().numpy()
    tree = build_kdtree(ref_h)
    idx, _ = native.kdtree_query(search.cpu().numpy(), ref_h, tree.p, tree.dim)
    return idx


def v10_callback(k, m, n, search, ref) -> np.ndarray:
    tree = build_kdtree(ref.cpu().numpy())
    idx, _ = DeviceKDTree(tree, ref.device).query(search)
    return idx.cpu().numpy().astype(np.int32)


register_version(
    "v9",
    v9_callback,
    "KD-tree: host build (max-variance split, median) + native host query "
    "(reference v9, core.cu:960-1050)",
    guard=_k_guard,
    fallback="v0",
)

register_version(
    "v10",
    v10_callback,
    "KD-tree: host build + batched traversal on the card, one thread per query "
    "(reference v10, core.cu:1051-1191)",
    guard=_v10_guard,
    fallback="v9",
)
