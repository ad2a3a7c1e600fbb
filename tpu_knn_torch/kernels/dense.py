"""Dense exact path for small reference sets (counterpart of tpu_knn/kernels/dense.py).

Below a few thousand reference points the m x n matrix is a few megabytes
and the streaming pipeline's fixed stages (per-lane fold, top-T selection,
rerank gathers) cost more than computing every exact diff-form distance
and reducing. Plain torch ops, exact f32 distances, v0's lowest-index tie
rule by construction. A bf16 store's points or an int8 grid are taken as
stored: f32 − bf16 and f32 − int8 promote to f32 exactly, as jnp's do.
"""

from __future__ import annotations

import torch

from tpu_knn_torch.utils.platform import as_f32_pair

_I32_MAX = 2**31 - 1

#: Largest reference set served densely.
DENSE_MAX_N = 4096

#: Cap on m * n * k elements (the broadcast diff tensor).
DENSE_MAX_ELEMS = 1 << 24


def dense_applicable(m: int, k: int, n: int) -> bool:
    return 0 < n <= DENSE_MAX_N and m * n * max(k, 1) <= DENSE_MAX_ELEMS


def _dense(search, ref):
    diff = search[:, None, :] - ref[None, :, :]
    d2 = (diff * diff).sum(dim=-1)                     # (m, n) exact f32
    v = d2.min(dim=-1, keepdim=True).values
    col = torch.arange(ref.shape[0], dtype=torch.int32, device=ref.device)
    idx = torch.where(d2 == v, col, _I32_MAX).min(dim=-1).values
    return idx, v.squeeze(-1)


def dense_knn(search, ref, device="cuda"):
    """(m, k) x (n, k) -> (idx (m,) int32, exact d2 (m,) f32)."""
    return _dense(*as_f32_pair(search, ref, device))
