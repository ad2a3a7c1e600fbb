"""v1/v2 — the two-phase versions as torch ops (counterpart of tpu_knn/kernels/twophase.py).

The reference's v1 computes an explicit m×n distance matrix and then the
per-row argmins (core.cu:64-121); v2 replaces the argmin with a block tree
reduction and streams n (core.cu:122-230). tpu_knn left both phases to
XLA; the port leaves them to torch:

- the matrix is the matmul form d²(i,j) = ‖r_j‖² − 2·q_i·r_j (the row-
  constant ‖q_i‖² is dropped; it cannot move an argmin), computed in true
  f32 (tpu_knn used Precision.HIGHEST): TF32 is switched off around the
  product whatever the caller set (utils/platform.full_f32_matmul);
- the argmin is `torch.argmin`, which keeps the first minimum of a row,
  as `jnp.argmin` does: v0's lowest-index tie rule.

v1 materializes the whole (m, n) matrix; v2 walks n in chunks of V2_CHUNK
columns with a running (min, index) carry and a strict `<` across chunks,
so the earlier chunk keeps an exact tie.
"""

from __future__ import annotations

import torch

from tpu_knn_torch.engine.registry import register_version
from tpu_knn_torch.kernels.fused import _to_host
from tpu_knn_torch.utils.platform import full_f32_matmul
from tpu_knn_torch.utils.shapes import round_up

#: Max f32 bytes of v1's materialized (m, n) matrix plus both operands,
#: tpu_knn's budget verbatim (a 4 GiB matrix at ds10/ds11 plus the
#: operands); past it v1 delegates to v2, which serves every shape.
V1_MAX_TOTAL_BYTES = (1 << 32) + (1 << 27)


def _v1_guard(k: int, m: int, n: int) -> bool:
    return 4 * (m * n + n * k + m * k) <= V1_MAX_TOTAL_BYTES


#: n-axis chunk length for the v2 stream.
V2_CHUNK = 1 << 16


def _partial_scores(q: torch.Tensor, r_chunk: torch.Tensor) -> torch.Tensor:
    """(m, k) x (c, k) -> (m, c) scores ‖r‖² − 2·q·r in true f32."""
    r_norm = (r_chunk * r_chunk).sum(dim=1)
    with full_f32_matmul():
        qr = q @ r_chunk.T
    return r_norm[None, :] - 2.0 * qr


def _v1_argmin(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    return torch.argmin(_partial_scores(q, r), dim=1).to(torch.int32)


def _v2_argmin(q: torch.Tensor, r: torch.Tensor, chunk: int) -> torch.Tensor:
    """Streaming two-phase argmin over n-chunks with a running
    (best_score, best_index) carry."""
    m = q.shape[0]
    best_d = torch.full((m,), torch.inf, dtype=torch.float32, device=q.device)
    best_i = torch.zeros((m,), dtype=torch.int32, device=q.device)
    for start in range(0, r.shape[0], chunk):
        s = _partial_scores(q, r[start:start + chunk])
        local_d, local_i = s.min(dim=1)    # the first minimum of the chunk
        # Chunks arrive in index order: a strict < keeps the earlier
        # (lower) global index on exact ties, as v0's strict update does.
        take = local_d < best_d
        best_i = torch.where(take, local_i.to(torch.int32) + start, best_i)
        best_d = torch.where(take, local_d, best_d)
    return best_i


def v1_callback(k: int, m: int, n: int, search, ref):
    return _to_host(_v1_argmin(search, ref))


def v2_callback(k: int, m: int, n: int, search, ref):
    return _to_host(_v2_argmin(search, ref, min(V2_CHUNK, round_up(n, 128))))


register_version(
    "v1",
    v1_callback,
    "two-phase torch ops: materialized f32 distance matrix + row argmin "
    "(reference v1, core.cu:64-121)",
    guard=_v1_guard,
    fallback="v2",
)

register_version(
    "v2",
    v2_callback,
    "two-phase torch ops, streamed: n-chunks with a running (min, index) "
    "carry, no materialized matrix (reference v2, core.cu:122-230)",
)
