"""v7 — two-level partial argmin over n-partitions (counterpart of tpu_knn/kernels/twolevel.py).

The candidate kernel of the score tier (B1 or its tensor-core tiers)
folds each of P n-partitions into its own 128 lanes (one launch: the
partitions are the kernel's grid axis, and the kernel masks columns >= n,
so no partition is padded), each partition's winners carry their global
column (the per-partition index rebase of tpu_knn's twolevel.py:62-63,
done in the kernel), and one joint exact refinement selects the winner.
The reference v7's second level read query 0's candidates for every
query (core.cu:771-773, SURVEY.md §2.4); the regression test for m > 1
lives in tests/test_torch_slice.py.
"""

from __future__ import annotations

from tpu_knn_torch.engine.registry import register_version
from tpu_knn_torch.kernels.fused import (
    _refine, _to_host, auto_precision, prep_soa, select_cutoff,
)
from tpu_knn_torch.kernels.tiers import refine_candidates, tier_parts
from tpu_knn_torch.kernels.tuning import LANE
from tpu_knn_torch.utils.platform import as_f32_pair
from tpu_knn_torch.utils.shapes import cdiv, round_up

DEFAULT_PARTITIONS = 8


def twolevel_knn(search, ref, parts: int | None = None, device="cuda"):
    """Returns (indices (m,) int32, exact d2 (m,) f32) on the inputs' device.

    The score tier is tpu_knn's, auto_precision of the global (k, n)
    (twolevel.py:46-53), with its certified cutoff. ``parts=None`` sizes
    the partition count by occupancy, as the reference v7 does
    (core.cu:736-740): on Hopper the partitions are the candidate kernel's
    parallel grid axis, so the count grows from tpu_knn's 8 until the
    launch fills the card (at m = 1 eight partitions are eight blocks)."""
    search, ref = as_f32_pair(search, ref, device)
    m, k = search.shape
    n = ref.shape[0]
    precision = auto_precision(k, n)
    if parts is None:
        parts = max(DEFAULT_PARTITIONS, tier_parts(precision, m, k, n))
    parts = max(1, min(parts, cdiv(n, LANE)))
    cand = refine_candidates(search, (prep_soa(ref, round_up(n, LANE)),), n, parts, precision)
    return _refine(search, ref, cand, n, cutoff=select_cutoff(precision, k))


def v7_callback(k, m, n, search, ref):
    idx, _ = twolevel_knn(search, ref)
    return _to_host(idx)


register_version(
    "v7",
    v7_callback,
    "two-level partial argmin over n-partitions with correct per-query "
    "index rebase (reference v7, core.cu:644-789; bug fixed per SURVEY §2.4)",
)
