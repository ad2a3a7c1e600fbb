"""v5 — explicit staging of the streamed operand (counterpart of tpu_knn/kernels/dma_pipeline.py).

The reference v5 (core.cu:424-529) reads the reference points through the
texture path, an explicit choice of memory space for the streamed
operand; tpu_knn's v5 copies (k, tile_n) slices of it HBM→VMEM by hand,
double-buffered (`pltpu.make_async_copy` and semaphores). The port's B10
(`dma_candidates`, csrc/fused_kernels.cu `tma_candidates_kernel`) is B1's
tiled kernel under the template's TMA policy: one thread asks the Tensor
Memory Accelerator for each ring stage's operand and query boxes, and
completion lands on the stage's mbarrier. It takes B1's geometry and
fold and emits indices only, as `_dma_kernel` does; the bare-index
`_refine` reranks every candidate exactly. `dma_knn` resolves
`precision=None` through `auto_precision(k, n)`, as tpu_knn's does; every
tier other than "highest" runs B10's tensor-core instance
(csrc/tensor_ladder_kernels.cu: B1's tier mainloop with each stage's
operand box staged by the same Tensor Memory Accelerator, indices only).

v5 has no guard: the ring's shared memory does not depend on k, so the
kernel's own limit (ROADMAP C) admits every shape. tpu_knn's v5 delegates
wide k to v4 (its 2 × (k, tile_n) VMEM scratch); the port's answers there
are the same exact 1-NN.
"""

from __future__ import annotations

import torch

from tpu_knn_torch.engine.registry import register_version
from tpu_knn_torch.kernels.fused import (
    _check_candidate_operands, _check_precision_certified, _refine, _to_host,
    auto_precision, fused_candidates_plain, ladder_parts, prep_soa, transposed_queries,
)
from tpu_knn_torch.kernels.tuning import (
    LANE, MAX_TILE_N, SCORE_TILE_BUDGET, pick_tiles, tiled_geometry,
)
from tpu_knn_torch.utils.platform import as_f32_pair, launch_stream
from tpu_knn_torch.utils.shapes import round_up


def _dma_tiles(k: int, m: int, n: int) -> tuple[int, int]:
    """tpu_knn's v5 tile policy, verbatim: (tile_m, tile_n), tile_n not
    shrunk for wide k. The port keeps it for the per-call operand's n
    padding (round_up(n, tile_n), as tpu_knn pads), which also makes the
    operand's row stride the multiple of 128 floats B10's tensor map
    needs; the kernel's own geometry is B1's (tuning.tiled_geometry)."""
    tile_m, _ = pick_tiles(k, m, n)
    budget = SCORE_TILE_BUDGET // (4 if n <= (1 << 17) else 1)
    tile_n = min(MAX_TILE_N, budget // tile_m, round_up(n, 128))
    return tile_m, max(128, (tile_n // 128) * 128)


def dma_candidates_plain(q, r_op, n: int, parts: int, precision: str = "highest"):
    """B10's plain version: B1's plain candidates at the tier, indices
    only."""
    if precision != "highest":
        from tpu_knn_torch.kernels.tiers import dma_tier_candidates_plain

        return dma_tier_candidates_plain(q, r_op, n, parts, precision)
    return fused_candidates_plain(q, r_op, n, parts)[0]


def dma_candidates(q: torch.Tensor, r_op: torch.Tensor, n: int, parts: int,
                   precision: str = "highest"):
    """(m, k) queries x (k_pad, n_pad) SoA operand -> (m, parts*128)
    int32 candidate indices: B1's contract without the scores, through
    B10. "highest": B1's tiled kernel with TMA-staged stages
    (csrc/fused_kernels.cu) at B1's rows per warp; any other term-list tier:
    B10's tensor-core instance (tiers.dma_tier_launch; P from
    fused.ladder_parts). At the same ``parts`` the indices equal B1's at
    the tier on the card. The operand's tensor map needs it 16-byte aligned
    with a row stride that is a multiple of 128 floats. CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    _check_candidate_operands(q, r_op, n, parts)
    m, k = q.shape
    if precision != "highest":
        from tpu_knn_torch.kernels import tiers

        tiers.ladder_terms(precision, k)
    if q.device.type == "cpu":
        return dma_candidates_plain(q, r_op, n, parts, precision)
    if r_op.data_ptr() % 16 or r_op.stride(0) % LANE:
        raise ValueError("B10's tensor map takes an operand that is 16-byte aligned with "
                         f"a row stride that is a multiple of {LANE} floats, got stride "
                         f"{r_op.stride(0)}, base address {r_op.data_ptr() % 16} mod 16")
    if precision != "highest":
        return tiers.dma_tier_launch(q, r_op, n, parts, precision)
    from tpu_knn_torch.csrc.build import check, load

    lib = load()
    q_t = transposed_queries(q)
    idx = torch.empty((m, parts * LANE), dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.tk_dma_candidates(
            q_t.data_ptr(), r_op.data_ptr(), idx.data_ptr(), m, q_t.shape[1], k,
            r_op.stride(0), n, parts, tiled_geometry(m, k, n).tm,
            launch_stream(q.device))
    check(lib, err, "B10 dma_candidates")
    dma_candidates.launches += 1
    return idx


#: Kernel launches of B10 at "highest" (CUDA tensors only; the plain version
#: is not counted; its tier instances count in tiers.TIER_LAUNCHES).
dma_candidates.launches = 0


def dma_knn(search, ref, *, precision: str | None = None, allow_approximate: bool = False,
            device="cuda"):
    """Exact 1-NN through B10 and the bare-index refine, which reranks
    every lane. Returns (indices (m,) int32, exact squared distances (m,)
    f32) on the inputs' device. ``precision=None`` resolves through
    auto_precision(k, n), as tpu_knn's dma_knn does. Unlike tpu_knn's, the
    tier is certified as fused_knn's (ROADMAP C): "qsplit2" over per-call
    f32 points is refused, and "bf16_raw" needs allow_approximate=True."""
    _check_precision_certified(precision, allow_approximate)
    search, ref = as_f32_pair(search, ref, device)
    m, k = search.shape
    n = ref.shape[0]
    if precision is None:
        precision = auto_precision(k, n)
    _, tile_n = _dma_tiles(k, m, n)
    r_op = prep_soa(ref, round_up(n, tile_n))
    idx = dma_candidates(search, r_op, n, ladder_parts("v5", precision, m, k, n), precision)
    return _refine(search, ref, idx, n)


def v5_callback(k, m, n, search, ref):
    idx, _ = dma_knn(search, ref)
    return _to_host(idx)


register_version(
    "v5",
    v5_callback,
    "B1's tiled kernel over stages of the operand and queries staged by the "
    "Tensor Memory Accelerator (mbarrier ring), indices only, no guard, CUDA "
    "(reference v5 texture path, core.cu:424-529)",
    fallback="v4",
)
