"""v5 — explicit staging of the streamed operand (counterpart of tpu_knn/kernels/dma_pipeline.py).

The reference v5 (core.cu:424-529) reads the reference points through the
texture path, an explicit choice of memory space for the streamed
operand; tpu_knn's v5 copies (k, tile_n) slices of it HBM→VMEM by hand,
double-buffered. The port's B10 (`dma_candidates`, csrc/fused_kernels.cu)
stages (k, slice) pieces of the SoA operand into a ring of shared-memory
stages with `cp.async`, issuing the next piece's copy before it scores
the current one, and folds B1's scores per lane. It emits indices only,
as `_dma_kernel` does; the bare-index `_refine` reranks every candidate
exactly.

Like the reference's v5 (which falls back to v4 past the texture width,
core.cu:481-485), the guard is the kernel's own hard limit: the staging
ring and the query tile must fit a block's shared memory. On the TPU that
limit was the 12 MB of scoped VMEM at tpu_knn's tiles (ROADMAP C). Wide k
still delegates to v4.
"""

from __future__ import annotations

import torch

from tpu_knn_torch.engine.registry import register_version
from tpu_knn_torch.kernels.fused import (
    B1_BLOCKS_PER_SM, _check_candidate_operands,
    _check_highest_only, _refine, _to_host, fused_candidates_plain, prep_soa,
)
from tpu_knn_torch.kernels.tuning import (
    LANE, MAX_QUERY_SMEM, MAX_TILE_N, SCORE_TILE_BUDGET, pick_parts, pick_tiles,
)
from tpu_knn_torch.utils.platform import as_f32_pair
from tpu_knn_torch.utils.shapes import cdiv, round_up

#: Shared-memory stages of B10's ring (csrc kDmaStages): the TPU's
#: double buffer.
DMA_STAGES = 2

#: Bytes one stage aims at: a slice of 128-column groups, at most
#: DMA_MAX_SLICE_GROUPS of them, about this large for the operand's k rows.
DMA_STAGE_BYTES = 16 * 1024
DMA_MAX_SLICE_GROUPS = 8


def _dma_tiles(k: int, m: int, n: int) -> tuple[int, int]:
    """tpu_knn's v5 tile policy, verbatim: (tile_m, tile_n), tile_n not
    shrunk for wide k. The port keeps it for the per-call operand's n
    padding (round_up(n, tile_n), as tpu_knn pads); the kernel's own
    geometry is dma_geometry."""
    tile_m, _ = pick_tiles(k, m, n)
    budget = SCORE_TILE_BUDGET // (4 if n <= (1 << 17) else 1)
    tile_n = min(MAX_TILE_N, budget // tile_m, round_up(n, 128))
    return tile_m, max(128, (tile_n // 128) * 128)


def dma_smem_bytes(tile_m: int, k: int, slice_groups: int) -> int:
    """Shared memory of one B10 block: the query tile (rounded to 16
    bytes) and the ring of (k, slice_groups * 128) f32 stages."""
    return 4 * (round_up(tile_m * k, 4) + DMA_STAGES * k * slice_groups * LANE)


def dma_geometry(m: int, k: int) -> tuple[int, int]:
    """(tile_m, slice_groups) of a B10 launch: slices of about
    DMA_STAGE_BYTES, and the most query rows per block (32, 8 or 1; 8 for
    batches that 32 would mostly pad) whose tile fits beside the ring in
    MAX_QUERY_SMEM. Raises where even one row and one group do not fit."""
    groups = max(1, min(DMA_MAX_SLICE_GROUPS, DMA_STAGE_BYTES // (k * LANE * 4)))
    for tm in (32, 8, 1):
        if tm == 32 and m <= 8:
            continue
        if dma_smem_bytes(tm, k, groups) <= MAX_QUERY_SMEM:
            return tm, groups
    raise ValueError(f"k={k}: B10's staging ring does not fit a block's "
                     f"shared memory ({MAX_QUERY_SMEM} bytes)")


def default_parts(m: int, k: int, n: int) -> int:
    """B10 partition count: B1's occupancy rule on B10's row tiles."""
    return pick_parts(cdiv(m, dma_geometry(m, k)[0]), n, B1_BLOCKS_PER_SM)


def dma_candidates_plain(q, r_op, n: int, parts: int):
    """B10's plain version: B1's plain candidates, indices only."""
    return fused_candidates_plain(q, r_op, n, parts)[0]


def dma_candidates(q: torch.Tensor, r_op: torch.Tensor, n: int, parts: int):
    """(m, k) queries x (k_pad, n_pad) SoA operand -> (m, parts*128)
    int32 candidate indices: B1's contract without the scores, through
    B10's staged sweep (csrc/fused_kernels.cu). At the same ``parts`` they
    equal B1's indices on the card. The operand must start on a 16-byte
    boundary with a row stride that is a multiple of 4 floats (cp.async's
    16-byte copies). CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    _check_candidate_operands(q, r_op, n, parts)
    m, k = q.shape
    tm, groups = dma_geometry(m, k)
    if q.device.type == "cpu":
        return dma_candidates_plain(q, r_op, n, parts)
    if r_op.data_ptr() % 16 or r_op.stride(0) % 4:
        raise ValueError("B10 stages 16-byte pieces: the operand must be 16-byte "
                         "aligned with a row stride that is a multiple of 4")
    from tpu_knn_torch.csrc.build import check, load

    lib = load()
    idx = torch.empty((m, parts * LANE), dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.tk_dma_candidates(
            q.data_ptr(), r_op.data_ptr(), idx.data_ptr(), m, k, r_op.stride(0), n,
            parts, tm, groups, torch.cuda.current_stream(q.device).cuda_stream)
    check(lib, err, "B10 dma_candidates")
    dma_candidates.launches += 1
    return idx


#: Kernel launches of B10 (CUDA tensors only; the plain version is not counted).
dma_candidates.launches = 0


def dma_knn(search, ref, *, precision: str | None = None, device="cuda"):
    """Exact 1-NN through B10 and the bare-index refine. Returns (indices
    (m,) int32, exact squared distances (m,) f32) on the inputs' device.
    The port computes the f32 "highest" tier only."""
    _check_highest_only(precision, "v5 (B10)")
    search, ref = as_f32_pair(search, ref, device)
    m, k = search.shape
    n = ref.shape[0]
    _, tile_n = _dma_tiles(k, m, n)
    r_op = prep_soa(ref, round_up(n, tile_n))
    idx = dma_candidates(search, r_op, n, default_parts(m, k, n))
    return _refine(search, ref, idx, n)


def v5_callback(k, m, n, search, ref):
    idx, _ = dma_knn(search, ref)
    return _to_host(idx)


def _v5_guard(k: int, m: int, n: int) -> bool:
    """True when B10's staging ring and query tile fit a block's shared
    memory (dma_geometry) — the analog of v5's texture-width precondition
    (core.cu:481-485): wide k delegates to v4."""
    try:
        dma_geometry(m, k)
    except ValueError:
        return False
    return True


register_version(
    "v5",
    v5_callback,
    "B1's sweep over cp.async-staged shared-memory slices of the operand, "
    "indices only, CUDA (reference v5 texture path, core.cu:424-529)",
    guard=_v5_guard,
    fallback="v4",
)
