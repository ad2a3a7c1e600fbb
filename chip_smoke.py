#!/usr/bin/env python3
"""Smoke run of the tpu_knn_torch port on one H100.

    python3 chip_smoke.py        # from the repository root; one CUDA card

Phases, in order; any failure raises and the script exits nonzero:

0. setup: requires an sm_90 card, prints its name and power limit, turns
   TF32 off, builds the CUDA kernels from tpu_knn_torch/csrc (build time
   and the ptxas report are printed; any spill in an instance of B3's or
   B7's tiled kernel, of B1's tiled kernel as v3, v6 or B10 (its TMA
   instance), of B5 or B6, of the B8/B9 compactor or of the tensor-core
   mainloop's instances (B1's tiers and B12, B4, B3, B5 and B7's tier
   instances, and the ladder's: v3's AoS-staged, B10's TMA-staged and v6's
   live-row instances) fails, and so does a v3, v6, B10, B5 or B6
   instance whose static shared memory is not tuning's mirror of it, or a
   ladder tier instance with any static shared memory);
1. each kernel (B1 fused candidates, B2 small-m candidates, B4 banded
   candidates, B5 sweep candidates, B6 small-m top-K candidates) against
   its plain torch version on the card, at a grid of shapes and at the
   shapes the main path gives it, with planted exact duplicates at a
   partition boundary and a lane boundary; B1 and B4 (the tiled f32
   kernel) also at its tile edges (m past a block's rows, n ragged against
   a column tile and 128, k ragged against a d-chunk, k = 1, 768 and 7000,
   ld not a multiple of 4) with a tie planted inside one lane, within a
   column tile and across tiles (their errors logged apart from the B1
   and B4 rows'); B1 also at (768, 1024, 2^20), the "B1 k=768" row's
   shape; B4 also bit-equal to B1 with a
   bound that masks exactly, and at every launch of the passes engine at
   ds11 K = 8 and (16, 64, 2^20) K = 64; B5 (also at m = 1, 64, 65 and
   1024, k = 1, 40 and 768, a partition of an odd number of groups) and B6
   in two launches that must be identical, their lists held to the list
   contract (each column in its partition's list, each list ascending,
   the seeds), B5's lists slot by slot against the plain version's (a
   disagreeing slot only at a near-tie) and its top-K equal to the passes
   engine's, every B6 row holding at least K real entries; then
   the seeded engine's kernels: B3 (value-only lane minima; bit-equal to
   B1's), B7 (per-cell moments; packed words identical to the plain
   version's, with bounds set between scores) and the B8/B9 compactor
   (identical in two launches, at part widths on both sides of 8192 and
   of one 256-thread round, dense rows, cap equal to the part width,
   nc % 4 != 0 and a misaligned base); B3 and B7 (the
   tiled template with their own epilogues) also at its tile edges (m
   past a block's rows, n ragged against 256 and 128, an operand wider
   than n, k ragged against a d-chunk, k = 1 and 768, ld not a multiple of
   4 for B3, a misaligned operand base for B7, cells of 64/128/256 in both
   modes), each launch also with the transposed queries passed in as the
   engine passes them; B7 at the ds11 K = 8 and K = 64 launches with the
   bound set to each row's uninflated K-th smallest of the kernel's own
   B3 minima, counting at least K qualifiers in every row (the two score
   bit for bit alike); then every B3, B7 and compactor launch of the
   seeded main path against its plain version (SeededLaunchCheck), with
   phase 2's seeded calls run once on data of their own; then the 1-NN
   ladder's kernels: B10 (index-equal to B1 at the same partition count,
   in two launches) on a grid, at v5's launches of phase 2 and at its TMA
   ring's edges (k = 1, 17, 250, 768, 2048, 7000, m past a block's rows,
   n ragged against 128 and 256), B11 (windows of 1 + 1 and
   64 + 1 tiles, n ragged against 4096, a window at the last tile with
   planted duplicates, and the auto path's
   (3, 16, 2^24) launch, at one split and the default splits), and B1's
   AoS (v3) and resident-query (v6) variants, bit-equal to B1 (on a grid,
   at phase 2's ladder launches ds8..ds11, at k not a multiple of 4, m = 1,
   ragged n, and v6's guard's extremes); then the
   tensor-core kernel's instances (B1's tiers and B12) on a grid of k = 1
   ... 768 with ragged n and at every shape phase 2 gives them (ds11 over
   f32, bf16 and int8-grid operands; packed2 at (32, 1024, 2^20); the
   embed shapes (1024, 2^20) at k = 128 and 768 over each store's
   operand), each against its plain version: the refined answers over the
   merged 128 lanes, the planted tie, the score error against f64
   (relative to the largest |score|) within the tier's gate, and the
   certified fast path's top-T selection exact at the measured error; B1
   "highest" beside each; B4, B5, B3 and B7's tier instances against their
   plain versions at the engines' K = 8 launches at ds11 (packed), (128,
   1024, 2^20) and (768, 1024, 2^18) (bf16x3; qsplit2 over a bf16
   operand), B4's K passes bit-equal to B5's lists and B7's remainder
   minima bit-equal to B3 banded at the same bound; the ladder's tier
   instances (LADDER_TIER_CASES: ds8..ds11 at "packed", bf16x3 at (768,
   1024, 2^18) and (768, 16, 2^20), k = 12, an (n, k) array whose base is
   not 16-byte aligned, ragged n, packed2, bf16x4, default): B10's indices
   bit-equal to B1's tier launch at the same P in two launches, v6's (idx,
   score) bit-equal to B1's tier at v6's P, v3's where the term lists agree,
   each against its plain version (agreement, the score error within the
   tier's gate, the same refined 1-NN); and B2-bf16, bit-equal
   to B2 on the upcast operand; then the bf16 instances (B1, B4, B3, B5 and B7 under the tiled
   template's BF16 policy, and B6-bf16), each bit-equal to its f32
   instance over the upcast operand on a grid (k = 1..128, m past a
   block's rows, n ragged, ld != n, ld % 8 != 0 and a misaligned base; B6-bf16
   at each load width) and at the main path's launches; then PAD columns
   (1e30, and bf16(1e30)) in every row of the operand through B1 "highest"
   and each tier, B2, B2-bf16, B3-B7, their tier instances and the bf16
   instances: none
   reported, no NaN, a PAD-only cell never qualifying; then v10's KD-tree
   traversal (csrc/kdtree_kernels.cu) at (3, 1024, 2^16), over uniform and
   lattice points, and (16, 256, 2^12), with exact duplicates, a query on
   the root's split plane and a query equal to a point: indices identical
   to its plain version's and d2 bit for bit, in two identical launches;
2. the main paths, each with every launch counter set to 0 just before it
   and read just after:
   - 1-NN: the 8 TA shapes through knn_callback (v7 default, v4)
     against tests/golden/results_seed1000.csv, and ds11 = (16, 1024,
     2^20) / ds9 = (16, 1, 2^24) per call and through NNIndex, checked by
     an independent exact scan on the card with the harness's ±1e-3 rule;
   - top-K: topk_knn (sweep at m = 8 and 32, passes at ds11 and K = 64),
     NNIndex.query(neighbors=16) at (16, 4, 2^24) and m = 1,
     nearest_neighbors(neighbors=8), each checked rank by rank against an
     independent exact top-K scan with the same rule; one
     within_radius_complete escalation;
   - seeded top-K (the batch regime): topk_knn at ds11 with K = 8, 16,
     32, 64, 128 and 256 (rounds), NNIndex.query(neighbors=16) at ds11,
     K = 8 over 2^22 points (the compactor at part width 16384), each of
     which must answer in the fast tier, one planted case per tier
     (expanded cell, passes fallback, escalation) with the tier counters
     checked, within_radius_complete at m = 8 past
     cap 32, and knn_graph(points, 15) at (k = 16, n = 2^17) with K + 2
     exact duplicates, every row gated;
   - the 1-NN ladder: the harness runner (tpu_knn_torch.harness.runner)
     over the TA shapes with every registered version, v0's CSV equal to
     the golden file and 0 errors for the rest; v1, v2, v3, v5, v6 and v11
     at each of ds8..ds11 that its guard admits, against the exact scan
     (v3, v5 and v6 at their resolved tier, "packed" there), and v3, v5 and
     v6 at precision="highest" at ds11 and ds9;
   - the ladder at embedding width: v3 and v5 at (768, 1024, 2^18), v6 at
     (768, 16, 2^20) (bf16x3; v6 with its live rows' q parts resident),
     and smallm_knn(tile_n=) at ds9 (B2's per-call pipeline), gated;
   - auto and projection serving over (3, 2^24): NNIndex(strategy="auto")
     (the probe's certification rate; m = 16 routed to projection, m = 64
     to fused), NNIndex(strategy="projection") at m = 16, and a planted
     identical-projection case that must take the fallback scan;
   - the score tiers: fused_knn at ds11 with each explicit tier, v7 at
     (32, 1024, 2^20) (packed2), NNIndex at ds11 with the default tier and
     with precision="bf16x3_presplit" (B12) at m = 1, 4, 1024;
   - the stores: NNIndex(store=float32/bf16/int8) at (16, 1024, 2^20)
     through query and pipeline(1024), m = 1 and 4 too, and at the embed
     shapes k = 128 and 768 (m = 1024, n = 2^20), whose tier must be
     tpu_knn's (bf16x3, qsplit2, qsplit2), gated over the stored points
     (grid space for int8), each index freed before the next;
   - "highest" 1-NN at (768, 1024, 2^20): fused_knn(precision="highest")
     and NNIndex(precision="highest"), gated; its B1 launches are the
     "B1 k=768" row's;
   - top-K and radius over the stores: the bf16 store at (16, 1024, 2^20)
     (seeded K = 8 and 64, m = 8 K = 32, one passes-engine call,
     "highest" 1-NN) and at (16, 4, 2^24) K = 16, the int8 store at m = 1
     K = 16 over (16, 2^24) and m = 1024 K = 8 over (16, 2^20) and a
     radius escalation at m = 8; each bf16 instance must launch;
   - the top-K engines at "highest" (f32 and bf16 indexes with
     precision="highest", beside the f32 index at its packed tier) and at
     embedding width (topk_knn at (128, 1024, 2^20), bf16x3; a bf16 store
     there, qsplit2): seeded, sweep and passes calls, gated; every other
     top-K path runs at its resolved tier (packed at k = 16);
   - metric="cosine" and "ip" at (128, 1024, 2^20): 1-NN, K = 10, a
     cosine radius escalation, gated in the transformed space;
   - mutable f32 and bf16 indexes at (16, 2^20): add 2^16, remove 2^16,
     grow past capacity once, compact, with m = 4 and 1024, 1-NN and K = 8
     gated over the slot array after each step;
   - filtered_view keeping half of (16, 2^20), f32 and bf16: 1-NN, K = 8
     and radius, gated over the kept points;
   - the KD-tree: v9 and v10 through nearest_neighbors(version=) at the
     reference's KD row (3, 1024, 2^16), ds10 and (16, 1024, 2^16), and
     NNIndex(strategy="kdtree") at ds10 (1-NN at m = 4 and 1024, K = 8, a
     radius query), each gated;
   - precision="bf16x3_presplit" beside store="bf16" and "int8" at ds11
     and (768, 1024, 2^20), m = 4 and 1024, and beside strategy="auto" at
     (3, 2^24) (m = 16 routed to projection, m = 64 to B12), gated over
     the stored points;
   - save -> load -> query: ds11 f32, bf16, int8, presplit and bf16 +
     presplit, auto at (3, 2^24), cosine and ip at (16, 1024, 2^20), a
     mutable f32 index of 2^20 slots after removes and adds, the kdtree
     at ds10: each loaded index answers bit for bit as the saved one
     (indices and d2; auto's routes too) at m = 4 and 1024, with K = 8
     where the index serves top-K; each file's size and the save and load
     walls are logged;
3. times (CUDA events, medians) of the kernels, their plain versions, the
   cuBLAS product of the score matrices and the main paths (B5 at (16, 8,
   2^20) K = 32 and (16, 32, 2^20) K = 8 and B6 at (16, 4, 2^24) K = 16
   also by device time, with the selection over their candidates; B11
   and B2-bf16 also by device time; B1 "highest"
   also at (768, 1024, 2^20), a row of its own, with fused_knn there; B1,
   B4, B3 and B7 (at the seeded ds11 K = 8 and K = 64 launches, B3 with
   its partition merge), the compactor (at those and at (16, 1024, 2^22)
   K = 8), v3, v6 and B10 (at ds11 and ds9, beside B1 at their P) and
   each tier row and B12 also by their kernels' own device time
   from torch.profiler; among them
   the ladder's per-call rows and prepared auto against prepared fused,
   with device time and idle per host read from torch.profiler; each tier
   at its main-path shape beside B1 "highest" and cuBLAS's bf16 product;
   the store and embed calls), each printed beside the card's name and
   power limit, and the bounds (tensor-core tiers at 989 TFLOP/s bf16);
   v3's, B10's and v6's tier instances (ds11 packed3; v3 and B10 at (768,
   1024, 2^18), v6 at (768, 16, 2^20), bf16x3) beside the same rung at
   "highest" and B1's tier launch, by events and device time, and the
   ladder's per-call rows at ds8..ds11, v3, v5 and v6 at their tiers;
   each top-K tier instance beside the same launch at "highest" and
   cuBLAS's bf16 product, with its device time, at ds11 and (768, 1024,
   2^18);
   each bf16 instance beside its f32 instance at the main path's launch
   (events and device time, bound at k·n·2 operand bytes), and the device
   and host time of the store top-K, metric, mutable and view calls; v10's
   kernel (events and device time) and its plain version at the KD row and
   ds10 with the visits the plain version counts, v9's host build and
   query there, the kdtree index's queries at ds10; B12 at ds11 over the
   f32 split, a bf16 store's operand and the int8 grid's; a loaded ds11
   index's first query against its steady one.

The last two lines are a JSON summary of the kernels and the result line
{"ok": true, "device": {...}}. The script imports neither jax nor the
JAX package tpu_knn.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden", "results_seed1000.csv")

DS8 = (3, 1, 1 << 24)
DS9 = (16, 1, 1 << 24)
DS10 = (3, 1024, 1 << 20)
DS11 = (16, 1024, 1 << 20)

#: Phase 1 tolerances: candidate indices agree on at least this share of
#: (row, lane) slots (a near-tie inside one lane may resolve differently
#: under another f32 summation order); scores agree within this fraction
#: of the largest |score| (f32 summation order, k <= 32 terms).
MIN_INDEX_AGREEMENT = 0.9999
SCORE_RTOL = 1e-5


_T0 = time.perf_counter()


def log(*args):
    print(*args, flush=True)


def stamp(what: str):
    """Log the script's elapsed seconds as `what` ends."""
    log(f"  [{time.perf_counter() - _T0:.1f} s: {what} done]")


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ---- data ----------------------------------------------------------------


def uniform(gen, shape, device):
    import torch

    return torch.rand(shape, generator=gen, device=device, dtype=torch.float32)


def plant_duplicates(q, r_op, n: int, parts: int):
    """Copy query 0 into the two columns astride a lane boundary (127|128)
    and query min(1, m-1) into the two astride the first partition
    boundary, so exact ties decide rows 0 and 1."""
    from tpu_knn_torch.utils.shapes import cdiv

    k = q.shape[1]
    gpp = cdiv(cdiv(n, 128), parts)
    cols = [(0, 127), (0, 128)]
    b = gpp * 128
    if parts > 1 and b < n:
        cols += [(min(1, q.shape[0] - 1), b - 1), (min(1, q.shape[0] - 1), b)]
    for row, c in cols:
        if c < n:
            r_op[:k, c] = q[row]
    return r_op


def plant_lane_ties(q, r_op, n: int, parts: int):
    """Copy query min(2, m-1) into three columns of lane 37 of partition 0:
    groups 1 and 2 (one column tile of the tiled f32 kernel) and group 9
    (the next tile, a later ring step), where the partition has them, so
    that the lane must keep its earliest column through equal scores."""
    from tpu_knn_torch.utils.shapes import cdiv

    k, row = q.shape[1], min(2, q.shape[0] - 1)
    end = min(n, cdiv(cdiv(n, 128), parts) * 128)
    for g in (1, 2, 9):
        if g * 128 + 37 < end:
            r_op[:k, g * 128 + 37] = q[row]
    return r_op


def case_operand(gen, device, k, n, ld=None):
    """Points (n, k) as the SoA operand (round_up(k, 8), ld), ld defaulting
    to round_up(n, 128); an ld that is not a multiple of 4 sends the tiled
    f32 kernel down its 4-byte copy path."""
    from tpu_knn_torch.kernels.fused import prep_soa
    from tpu_knn_torch.utils.shapes import round_up

    return prep_soa(uniform(gen, (n, k), device), ld or round_up(n, 128))


def score_rtol(k: int) -> float:
    """Scores of two f32 summation orders of k terms (kernel and cuBLAS)
    differ by up to about 4 k 2^-24 of the largest |score|: SCORE_RTOL
    covers k <= 40, the tile-edge cases at k = 768 and 7000 take the
    k-scaled rule (tests/test_torch_kernels.py's)."""
    return max(SCORE_RTOL, 4 * k * 2.0 ** -24)


# ---- phase 1: kernel vs plain ------------------------------------------


def compare_candidates(name, kern, plain, q, r_op, n, parts, cutoff, rtol=SCORE_RTOL):
    """Run kernel and plain version on the same inputs; check the phase-1
    tolerances (scores within rtol of the largest |score|) and that the
    refined 1-NN answers are identical. Returns the largest |score
    difference| on agreeing slots."""
    import torch

    from tpu_knn_torch.kernels.fused import _refine

    ki, ks = kern(q, r_op, n, parts)
    pi, ps = plain(q, r_op, n, parts)
    agree = ki == pi
    share = agree.float().mean().item()
    if (agree & (torch.isfinite(ks) != torch.isfinite(ps))).any():
        fail(f"{name}: a slot is finite in one version and not in the other")
    finite = agree & torch.isfinite(ps)
    scale = ps[finite].abs().max().item() if finite.any() else 0.0
    err = (ks - ps)[finite].abs().max().item() if finite.any() else 0.0
    ref = r_op[:q.shape[1], :n].T.contiguous()
    k_idx, _ = _refine(q, ref, (ki, ks), n, cutoff=cutoff)
    p_idx, _ = _refine(q, ref, (pi, ps), n, cutoff=cutoff)
    same = bool((k_idx == p_idx).all())
    log(f"  {name}: m={q.shape[0]} k={q.shape[1]} n={n} P={parts}: index agreement "
        f"{share:.6f}, max |score diff| {err:.3g} (max |score| {scale:.3g}), "
        f"refined 1-NN identical: {same}")
    if share < MIN_INDEX_AGREEMENT:
        fail(f"{name}: candidate indices agree on {share:.6f} < {MIN_INDEX_AGREEMENT}")
    if err > rtol * max(scale, 1e-30):
        fail(f"{name}: score difference {err} > {rtol} x {scale}")
    if not same:
        fail(f"{name}: refined 1-NN indices differ")
    if q.is_cuda:
        torch.cuda.synchronize(q.device)
    return err


def slot_agreement(name, ki, ks, pi, ps, rtol=SCORE_RTOL):
    """Share of candidate slots whose indices agree, and the largest score
    difference on those slots; fails below MIN_INDEX_AGREEMENT or above
    rtol of the largest |score|."""
    import torch

    agree = ki == pi
    share = agree.float().mean().item()
    finite = agree & torch.isfinite(ps) & torch.isfinite(ks)
    scale = ps[finite].abs().max().item() if finite.any() else 0.0
    err = (ks - ps)[finite].abs().max().item() if finite.any() else 0.0
    if share < MIN_INDEX_AGREEMENT:
        fail(f"{name}: candidate indices agree on {share:.6f} < {MIN_INDEX_AGREEMENT}")
    if err > rtol * max(scale, 1e-30):
        fail(f"{name}: score difference {err} > {rtol} x {scale}")
    return share, err, scale


def same_topk(name, got, want):
    """Two top-K answers (idx, d2) must be identical; a rank where they
    differ is tolerated only where the two points' exact distances agree
    to f32 rounding (a near-tie that the two score orders resolve apart).
    Returns the number of such ranks."""
    import torch

    gi, gd = got
    wi, wd = want
    if torch.equal(gi, wi):
        return 0
    bad = gi != wi
    scale = max(wd[torch.isfinite(wd)].abs().max().item(), 1e-30)
    if ((gi < 0) | (wi < 0))[bad].any() or ((gd - wd).abs()[bad] > SCORE_RTOL * scale).any():
        fail(f"{name}: top-K differs from the plain version's at {int(bad.sum())} ranks")
    return int(bad.sum())


def launched_twice(name, kernel, *args):
    """Two launches of a top-K kernel on the same inputs must give the
    same outputs (no order in which a list's queue filled may show)."""
    import torch

    a, b = kernel(*args), kernel(*args)
    if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
        fail(f"{name}: two launches on the same inputs differ")
    return a


def check_lists(name, ci, cs, n, parts, kk, seed=None):
    """The top-K kernels' list contract (csrc kselect.cuh, topk.list_of):
    each real column lies in its partition's list, each list ascends by
    (score, column), the slots left over hold (+inf, I32_MAX), or
    (seed[row], I32_MAX) for B6. Returns the (m, parts*kk) mask of real
    entries."""
    import torch

    from tpu_knn_torch.kernels import topk

    m = ci.shape[0]
    li, ls = ci.view(m, parts, kk), cs.view(m, parts, kk)
    real = li < n
    lists = torch.arange(parts, device=ci.device).view(1, parts, 1).expand_as(li)
    key = topk._lex_key(ls, li)
    fill = (torch.full_like(ls, torch.inf) if seed is None
            else seed.view(m, 1, 1).expand_as(ls))
    if not ((topk.list_of(li.long(), n, parts)[real] == lists[real]).all()
            and (key[..., 1:] >= key[..., :-1]).all()
            and (li[~real] == 2**31 - 1).all() and (ls[~real] == fill[~real]).all()):
        fail(f"{name}: the lists break the list contract (m={m}, n={n}, P={parts}, K={kk})")
    return real.view(m, parts * kk)


def list_agreement(name, ki, ks, pi, s, rtol):
    """B5's lists against its plain version's, slot by slot, on the plain
    scores s (m, n): where the columns differ, both must be real and their
    scores a near-tie (within rtol of the largest |score|, which two f32
    summation orders can resolve apart); the kernel's scores lie within
    that of the plain scores of its columns. Returns (share of agreeing
    slots, largest |score difference|, disagreeing slots)."""
    import torch

    n = s.shape[1]
    agree = ki == pi
    real_k, real_p = ki < n, pi < n
    scale = max(s[torch.isfinite(s)].abs().max().item(), 1e-30)
    s_k = s.gather(1, torch.where(real_k, ki, 0).long())
    s_p = s.gather(1, torch.where(real_p, pi, 0).long())
    tie = real_k & real_p & ((s_k - s_p).abs() <= rtol * scale)
    if (~agree & ~tie).any():
        fail(f"{name}: {int((~agree & ~tie).sum())} list slots differ from the plain "
             f"version's without a near-tie")
    err = (ks - s_k)[real_k].abs().max().item() if real_k.any() else 0.0
    if err > rtol * scale:
        fail(f"{name}: score difference {err} > {rtol} x {scale}")
    return agree.float().mean().item(), err, int((~agree).sum())


def phase1_topk(device, gen, b4_cases, b5_cases, b6_cases):
    """B4, B5 and B6 against their plain versions (and B4 against B1)."""
    import torch

    from tpu_knn_torch.kernels import fused, smallm, topk
    from tpu_knn_torch.kernels.fused import prep_soa
    from tpu_knn_torch.utils.shapes import round_up

    errs = {"B4": 0.0, "B5": 0.0, "B6": 0.0}
    for k, m, n, parts, *ld in b4_cases:
        q = uniform(gen, (m, k), device)
        r_op = case_operand(gen, device, k, n, *ld)
        parts = parts or fused.tiled_parts(m, k, n)
        plant_duplicates(q, r_op, n, parts)
        plant_lane_ties(q, r_op, n, parts)
        lo_s = torch.full((m,), -torch.inf, device=device)
        lo_i = torch.full((m,), -1, dtype=torch.int32, device=device)
        bi, bs = fused.banded_candidates(q, r_op, n, parts, lo_s, lo_i)
        fi, fs = fused.fused_candidates(q, r_op, n, parts)
        if not (torch.equal(bi, fi) and torch.equal(bs, fs)):
            fail(f"B4 m={m} k={k} n={n} P={parts}: scores are not bit-equal to B1's")
        i1, s1 = topk._lex_min(bi, bs)
        ki, ks = fused.banded_candidates(q, r_op, n, parts, s1, i1)
        i2, s2 = topk._lex_min(ki, ks)
        if (i2 == i1).any() or not ((s2 > s1) | ((s2 == s1) & (i2 > i1))).all():
            fail(f"B4 m={m} k={k} n={n} P={parts}: the bound did not mask exactly")
        p1_i, p1_s = topk._lex_min(*fused.banded_candidates_plain(q, r_op, n, parts,
                                                                  lo_s, lo_i))
        pi, ps = fused.banded_candidates_plain(q, r_op, n, parts, p1_s, p1_i)
        share, err, scale = slot_agreement("B4", ki, ks, pi, ps, score_rtol(k))
        errs["B4"] = max(errs["B4"], err)
        log(f"  B4: m={m} k={k} n={n} ld={r_op.shape[1]} P={parts}: bit-equal to B1, "
            f"bound masks exactly; "
            f"pass-2 index agreement {share:.6f}, max |score diff| {err:.3g} "
            f"(max |score| {scale:.3g})")
    for k, m, n, kk, parts in b5_cases:
        q = uniform(gen, (m, k), device)
        r = uniform(gen, (n, k), device)
        r_op = prep_soa(r, round_up(n, 128))
        parts = parts or topk.sweep_parts(m, k, n)
        plant_duplicates(q, r_op, n, parts)
        r = r_op[:k, :n].T.contiguous()
        ki, ks = launched_twice("B5", topk.sweep_candidates, q, r_op, n, parts, kk)
        pi, ps = topk.sweep_candidates_plain(q, r_op, n, parts, kk)
        check_lists("B5", ki, ks, n, parts, kk)
        share, err, swaps = list_agreement("B5", ki, ks, pi, fused.norm_scores(q, r_op, n),
                                           score_rtol(k))
        errs["B5"] = max(errs["B5"], err)
        got = topk._finalize_topk(q, r, ki, ks, kk, n)
        near = same_topk("B5", got, topk._finalize_topk(q, r, pi, ps, kk, n))
        passes = topk._build_topk(m, n, k, kk, r_op.shape[1], "passes")(q, (r_op,), r)
        if not (torch.equal(got[0], passes[0]) and torch.equal(got[1], passes[1])):
            fail(f"B5 m={m} k={k} n={n} K={kk}: sweep and passes disagree on the card")
        log(f"  B5: m={m} k={k} n={n} K={kk} P={parts}: two launches identical, lists sorted "
            f"in their partitions; slot agreement {share:.6f} ({swaps} near-tie slots), max "
            f"|score diff| {err:.3g}; top-K identical to plain (near-tie ranks {near}) and to "
            f"the passes engine")
    for k, m, n, kk, parts in b6_cases:
        q = uniform(gen, (m, k), device)
        r = uniform(gen, (n, k), device)
        r_op = prep_soa(r, round_up(n, 128))
        parts = parts or topk.smallm_topk_parts(n, k)
        plant_duplicates(q, r_op, n, parts)
        r = r_op[:k, :n].T.contiguous()
        p1 = smallm.default_parts(n)

        def bound_of(b2):
            _, cs1 = b2(q, r_op, n, p1)
            return torch.topk(cs1, kk, dim=-1, largest=False).values[:, -1].contiguous()

        b_k, b_p = bound_of(smallm.smallm_candidates), bound_of(smallm.smallm_candidates_plain)
        ki, ks = launched_twice("B6", topk.smallm_topk_candidates, q, r_op, n, parts, kk, b_k)
        pi, ps = topk.smallm_topk_candidates_plain(q, r_op, n, parts, kk, b_p)
        real = check_lists("B6", ki, ks, n, parts, kk, seed=b_k)
        if not ((ks <= b_k[:, None]) | ~real).all():
            fail(f"B6 m={m} k={k} n={n} K={kk}: an entry above the bound")
        least = int(real.sum(dim=1).min())
        if least < kk:
            fail(f"B6 m={m} k={k} n={n} K={kk}: a row holds {least} real entries, fewer than K")
        agree = (ki == pi) & real
        err = (ks - ps)[agree].abs().max().item() if agree.any() else 0.0
        errs["B6"] = max(errs["B6"], err)
        near = same_topk("B6", topk._finalize_topk(q, r, ki, ks, kk, n),
                         topk._finalize_topk(q, r, pi, ps, kk, n))
        log(f"  B6: m={m} k={k} n={n} K={kk} P={parts}: two launches identical, "
            f"{int(real.sum())} real entries under the bound (at least {least} a row), lists "
            f"sorted in their partitions; top-K identical to plain (near-tie ranks {near}), "
            f"max |score diff| {err:.3g}")
    torch.cuda.synchronize(device)
    return errs


def phase1_passes_launches(device, gen, shapes):
    """B4 at every launch of the passes engine at each (k, m, n, K) of
    `shapes`, on data of its own: topk.banded_candidates is wrapped for the
    call, and each launch's candidates are held against the plain version's
    same pass at the engine's tier (auto_precision: the tier instance of
    B4), seeded as the kernel's is with its own previous pass (the two
    score the bound's own element in different last bits, so the plain
    version on the kernel's bound could readmit it). Returns {kernel row:
    the largest |score difference| on agreeing slots}."""
    import torch

    from tpu_knn_torch.kernels import fused, tiers, topk

    real = topk.banded_candidates

    def checked(q, r_op, n, parts, b_s, b_i, q_t=None, precision="highest"):
        ki, ks = real(q, r_op, n, parts, b_s, b_i, q_t, precision)
        if checked.bound is None:
            checked.bound = (torch.full_like(b_s, -torch.inf), torch.full_like(b_i, -1))
        pi, ps = fused.banded_candidates_plain(q, r_op, n, parts, *checked.bound, precision)
        checked.bound = topk._lex_min(pi, ps)[::-1]
        rtol = SeededLaunchCheck.rtol(q, precision)
        share, e, _ = slot_agreement("B4 (passes launch)", ki, ks, pi, ps, rtol)
        checked.worst = min(checked.worst, share)
        checked.err = max(checked.err, e)
        checked.calls += 1
        checked.row = ("B4" if precision == "highest"
                       else tiers.topk_tier_row("B4", r_op, precision, q.shape[1]))
        return ki, ks

    errs = {}
    for k, m, n, kk in shapes:
        q, r = uniform(gen, (m, k), device), uniform(gen, (n, k), device)
        checked.worst, checked.err, checked.calls, checked.bound = 1.0, 0.0, 0, None
        topk.banded_candidates = checked
        try:
            got = topk.topk_knn(q, r, kk, method="passes")
        finally:
            topk.banded_candidates = real
        if checked.calls != kk:
            fail(f"B4: the passes engine at (k={k}, m={m}, n={n}) K={kk} made "
                 f"{checked.calls} launches, not {kk}")
        errors = topk_gate_errors(q, r, got[0], kk)
        if errors:
            fail(f"B4: the passes engine at (k={k}, m={m}, n={n}) K={kk}: {errors} errors")
        errs[checked.row] = max(errs.get(checked.row, 0.0), checked.err)
        log(f"  {checked.row} at the passes engine's {kk} launches (k={k}, m={m}, n={n}): "
            f"least slot agreement with the plain passes {checked.worst:.6f}, max |score "
            f"diff| {checked.err:.3g}; the answer has 0 errors")
        del q, r
    return errs


def phase1(device, gen, b1_cases, b2_cases):
    from tpu_knn_torch.kernels import fused, smallm
    from tpu_knn_torch.kernels.fused import prep_soa, select_cutoff
    from tpu_knn_torch.utils.shapes import round_up

    errs = {"B1": 0.0, "B2": 0.0}
    for k, m, n, parts, *ld in b1_cases:
        q = uniform(gen, (m, k), device)
        r_op = case_operand(gen, device, k, n, *ld)
        parts = parts or fused.tiled_parts(m, k, n)
        plant_duplicates(q, r_op, n, parts)
        plant_lane_ties(q, r_op, n, parts)
        errs["B1"] = max(errs["B1"], compare_candidates(
            f"B1 (ld={r_op.shape[1]})", fused.fused_candidates, fused.fused_candidates_plain,
            q, r_op, n, parts, select_cutoff("highest", k), score_rtol(k)))
    for k, m, n, parts in b2_cases:
        q = uniform(gen, (m, k), device)
        r_op = prep_soa(uniform(gen, (n, k), device), round_up(n, 128))
        parts = parts or smallm.default_parts(n)
        plant_duplicates(q, r_op, n, parts)
        errs["B2"] = max(errs["B2"], compare_candidates(
            "B2", smallm.smallm_candidates, smallm.smallm_candidates_plain,
            q, r_op, n, parts, select_cutoff("exact", k)))
    return errs


# ---- phase 2: main path --------------------------------------------------


def exact_scan(q, r, chunk_elems=1 << 28):
    """Independent exact 1-NN on the card: chunked diff-form scan, v0's
    lowest-index tie rule (strict `<` across chunks, lowest index within)."""
    import torch

    m, k = q.shape
    n = r.shape[0]
    chunk = max(1, chunk_elems // (m * k))
    best_d = torch.full((m,), torch.inf, device=q.device)
    best_i = torch.zeros((m,), dtype=torch.int64, device=q.device)
    for start in range(0, n, chunk):
        rc = r[start:start + chunk]
        d = ((q[:, None, :] - rc[None, :, :]) ** 2).sum(dim=-1)
        v = d.min(dim=1).values
        col = torch.arange(rc.shape[0], device=q.device)
        i = torch.where(d == v[:, None], col, rc.shape[0]).min(dim=1).values + start
        take = v < best_d
        best_i = torch.where(take, i, best_i)
        best_d = torch.where(take, v, best_d)
    return best_i


def gate_errors(q, r, idx, want=None) -> int:
    """The harness rule (tpu_knn_torch.harness.checker.check_results) on
    the card: an index is right if it equals the exact scan's (``want``,
    computed here unless given), or if the two points' true distances agree
    within ±1e-3."""
    import torch

    from tpu_knn_torch.harness.checker import TOLERANCE

    idx = torch.as_tensor(idx, device=q.device).long()
    if want is None:
        want = exact_scan(q, r)

    def true_d(i):
        return ((q - r[i]) ** 2).sum(dim=1).sqrt()

    ok = (idx == want) | ((true_d(idx) - true_d(want)).abs() <= TOLERANCE)
    return int((~ok).sum().item())


def read_golden():
    import numpy as np

    with open(GOLDEN) as f:
        lines = [ln.strip().rstrip(",") for ln in f if ln.strip()]
    return [np.array([int(x) for x in lines[2 * i].split(",")])
            for i in range(len(lines) // 2)]


def phase2_ta(device):
    """The 8 TA shapes through knn_callback: exact golden indices and
    0 errors under the harness rule, for v7 (default) and v4 (v0, the host
    oracle, meets the golden file in the ladder path's runner)."""
    import numpy as np

    import tpu_knn_torch
    from tpu_knn_torch.harness.checker import check_results
    from tpu_knn_torch.harness.generator import ta_sample_stream

    golden = read_golden()
    for ((k, m, n), search, ref), gold in zip(ta_sample_stream(), golden):
        for version in (None, "v4"):
            idx = tpu_knn_torch.knn_callback(k, m, n, search, ref,
                                             version=version, device=device)
            errors, total = check_results(gold, idx, search, ref)
            exact = bool(np.array_equal(idx, gold))
            log(f"  TA {(k, m, n)} {version or 'default'}: golden indices "
                f"exact={exact}, errors {errors}/{total}")
            if not exact or errors:
                fail(f"TA {(k, m, n)} version {version}: exact={exact}, errors={errors}")


def phase2_big(device, gen, ds11, ds9):
    import torch

    import tpu_knn_torch
    from tpu_knn_torch.kernels.fused import fused_knn

    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    k, m, n = ds11
    q, r = uniform(gen, (m, k), device), uniform(gen, (n, k), device)
    checks = [
        ("ds11 per-call fused_knn (v4)", lambda: fused_knn(q, r)[0]),
        ("ds11 per-call fused_knn precision='highest' (B1)",
         lambda: fused_knn(q, r, precision="highest")[0]),
        ("ds11 per-call knn_callback default (v7)",
         lambda: tpu_knn_torch.knn_callback(k, m, n, q, r)),
    ]
    index11 = tpu_knn_torch.NNIndex(r, strategy="fused")
    checks.append(("ds11 NNIndex(fused).query", lambda: index11.query(q)[0]))
    for name, fn in checks:
        errors = gate_errors(q, r, fn())
        sync()
        log(f"  {name}: errors {errors}/{m}")
        if errors:
            fail(f"{name}: {errors} errors")
    k9, m9, n9 = ds9
    q9, r9 = uniform(gen, (m9, k9), device), uniform(gen, (n9, k9), device)
    index9 = tpu_knn_torch.NNIndex(r9, strategy="fused")
    for name, fn in (("ds9 NNIndex(fused).query (B2)", lambda: index9.query(q9)[0]),
                     ("ds9 per-call fused_knn (AoS scan)", lambda: fused_knn(q9, r9)[0]),
                     ("ds9 per-call knn_callback default (v7)",
                      lambda: tpu_knn_torch.knn_callback(k9, m9, n9, q9, r9))):
        errors = gate_errors(q9, r9, fn())
        sync()
        log(f"  {name}: errors {errors}/{m9}")
        if errors:
            fail(f"{name}: {errors} errors")
    return (q, r, index11), (q9, r9, index9)


def exact_topk_scan(q, r, kk, chunk_elems=1 << 28):
    """Independent exact top-K on the card: a chunked diff-form scan that
    keeps each row's kk lexicographically smallest (d2, index), merged
    chunk by chunk with two stable sorts. Returns (idx (m, kk) int64,
    d2 (m, kk) f32)."""
    import torch

    m, k = q.shape
    n = r.shape[0]
    chunk = max(kk, chunk_elems // (m * k))
    best_d = torch.empty((m, 0), device=q.device)
    best_i = torch.empty((m, 0), dtype=torch.int64, device=q.device)
    for start in range(0, n, chunk):
        rc = r[start:start + chunk]
        d = ((q[:, None, :] - rc[None, :, :]) ** 2).sum(dim=-1)
        v, i = torch.topk(d, min(kk, rc.shape[0]), dim=1, largest=False)
        d = torch.cat([best_d, v], dim=1)
        i = torch.cat([best_i, i + start], dim=1)
        o = torch.sort(i, dim=1, stable=True).indices
        d, i = d.gather(1, o), i.gather(1, o)
        o = torch.sort(d, dim=1, stable=True).indices[:, :kk]
        best_d, best_i = d.gather(1, o), i.gather(1, o)
    return best_i, best_d


def topk_gate_errors(q, r, idx, kk) -> int:
    """The harness rule extended to K: rank by rank, an index is right if
    it equals the exact scan's, or if the two points' true distances
    agree within ±1e-3."""
    import torch

    from tpu_knn_torch.harness.checker import TOLERANCE

    idx = torch.as_tensor(idx, device=q.device).long()
    want, _ = exact_topk_scan(q, r, kk)
    if idx.shape != want.shape:
        fail(f"top-K shape {tuple(idx.shape)}, expected {tuple(want.shape)}")
    valid = (idx >= 0) & (idx < r.shape[0])
    safe = torch.where(valid, idx, 0)

    def true_d(i):
        return ((q[:, None, :] - r[i]) ** 2).sum(dim=-1).sqrt()

    ok = valid & ((idx == want) | ((true_d(safe) - true_d(want)).abs() <= TOLERANCE))
    return int((~ok).sum().item())


def phase2_topk(device, gen, n_mid=1 << 20, n_big=1 << 24):
    """The top-K main path at the reference's published widths, each call
    checked against exact_topk_scan. Returns the calls, for phase 3."""
    import torch

    import tpu_knn_torch
    from tpu_knn_torch.kernels.topk import topk_knn, within_radius_complete

    def data(k, m, n):
        return uniform(gen, (m, k), device), uniform(gen, (n, k), device)

    q8, r20 = data(16, 8, n_mid)
    q32 = uniform(gen, (32, 16), device)
    q1024 = uniform(gen, (DS11[1], 16), device)
    q64 = uniform(gen, (64, 16), device)
    q3 = uniform(gen, (3, 16), device)
    q4, r24 = data(16, 4, n_big)
    index24 = tpu_knn_torch.NNIndex(r24, strategy="fused")
    calls = {
        "topk_knn (16, 8, 2^20) K=32 [B5]": (q8, r20, 32, lambda: topk_knn(q8, r20, 32)),
        "topk_knn (16, 32, 2^20) K=8 [B5]": (q32, r20, 8, lambda: topk_knn(q32, r20, 8)),
        "NNIndex.query (16, 4, 2^24) K=16 [B2+B6]":
            (q4, r24, 16, lambda: index24.query(q4, neighbors=16)),
        "NNIndex.query (16, 1, 2^24) K=16 [aos]":
            (q4[:1], r24, 16, lambda: index24.query(q4[:1], neighbors=16)),
        "topk_knn passes ds11 (16, 1024, 2^20) K=8 [B4]":
            (q1024, r20, 8, lambda: topk_knn(q1024, r20, 8, method="passes")),
        "topk_knn passes (16, 64, 2^20) K=64 [B4]":
            (q64, r20, 64, lambda: topk_knn(q64, r20, 64, method="passes")),
        "nearest_neighbors (16, 3, 2^20) neighbors=8 [B2+B6]":
            (q3, r20, 8, lambda: (tpu_knn_torch.nearest_neighbors(q3, r20, neighbors=8),)),
    }
    for name, (q, r, kk, fn) in calls.items():
        errors = topk_gate_errors(q, r, fn()[0], kk)
        torch.cuda.synchronize(device)
        log(f"  {name}: errors {errors}/{q.shape[0] * kk}")
        if errors:
            fail(f"{name}: {errors} errors")
    # One radius escalation at m = 2 (the aos engine): 48 points planted
    # near query 0, more than the start cap of 32, so the cap goes 32 -> 64.
    q2, r2 = q3[:2].contiguous(), r20.clone()
    noise = uniform(gen, (48, 16), device) - 0.5
    r2[1000:1048] = q2[0] + 0.01 * noise
    radius = 0.1
    idx, d2, count = within_radius_complete(q2, r2, radius)
    want_i, want_d = exact_topk_scan(q2, r2, idx.shape[1])
    true_count = (want_d <= radius ** 2).sum(dim=1)
    inside = want_i.masked_fill(want_d > radius ** 2, -1)
    if idx.shape[1] != 64 or not torch.equal(count.long(), true_count) \
            or not torch.equal(idx.long(), inside):
        fail(f"within_radius_complete: cap {idx.shape[1]}, counts {count.tolist()} "
             f"against {true_count.tolist()}")
    log(f"  within_radius_complete m=2 (aos, caps 32 -> 64): counts {count.tolist()}, "
        "identical to the exact scan")
    calls["within_radius_complete m=2 (aos, caps 32 -> 64)"] = (
        q2, r2, None, lambda: within_radius_complete(q2, r2, radius))
    ctx = {"q1024": q1024, "q8": q8, "q32": q32, "q4": q4, "q64": q64, "r20": r20,
           "r24": r24, "index24": index24}
    return calls, ctx


# ---- the seeded engine: phase 1 (B3, B7, compactor) and phase 2 -----------


def plain_scores(q, r_op, n):
    """The plain versions' scores of the first n columns, (m, n)."""
    import torch

    from tpu_knn_torch.kernels.fused import score_chunks

    return torch.cat([s for _, s in score_chunks(q, r_op, n)], dim=1)


def bound_between(s, lo_rank, hi_rank):
    """Per row, the midpoint of the widest gap between consecutive sorted
    scores of ranks lo_rank..hi_rank: no score lies near it, so the last-bit
    differences between the kernel's and the plain version's scores cannot
    move an element across it, and their packed words must be identical."""
    import torch

    srt = torch.topk(s, hi_rank + 1, dim=1, largest=False).values
    j = (srt[:, lo_rank + 1:] - srt[:, lo_rank:-1]).argmax(dim=1, keepdim=True) + lo_rank
    return ((srt.gather(1, j) + srt.gather(1, j + 1)) / 2).squeeze(1).contiguous()


def misaligned(r_op, offset: int = 1):
    """A contiguous copy of r_op whose data start `offset` floats into its
    storage: not 16-byte aligned, so the tiled kernels take their 4-byte
    copies."""
    import torch

    flat = torch.zeros(r_op.numel() + offset, dtype=r_op.dtype, device=r_op.device)
    out = flat[offset:].view(r_op.shape)
    out.copy_(r_op)
    return out


def phase1_seeded(device, gen, b3_cases, b7_cases, compact_cases, with_q_t=False):
    """B3, B7 and the B8/B9 compactor against their plain versions. A B7
    case may carry an 8th field, an operand offset in floats (misaligned).
    with_q_t: each B3 and B7 launch is also made with the queries'
    transposed copy passed in, as the seeded engine passes it, and must
    give the same outputs."""
    import torch

    from tpu_knn_torch.kernels import fused, seeded
    from tpu_knn_torch.kernels.fused import prep_soa

    errs = {"B3": 0.0, "B7": 0.0, "B8/B9": 0.0}
    for k, m, n, n_ops, depth, banded, n_limit in b3_cases:
        q = uniform(gen, (m, k), device)
        r_op = prep_soa(uniform(gen, (n, k), device), n_ops)
        lo = bound_between(plain_scores(q, r_op, n), 3, 40) if banded else None
        got = fused.minima_candidates(q, r_op, n, depth=depth, lo=lo, n_limit=n_limit)
        if with_q_t and not torch.equal(got, fused.minima_candidates(
                q, r_op, n, depth=depth, lo=lo, n_limit=n_limit,
                q_t=fused.transposed_queries(q))):
            fail(f"B3 {(k, m, n, depth, banded, n_limit)}: differs with q_t passed in")
        want = fused.minima_candidates_plain(q, r_op, n, depth, lo, n_limit)
        fin = torch.isfinite(want)
        if not torch.equal(fin, torch.isfinite(got)):
            fail(f"B3 {(k, m, n, depth, banded, n_limit)}: finite lanes differ from plain")
        scale = want[fin].abs().max().item()
        err = (got - want)[fin].abs().max().item()
        if err > SCORE_RTOL * scale:
            fail(f"B3 {(k, m, n, depth, banded, n_limit)}: |diff| {err} > {SCORE_RTOL} x {scale}")
        errs["B3"] = max(errs["B3"], err)
        b1_equal = None
        if not banded:   # both kernels score through column_scores
            n_eff = n if n_limit is None else min(n, n_limit)
            b1_equal = torch.equal(got[:, :128], fused.fused_candidates(q, r_op, n_eff, 1)[1])
            if not b1_equal:
                fail(f"B3 {(k, m, n, depth, n_limit)}: lane minima not bit-equal to B1's")
        log(f"  B3: k={k} m={m} n={n} n_ops={n_ops} depth={depth} banded={banded} "
            f"n_limit={n_limit}: max |diff| to plain {err:.3g} (max |score| {scale:.3g}), "
            f"bit-equal to B1: {b1_equal}")
        del r_op
    for k, m, n, n_ops, cell, nf, banded, *offset in b7_cases:
        q = uniform(gen, (m, k), device)
        r_op = prep_soa(uniform(gen, (n, k), device), n_ops)
        if offset:
            r_op = misaligned(r_op, *offset)
        s = plain_scores(q, r_op, n)
        bound = bound_between(s, 60, 200)
        lo = bound_between(s, 5, 40) if banded else None
        del s
        got = seeded.extract_moments(q, r_op, n, bound, cell, nf, lo=lo, emit_rem=banded)
        if with_q_t and not all(torch.equal(a, b) for a, b in zip(got, seeded.extract_moments(
                q, r_op, n, bound, cell, nf, lo=lo, emit_rem=banded,
                q_t=fused.transposed_queries(q)))):
            fail(f"B7 {(k, m, n, n_ops, cell, nf, banded)}: differs with q_t passed in")
        want = seeded.extract_moments_plain(q, r_op, n, bound, cell, nf, lo, banded)
        for g, w in zip(got[:1 + (nf == 8)], want):
            if not torch.equal(g, w):
                fail(f"B7 {(k, m, n, n_ops, cell, nf, banded)}: packed words differ "
                     f"at {int((g != w).sum())} cells")
        rem_err = 0.0
        if banded:
            fin = torch.isfinite(want[-1])
            rem_err = (got[-1] - want[-1])[fin].abs().max().item()
            if not torch.equal(fin, torch.isfinite(got[-1])) or \
                    rem_err > SCORE_RTOL * want[-1][fin].abs().max().item():
                fail(f"B7 {(k, m, n, cell, nf)}: remainder minima differ ({rem_err})")
        errs["B7"] = max(errs["B7"], rem_err)
        log(f"  B7: k={k} m={m} n={n} n_ops={n_ops} cell={cell} fields={nf} "
            f"banded={banded}{' misaligned' if offset else ''}: packed words identical "
            f"({int((got[0] != 0).sum())} "
            f"qualifying cells, {int(((got[0] >> 30) & 1).sum())} flagged)"
            + (f", remainder minima max |diff| {rem_err:.3g}" if banded else ""))
        del r_op
    for m, nc, parts, cap, nf, density, *offset in compact_cases:
        qual = torch.rand((m, nc), generator=gen, device=device) < density
        fields = [torch.where(qual, torch.randint(1, 1 << 30, (m, nc), generator=gen,
                                                  device=device, dtype=torch.int32), 0)
                  for _ in range(nf)]
        fields[1:] = [torch.where(qual, f - 1, 0) for f in fields[1:]]
        if offset:
            fields = [misaligned(f, *offset) for f in fields]
        want = seeded.compact_cells_plain(fields, parts, cap)
        for _ in range(2):
            got = seeded.compact_cells(fields, parts, cap)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                fail(f"compactor {(m, nc, parts, cap, nf, density, *offset)}: differs from plain")
        regime = "B9" if nc // parts <= 8192 else "B8"
        pw = nc // parts
        loads = "int4" if nc % 4 == 0 and pw % 4 == 0 and not offset else "cell-by-cell"
        log(f"  B8/B9 compactor: m={m} nc={nc} parts={parts} (part width {pw}, {regime}'s "
            f"regime) cap={cap} fields={nf} density={density} ({loads} loads): identical to "
            "plain, twice")
    torch.cuda.synchronize(device)
    return errs


def phase1_own_minima(device, gen, kks=(8, 64)):
    """The seeded engine's invariant on the card, at its ds11 launches for
    each K in kks: with the bound set to each row's K-th smallest of B3's
    own lane minima, not inflated, B7 counts at least K qualifiers in
    every row (the K lanes' minima are K distinct columns scoring <= the
    bound, so this holds only if B7 scores each of them bit for bit as B3
    did). Counted as the engine counts: a cell's min(cnt, 3), or solvable
    + 1 where its overflow bit is set."""
    import torch

    from tpu_knn_torch.kernels import fused, seeded
    from tpu_knn_torch.kernels.fused import prep_soa

    k, m, n = DS11
    q = uniform(gen, (m, k), device)
    r_op = prep_soa(uniform(gen, (n, k), device), n)
    q_t = fused.transposed_queries(q)
    for kk in kks:
        g = seeded.seeded_geometry(m, n, k, kk, n)
        cs1 = fused.minima_candidates(q, r_op, n, depth=g["depth"], n_limit=g["p1_limit"],
                                      q_t=q_t)
        bound = seeded._kth_smallest(cs1, kk)
        a = seeded.extract_moments(q, r_op, n, bound, g["cell"], g["n_fields"], q_t=q_t)[0]
        solvable = g["solvable"]
        counted = torch.where(((a >> 30) & 1) != 0, solvable + 1,
                              torch.clamp(a & 3, max=solvable)).sum(dim=1)
        short = int((counted < kk).sum())
        log(f"  B3 -> B7 at ds11 K={kk} (cell {g['cell']}, {g['n_fields']} fields, B3 prefix "
            f"{g['p1_limit']}): bound = each row's uninflated K-th B3 lane minimum; B7 counts "
            f">= {counted.min().item()} (median {counted.median().item()}) qualifiers a row, "
            f"{short} rows under K")
        if short:
            fail(f"B7 at B3's own K={kk} bound counts fewer than K qualifiers in {short} rows")
    del r_op


def seeded_tiers():
    from tpu_knn_torch.kernels import seeded

    return dict(seeded.TIERS)


def tier_delta(before):
    return {k: v - before[k] for k, v in seeded_tiers().items() if v != before[k]}


def graph_gate_errors(points, idx, rows, kk) -> int:
    """knn_graph rows `rows` against the exact top-(K+1) scan with each
    row's own index removed (or the last entry, where it is absent), by
    the harness's ±1e-3 rule; and no row may hold its own index."""
    import torch

    from tpu_knn_torch.harness.checker import TOLERANCE

    q = points[rows]
    want_i, _ = exact_topk_scan(q, points, kk + 1)
    own = want_i == rows[:, None]
    drop = torch.where(own.any(dim=1), own.int().argmax(dim=1), kk)
    pos = torch.arange(kk + 1, device=points.device)[None]
    keep = pos != drop[:, None]
    want = want_i[keep].view(-1, kk)
    got = idx[rows].long()
    if (got == rows[:, None]).any():
        fail("knn_graph: a row holds its own index")

    def true_d(i):
        return ((q[:, None, :] - points[i]) ** 2).sum(dim=-1).sqrt()

    ok = (got == want) | ((true_d(got) - true_d(want)).abs() <= TOLERANCE)
    return int((~ok).sum().item())


class SeededLaunchCheck:
    """While active (a `with` block), every B3, B7 and compactor launch
    the seeded engine makes, through the wrappers it calls by
    kernels/seeded.py's globals, is held against its plain version on the
    same inputs; the engine goes on with the kernel's outputs, so a call
    under the check makes exactly the launches it makes on the main path.
    B3: lane minima within SCORE_RTOL. B7: packed words identical, except
    at a cell holding a column whose score lies within the score
    tolerance of the bound or lo (the two score orders may put such a
    column on either side; these cells are counted); the remainder minima
    alike, except at a lane whose minimum sits at the bound. The
    compactor: identical outputs."""

    WRAPPERS = ("minima_candidates", "extract_moments", "compact_cells")

    def __enter__(self):
        from collections import Counter

        from tpu_knn_torch.kernels import seeded

        self.mod = seeded
        self.orig = {name: getattr(seeded, name) for name in self.WRAPPERS}
        self.shapes = {"B3": Counter(), "B7": Counter(), "B8/B9": Counter()}
        self.err = {"B3": 0.0, "B7": 0.0}
        self.edge_cells = 0

        def spy(check):
            def wrapper(*args, **kwargs):
                return check(*args, **kwargs)

            # A wrapper counts its launches under its module-global name,
            # which is the spy's while the check is active.
            wrapper.launches = 0
            return wrapper

        seeded.minima_candidates = spy(self.b3)
        seeded.extract_moments = spy(self.b7)
        seeded.compact_cells = spy(self.compact)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.mod, name, fn)
        return False

    @staticmethod
    def rtol(q, precision):
        """The relative score difference a kernel may show against its
        plain version: SCORE_RTOL on the CUDA cores ("highest"), twice the
        tier's bound at a term-list tier (both sides within it of f64)."""
        from tpu_knn_torch.kernels import tiers

        if precision == "highest":
            return SCORE_RTOL
        return max(SCORE_RTOL, 2.0 * tiers.tier_error_bound(precision, q.shape[1]))

    def b3(self, q, r_op, n, depth=1, lo=None, n_limit=None, q_t=None, precision="highest"):
        import torch

        from tpu_knn_torch.kernels.fused import minima_candidates_plain

        got = self.orig["minima_candidates"](q, r_op, n, depth=depth, lo=lo, n_limit=n_limit,
                                             q_t=q_t, precision=precision)
        want = minima_candidates_plain(q, r_op, n, depth, lo, n_limit, precision)
        fin = torch.isfinite(want)
        what = f"B3 (m={q.shape[0]}, n={n}, depth {depth}, prefix {n_limit}, {precision})"
        if not torch.equal(fin, torch.isfinite(got)):
            fail(f"{what}: finite lanes differ from plain")
        scale = want[fin].abs().max().item()
        err = (got - want)[fin].abs().max().item()
        rtol = self.rtol(q, precision)
        if err > rtol * scale:
            fail(f"{what}: |diff| {err} > {rtol} x {scale}")
        self.err["B3"] = max(self.err["B3"], err)
        self.shapes["B3"][f"depth {depth} prefix {n_limit}" + (" band" if lo is not None
                                                               else "")] += 1
        return got

    def b7(self, q, r_op, n, bound, cell, n_fields, lo=None, emit_rem=False, q_t=None,
           precision="highest"):
        import torch

        got = self.orig["extract_moments"](q, r_op, n, bound, cell, n_fields, lo=lo,
                                           emit_rem=emit_rem, q_t=q_t, precision=precision)
        want = self.mod.extract_moments_plain(q, r_op, n, bound, cell, n_fields, lo,
                                              emit_rem, precision)
        what = (f"B7 (m={q.shape[0]}, n={n}, n_ops={r_op.shape[1]}, cell {cell}, "
                f"{n_fields} fields, band {lo is not None}, remainder {emit_rem}, {precision})")
        edges = [bound] + ([lo] if lo is not None else [])
        finite = torch.cat([e[torch.isfinite(e)].abs() for e in edges])
        tol = self.rtol(q, precision) * max(finite.max().item() if finite.numel() else 0.0,
                                            1e-30)
        bad = torch.zeros_like(got[0], dtype=torch.bool)
        for g, w in zip(got[:1 + (n_fields == 8)], want):
            bad |= g != w
        rows, cells = bad.nonzero(as_tuple=True)
        if rows.numel() > 4 * q.shape[0]:
            fail(f"{what}: packed words differ at {rows.numel()} cells")
        if rows.numel():
            cols = cells[:, None] * cell + torch.arange(cell, device=q.device)
            r = r_op[:q.shape[1]][:, cols.clamp(max=n - 1)]          # (k, cells, cell)
            s = (r * r).sum(dim=0) - 2.0 * torch.einsum("ck,kcl->cl", q[rows], r)
            near = (s - bound[rows, None]).abs() <= tol
            if lo is not None:
                near |= (s - lo[rows, None]).abs() <= tol
            if not (near & (cols < n)).any(dim=1).all():
                fail(f"{what}: packed words differ at {rows.numel()} cells, not all "
                     f"holding a score within {tol:.3g} of the bound")
        self.edge_cells += rows.numel()
        if emit_rem:
            gr, wr = got[-1], want[-1]
            same = (gr == wr) | ((gr - wr).abs() <= tol)
            at_edge = (((wr - bound[:, None]).abs() <= tol)
                       | ((gr - bound[:, None]).abs() <= tol))
            if (~same & ~at_edge).any():
                fail(f"{what}: remainder minima differ at {int((~same & ~at_edge).sum())} "
                     "lanes")
            fin = same & torch.isfinite(wr)
            if fin.any():
                self.err["B7"] = max(self.err["B7"], (gr - wr)[fin].abs().max().item())
        self.shapes["B7"][f"cell {cell} {n_fields} fields" + (" band" if lo is not None
                                                              else "")
                          + (" rem" if emit_rem else "")] += 1
        return got

    def compact(self, fields, parts, cap):
        import torch

        got = self.orig["compact_cells"](fields, parts, cap)
        want = self.mod.compact_cells_plain(fields, parts, cap)
        m, nc = fields[0].shape
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"compactor (m={m}, nc={nc}, parts {parts}, cap {cap}, "
                 f"{len(fields)} fields): differs from plain")
        regime = "B9" if nc // parts <= 8192 else "B8"
        self.shapes["B8/B9"][f"nc {nc} = {parts} x {nc // parts} ({regime}) cap {cap} "
                             f"{len(fields)} field(s)"] += 1
        return got

    def summary(self) -> str:
        return "; ".join(f"{kid} " + ", ".join(f"{c}x [{sig}]" for sig, c in sigs.items())
                         for kid, sigs in self.shapes.items())


def phase1_seeded_main(cases):
    """B3, B7 and the compactor against their plain versions at every
    launch of the seeded main path: each of phase 2's seeded calls, on
    data of its own at the same shapes, runs once under
    SeededLaunchCheck. Returns the largest B3 and B7 differences."""
    import tpu_knn_torch
    from tpu_knn_torch.kernels.topk import within_radius_complete

    runs = {name: fn for name, (_, _, _, fn) in cases["calls"].items()}
    runs.update({name: fn for name, (_, _, _, fn, _) in cases["planted"].items()})
    q8, r_rad, radius = cases["radius"]
    runs["within_radius_complete m=8 (caps 32 -> 64)"] = \
        lambda: within_radius_complete(q8, r_rad, radius)
    pts, kg, _ = cases["graph"]
    runs["knn_graph (16, 2^17) K=15"] = lambda: tpu_knn_torch.knn_graph(pts, kg)
    errs = {"B3": 0.0, "B7": 0.0}
    edge_cells = 0
    for name, fn in runs.items():
        with SeededLaunchCheck() as check:
            fn()
        for kid, sigs in check.shapes.items():
            if not sigs:
                fail(f"{name}: no {kid} launch")
        errs = {kid: max(errs[kid], check.err[kid]) for kid in errs}
        edge_cells += check.edge_cells
        log(f"  main-path launches of {name}: {check.summary()}; every launch agrees "
            f"with its plain version (B7 words differ only at {check.edge_cells} cells "
            "holding a score at the bound)")
    log(f"  seeded main-path launches: B3 max |diff| {errs['B3']:.3g}, B7 remainder max "
        f"|diff| {errs['B7']:.3g}, {edge_cells} B7 cells at the bound")
    return errs


def seeded_cases(device, gen, q1024, r20, q64, q8, n_huge=1 << 22, n_graph=1 << 17):
    """The seeded engine's main-path calls at the reference's published
    sizes over the given data: "calls" (name -> (q, r, K, fn)), the
    planted tier cases ("planted": name -> (q, r, K, fn, tiers)), the
    radius escalation ("radius": (q, r, radius)) and knn_graph ("graph":
    (points, K, duplicate rows))."""
    import torch

    import tpu_knn_torch
    from tpu_knn_torch.kernels.topk import topk_knn

    index20 = tpu_knn_torch.NNIndex(r20, strategy="fused")
    r22 = uniform(gen, (n_huge, 16), device)
    calls = {}
    for kk, note in ((8, "quad, half-prefix B3"), (16, "quad, 3/4-prefix B3"),
                     (32, "cubic, 256-lane cells"), (64, "128-lane cells, 4 parts"),
                     (128, "single band, depth-2 B3, 64-lane cells, 8 parts"),
                     (256, "4 rounds, banded B7 + remainder")):
        calls[f"topk_knn ds11 K={kk} [seeded: {note}]"] = (
            q1024, r20, kk, lambda kk=kk: topk_knn(q1024, r20, kk))
    calls["NNIndex.query (16, 1024, 2^20) K=16 [seeded, prepared]"] = (
        q1024, r20, 16, lambda: index20.query(q1024, neighbors=16))
    calls["topk_knn (16, 1024, 2^22) K=8 [seeded: part width 16384, B8's regime]"] = (
        q1024, r22, 8, lambda: topk_knn(q1024, r22, 8))
    # Planted tiers at m = 64 (auto: seeded) over 2^20 points: three exact
    # copies of a near point of query 0 in one 256-column cell (the
    # quadratic solver takes 2: the cell is expanded into the rerank), two
    # such cells (the passes fallback), and 30 near points in one lane,
    # one per cell, at K = 32 (more cells than the fast cap of 48).
    near = q64[0] + 1e-4
    r_exp = r20.clone()
    r_exp[[1030, 1100, 1200]] = near
    r_fb = r_exp.clone()
    r_fb[[5130, 5200, 5300]] = near
    r_esc = r20.clone()
    stride = r20.shape[0] // 32 // 256 * 256
    for j in range(30):
        r_esc[j * stride + 7] = q64[0] + 1e-4 * (j + 1)
    planted = {
        "topk_knn (16, 64, 2^20) K=8 planted [expanded cell]":
            (q64, r_exp, 8, lambda: topk_knn(q64, r_exp, 8), ("fast", "expanded")),
        "topk_knn (16, 64, 2^20) K=8 planted [passes fallback]":
            (q64, r_fb, 8, lambda: topk_knn(q64, r_fb, 8), ("fallback",)),
        "topk_knn (16, 64, 2^20) K=32 planted [escalated]":
            (q64, r_esc, 32, lambda: topk_knn(q64, r_esc, 32), ("escalated",)),
    }
    # within_radius_complete at m = 8: 40 points planted near query 0, one
    # per 128-column cell; cap 32 (the sweep) fills, so the cap doubles to
    # 64, which is seeded.
    r_rad = r20.clone()
    spots = torch.arange(40, device=device) * (r20.shape[0] // 40) + 7
    r_rad[spots] = q8[0] + 0.01 * (uniform(gen, (40, 16), device) - 0.5)
    # knn_graph at the SERVING.md shape: 2^17 points of 16 dimensions, K = 15
    # (128 chunks of 1024 rows), with K + 2 exact copies of point 5.
    kg = 15
    pts = uniform(gen, (n_graph, 16), device)
    copies = torch.arange(kg + 2, device=device) * (n_graph // (kg + 2)) + 5
    pts[copies] = pts[5].clone()
    return {"calls": calls, "planted": planted, "radius": (q8, r_rad, 0.1),
            "graph": (pts, kg, copies), "r22": r22}


def phase2_seeded(device, cases):
    """The seeded engine at the reference's published sizes (seeded_cases),
    each call checked against exact_topk_scan; every unplanted call must
    answer in the fast tier (with or without an expanded cell) and each
    planted case in its own tier;
    knn_graph at (k = 16, n = 2^17) gated over every row. Returns the
    calls, for phase 3."""
    import torch

    import tpu_knn_torch
    from tpu_knn_torch.kernels.topk import within_radius_complete

    calls = dict(cases["calls"])
    for name, (q, r, kk, fn) in calls.items():
        before = seeded_tiers()
        out = fn()
        tiers = tier_delta(before)
        errors = topk_gate_errors(q, r, out[0], kk)
        torch.cuda.synchronize(device)
        log(f"  {name}: errors {errors}/{q.shape[0] * kk}; tiers {tiers}")
        if errors:
            fail(f"{name}: {errors} errors")
        # "expanded" (one overflowing cell per row reranked whole) is
        # counted beside the tier that answered, and may join the fast one.
        if {t: c for t, c in tiers.items() if t != "expanded"} != {"fast": 1}:
            fail(f"{name}: answered in tiers {tiers}, not the fast tier")
    for name, (q, r, kk, fn, want_tiers) in cases["planted"].items():
        before = seeded_tiers()
        out = fn()
        tiers = tier_delta(before)
        errors = topk_gate_errors(q, r, out[0], kk)
        log(f"  {name}: errors {errors}/{q.shape[0] * kk}; tiers {tiers}")
        if errors:
            fail(f"{name}: {errors} errors")
        if sorted(t for t in tiers if t != "round_escalated") != sorted(want_tiers):
            fail(f"{name}: took tiers {tiers}, expected {want_tiers}")
        calls[name] = (q, r, kk, fn)
    q8, r_rad, radius = cases["radius"]
    before = seeded_tiers()
    idx, d2, count = within_radius_complete(q8, r_rad, radius)
    tiers = tier_delta(before)
    want_i, want_d = exact_topk_scan(q8, r_rad, idx.shape[1])
    true_count = (want_d <= radius ** 2).sum(dim=1)
    inside = want_i.masked_fill(want_d > radius ** 2, -1)
    if idx.shape[1] != 64 or not torch.equal(count.long(), true_count) \
            or not torch.equal(idx.long(), inside) or not tiers:
        fail(f"within_radius_complete m=8: cap {idx.shape[1]}, counts {count.tolist()} "
             f"against {true_count.tolist()}, tiers {tiers}")
    log(f"  within_radius_complete m=8 (caps 32 -> 64, seeded): counts {count.tolist()}, "
        f"identical to the exact scan; tiers {tiers}")
    calls["within_radius_complete m=8 (caps 32 -> 64, seeded)"] = (
        q8, r_rad, None, lambda: within_radius_complete(q8, r_rad, radius))
    pts, kg, copies = cases["graph"]
    n_graph = pts.shape[0]
    before = seeded_tiers()
    t0 = time.perf_counter()
    gi, gd = tpu_knn_torch.knn_graph(pts, kg)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    tiers = tier_delta(before)
    rows = torch.arange(n_graph, device=device)     # every row is gated
    errors = graph_gate_errors(pts, gi, rows, kg)
    for c in copies.tolist():
        others = [x for x in copies.tolist() if x != c][:kg]
        if gi[c].tolist() != others or bool((gd[c] != 0).any()):
            fail(f"knn_graph: duplicate row {c} is {gi[c].tolist()}, expected {others}")
    log(f"  knn_graph (k=16, n={n_graph}) K={kg}: errors {errors}/{rows.numel() * kg} "
        f"over every row; the {kg + 2} duplicate rows exact; no row holds its own index; "
        f"tiers {tiers} (first call {wall * 1e3:.1f} ms)")
    chunks = sum(tiers.get(t, 0) for t in ("fast", "escalated", "fallback"))
    if errors or chunks != -(-n_graph // 1024):
        fail(f"knn_graph: {errors} errors, tiers {tiers}")
    calls["knn_graph (16, 2^17) K=15 [seeded, 128 chunks]"] = (
        pts, pts, kg, lambda: tpu_knn_torch.knn_graph(pts, kg))
    return calls


# ---- the 1-NN ladder: phase 1 (B10, B11, B1's variants) and phase 2 ---------


def phase1_b10(device, gen, cases):
    """B10 against its plain version, and index-equal to B1 at the same
    partition count (given, else B1's: tiled_parts), in two launches (a
    wrong barrier phase of its TMA ring would show as rare wrong
    candidates). B10 emits indices only: its error is the largest |d2|
    difference of the refined answers (kernel's candidates against the
    plain version's), whose indices must be identical."""
    import torch

    from tpu_knn_torch.kernels import dma_pipeline, fused
    from tpu_knn_torch.kernels.fused import _refine, prep_soa
    from tpu_knn_torch.utils.shapes import round_up

    err = 0.0
    for k, m, n, parts in cases:
        q = uniform(gen, (m, k), device)
        r_op = prep_soa(uniform(gen, (n, k), device), round_up(n, 128))
        parts = parts or fused.tiled_parts(m, k, n)
        plant_lane_ties(q, plant_duplicates(q, r_op, n, parts), n, parts)
        b1 = fused.fused_candidates(q, r_op, n, parts)[0]
        for _ in range(2):
            ki = dma_pipeline.dma_candidates(q, r_op, n, parts)
            if not torch.equal(ki, b1):
                fail(f"B10 k={k} m={m} n={n} P={parts}: indices differ from B1's")
        pi = dma_pipeline.dma_candidates_plain(q, r_op, n, parts)
        share = (ki == pi).float().mean().item()
        ref = r_op[:k, :n].T.contiguous()
        (k_idx, k_d2), (p_idx, p_d2) = _refine(q, ref, ki, n), _refine(q, ref, pi, n)
        same = torch.equal(k_idx, p_idx)
        err = max(err, (k_d2 - p_d2).abs().max().item())
        log(f"  B10: m={m} k={k} n={n} P={parts}: index-equal to B1 twice, index agreement "
            f"with plain {share:.6f}, refined 1-NN identical: {same}")
        if share < MIN_INDEX_AGREEMENT or not same:
            fail(f"B10 k={k} m={m} n={n} P={parts}: agreement {share}, identical {same}")
        del r_op, ref, b1
    torch.cuda.synchronize(device)
    return err


def window_inputs(gen, device, k, m, n, window):
    """Points, queries and B11's launch inputs as the kernel pipeline
    computes them: query 0 is the corner (1, ..., 1) (largest projection:
    its window starts at the last tile) with two exact duplicates planted
    at original rows n/3 and 2n/3 (adjacent in sorted order, inside its
    window)."""
    import torch

    from tpu_knn_torch.kernels import projection

    r = uniform(gen, (n, k), device)
    q = uniform(gen, (m, k), device)
    q[0] = 1.0
    r[n // 3] = r[2 * n // 3] = q[0]
    index = projection.build_projection_index(r)
    w = min(window, n)
    pos = torch.searchsorted(index[3], projection._axis_column(q, index[2]))
    start = (pos - w // 2).clamp(0, max(n - w, 0))
    tiles = (start // projection.TILE_W).to(torch.int32)
    return q, r, index, tiles, projection.window_tiles(n, window)


def window_score64(q, r_aug, row, col):
    """s' = q·r − ‖r‖²/2 in f64 of query `row` at sorted column `col`."""
    k = q.shape[1]
    return float((q[row].double() * r_aug[:k, col].double()).sum()
                 - 0.5 * r_aug[k, col].double())


def phase1_b11(device, gen, cases):
    """B11 against its plain version at one split and at the default
    splits: lane agreement, and identical exact reranks (ties on the
    original index); query 0's duplicates resolve to the lower row at
    d2 = 0. Each launch is repeated over a copy of the operand whose base
    is not 16-byte aligned (the kernel's 4-byte rows instead of its float4
    rows), bit for bit. Every slot where kernel and plain version differ is
    logged with both columns' f64 scores (the two sum the same products in
    another rounding: plain f32 adds against the kernel's fmaf). Its error
    is the largest |d2| difference of the reranks."""
    import torch

    from tpu_knn_torch.kernels import projection
    from tpu_knn_torch.kernels.fused import _exact_rerank

    err = 0.0
    for k, m, n, window in cases:
        q, r, index, tiles, w_tiles = window_inputs(gen, device, k, m, n, window)
        ref_sorted, order, r_aug = index[0], index[1], index[6]
        r_odd = misaligned(r_aug)
        for splits in (1, projection.window_splits(m, w_tiles)):
            ki = projection.window_candidates(q, r_aug, tiles, w_tiles, splits)
            narrow = torch.equal(ki, projection.window_candidates(q, r_odd, tiles, w_tiles,
                                                                  splits))
            pi = projection.window_candidates_plain(q, r_aug, tiles, w_tiles, splits)
            differ = (ki != pi).nonzero().tolist()
            for row, slot in differ[:20]:
                kc, pc = int(ki[row, slot]), int(pi[row, slot])
                log(f"    B11 slot ({row}, {slot}) differs: kernel column {kc} "
                    f"s'={window_score64(q, r_aug, row, kc)!r}, plain column {pc} "
                    f"s'={window_score64(q, r_aug, row, pc)!r} (f64)")
            share = 1.0 - len(differ) / ki.numel()
            k_idx, k_d2 = _exact_rerank(q, ref_sorted, ki, n, tie_src=order)
            p_idx, p_d2 = _exact_rerank(q, ref_sorted, pi, n, tie_src=order)
            same = torch.equal(k_idx, p_idx)
            err = max(err, (k_d2 - p_d2).abs().max().item())
            dup = int(k_idx[0]) == n // 3 and float(k_d2[0]) == 0.0
            log(f"  B11: m={m} k={k} n={n} window {window} ({w_tiles} tiles, last start tile "
                f"{int(tiles.max())}) splits={splits}: lane agreement {share:.6f} "
                f"({len(differ)} slots differ), reranks identical: {same}, duplicate -> row "
                f"{int(k_idx[0])}, 4-byte rows bit-equal: {narrow}")
            if share < MIN_INDEX_AGREEMENT or not same or not dup or not narrow:
                fail(f"B11 {(k, m, n, window, splits)}: agreement {share}, identical {same}, "
                     f"duplicate {dup}, 4-byte rows equal {narrow}")
        del q, r, index, r_odd
    torch.cuda.synchronize(device)
    return err


def phase1_b1_variants(device, gen, cases):
    """B1's AoS (v3) and resident-query (v6; where its guard admits the
    shape) variants bit-equal to B1 at the same partition count (given,
    else each variant's own: tiled_parts for v3, resident_geometry's for
    v6); their error against the plain version is B1's."""
    import torch

    from tpu_knn_torch.kernels import fused
    from tpu_knn_torch.kernels.fused import prep_soa
    from tpu_knn_torch.kernels.tuning import resident_geometry
    from tpu_knn_torch.utils.shapes import round_up

    err = 0.0
    for k, m, n, parts in cases:
        q = uniform(gen, (m, k), device)
        r_op = prep_soa(uniform(gen, (n, k), device), round_up(n, 128))
        p3 = parts or fused.tiled_parts(m, k, n)
        plant_lane_ties(q, plant_duplicates(q, r_op, n, p3), n, p3)
        r = r_op[:k, :n].T.contiguous()
        runs = [("AoS (v3)", fused.aos_candidates, r, p3)]
        if fused.const_query_fits(m, k):
            runs.append(("constant-query (v6)", fused.const_query_candidates, r_op,
                         parts or resident_geometry(m, k, n).parts))
        b1 = {}
        for name, wrapper, operand, p in runs:
            if p not in b1:
                b1[p] = fused.fused_candidates(q, r_op, n, p)
            vi, vs = wrapper(q, operand, n, p)
            if not (torch.equal(vi, b1[p][0]) and torch.equal(vs, b1[p][1])):
                fail(f"B1 {name} k={k} m={m} n={n} P={p}: not bit-equal to B1")
        plain = ""
        if k <= 768:   # wider: B1's own tile edges hold it to its plain version
            bi, bs = b1[p3]
            pi, ps = fused.fused_candidates_plain(q, r_op, n, p3)
            share, e, _ = slot_agreement("B1 variants", bi, bs, pi, ps, score_rtol(k))
            err = max(err, e)
            plain = f"; plain agreement {share:.6f}, max |score diff| {e:.3g}"
            del pi, ps
        log(f"  B1 {' and '.join(name for name, *_ in runs)}: m={m} k={k} n={n} "
            f"P={sorted(b1)}: bit-equal to B1{plain}")
        del r_op, r, b1
    torch.cuda.synchronize(device)
    return err


def phase2_ladder(device, gen):
    """The runner over the TA shapes with every registered version (v0 the
    baseline; its CSV must be the golden file, every other version 0
    errors), then v1, v2, v3, v5, v6 and v11 at each BIG shape (ds8..ds11)
    its guard admits, against exact_scan (v3, v5 and v6 at their resolved
    tier, "packed" there: their tensor-core instances); and v3, v5 and v6 at
    precision="highest" (their tiled f32 kernels) at ds11 and ds9. Returns
    the BIG data."""
    import torch

    import tpu_knn_torch
    from tpu_knn_torch.engine.registry import get_version
    from tpu_knn_torch.harness import runner
    from tpu_knn_torch.harness.generator import BIG_SHAPES, TA_SHAPES
    from tpu_knn_torch.kernels import dma_pipeline, fused

    versions = runner.registered_ladder()
    runner.warm_up(versions, device)
    records, lines = [], []
    ok, golden_lines = runner.run(versions, list(TA_SHAPES), log=lines.append,
                                  collect_golden=True, warm_shapes=False, records=records,
                                  device=device)
    with open(GOLDEN) as f:
        golden_same = "\n".join(golden_lines).strip() == f.read().strip()
    for v in versions[1:]:
        errs = [r["errors"] for r in records if r["version"] == v]
        log(f"  runner, TA shapes, {v}: errors {errs} against v0 (the golden indices)")
    log(f"  runner, TA shapes: v0's --results-csv lines equal {os.path.relpath(GOLDEN, REPO)}: "
        f"{golden_same}; {len(records)} timed calls")
    if not ok or not golden_same:
        fail(f"runner over the TA shapes: all_pass={ok}, golden={golden_same}")
    stamp("the runner over the TA shapes")
    big = {}
    for k, m, n in BIG_SHAPES:
        q, r = uniform(gen, (m, k), device), uniform(gen, (n, k), device)
        want = exact_scan(q, r)
        big[(k, m, n)] = (q, r)
        for v in ("v1", "v2", "v3", "v5", "v6", "v11"):
            guard = get_version(v).guard
            if guard is not None and not guard(k, m, n):
                log(f"  {v} {(k, m, n)}: outside its guard (delegates to "
                    f"{get_version(v).fallback})")
                continue
            idx = tpu_knn_torch.knn_callback(k, m, n, q, r, version=v)
            errors = gate_errors(q, r, idx, want)
            torch.cuda.synchronize(device)
            log(f"  {v} {(k, m, n)}: errors {errors}/{m}")
            if errors:
                fail(f"{v} {(k, m, n)}: {errors} errors")
        if (k, m, n) in (DS11, DS9):
            for v, fn in (("v3", lambda: fused.fused_knn(q, r, soa=False, precision="highest")),
                          ("v5", lambda: dma_pipeline.dma_knn(q, r, precision="highest")),
                          ("v6", lambda: fused.const_query_knn(q, r, precision="highest"))):
                errors = gate_errors(q, r, fn()[0], want)
                log(f"  {v} {(k, m, n)} precision='highest': errors {errors}/{m}")
                if errors:
                    fail(f"{v} {(k, m, n)} precision='highest': {errors} errors")
        del want
    return big


def phase2_auto(device, gen, n=1 << 24, k=3):
    """NNIndex(strategy="auto") over (k, n) uniform points: the probe's
    certification rate, m = 16 routed to the projection path and m = 64
    to the fused one, each exact; NNIndex(strategy="projection") at
    m = 16; and a planted identical-projection case (the split axis
    constant) that must take the fallback scan and stay exact. Returns
    the data and indexes, for phase 3."""
    import torch

    import tpu_knn_torch
    from tpu_knn_torch.kernels import projection

    r = uniform(gen, (n, k), device)
    q16, q64 = uniform(gen, (16, k), device), uniform(gen, (64, k), device)
    auto = tpu_knn_torch.NNIndex(r, strategy="auto")
    log(f"  NNIndex(auto) ({k}, {n}): probe cert_rate {auto.cert_rate} "
        f"(CERT_RATE_MIN {auto.CERT_RATE_MIN}); projection index kept: "
        f"{auto.proj_index is not None}")
    if auto.proj_index is None:
        fail("NNIndex(auto): the probe dropped the projection index on uniform data")
    for q, route in ((q16, "projection"), (q64, "fused")):
        before = dict(projection.TALLY)
        idx, _ = auto.query(q)
        errors = gate_errors(q, r, idx)
        tally = {t: c - before[t] for t, c in projection.TALLY.items()}
        log(f"  NNIndex(auto).query m={q.shape[0]}: route {auto.last_strategy}, errors "
            f"{errors}/{q.shape[0]}, projection tally {tally}")
        if auto.last_strategy != route or errors:
            fail(f"NNIndex(auto) m={q.shape[0]}: route {auto.last_strategy}, errors {errors}")
    proj = tpu_knn_torch.NNIndex(r, strategy="projection")
    errors = gate_errors(q16, r, proj.query(q16)[0])
    log(f"  NNIndex(projection).query m=16: errors {errors}/16")
    if errors:
        fail(f"NNIndex(projection): {errors} errors")
    flat = uniform(gen, (1 << 20, k), device)
    flat[:, 0] = 0.5
    before = projection.TALLY["fallback_batches"]
    idx, _ = projection.projection_knn(
        q16, flat, prebuilt=projection.build_projection_index(flat, axis=0))
    took = projection.TALLY["fallback_batches"] - before
    errors = gate_errors(q16, flat, idx)
    torch.cuda.synchronize(device)
    log(f"  projection_knn, split axis constant ({k}, 2^20) m=16: fallback batches {took}, "
        f"errors {errors}/16")
    if took != 1 or errors:
        fail(f"identical projections: fallback batches {took}, errors {errors}")
    fused = tpu_knn_torch.NNIndex(r, strategy="fused")
    return {"r": r, "q16": q16, "auto": auto, "fused": fused}


# ---- the score tiers and the stores: phase 1 and phase 2 -------------------

def tier_operands(gen, device, kind, k, m, n):
    """(q, stored points (n, k) f32, the kernel's operands) for a tier case:
    "f32" the SoA operand, "bf16" a bf16 store's, "int8" an int8 grid's
    per-call bf16 operand with grid-space queries, "presplit" B12's (hi, lo,
    ‖r‖²). Query 0's point is planted at columns n // 3 and n // 2 (an exact
    tie the rerank must resolve to n // 3; n // 5 on the int8 grid). At
    k < 3 the points within 0.01 of query 0 in every coordinate are moved
    by 0.5 (mod 1): on the line, n = 20077 points otherwise put dozens
    within the score's f32 resolution of the planted pair (the score
    ‖r‖² − 2q·r keeps d² only to a few ulps of ‖q‖²), and in a bf16 store
    some would round onto it."""
    import torch

    from tpu_knn_torch.kernels.fused import prep_soa
    from tpu_knn_torch.kernels.tiers import presplit_ops

    n_pad = -(-n // 128) * 128
    q = uniform(gen, (m, k), device)
    if kind == "int8":
        g = torch.randint(-127, 128, (n, k), generator=gen, device=device, dtype=torch.int8)
        q = q * 254.0 - 127.0
        g[n // 2] = g[n // 3] = g[n // 5]
        q[0] = g[n // 3].float()
        return q, g.float(), (prep_soa(g.to(torch.bfloat16), n_pad),)
    r = uniform(gen, (n, k), device)
    if k < 3:
        near = (r - q[0]).abs().max(dim=1).values < 0.01
        r[near] = (r[near] + 0.5) % 1.0
    r[n // 2] = r[n // 3] = q[0]
    if kind == "bf16":
        r = r.to(torch.bfloat16)
        return q, r.float(), (prep_soa(r, n_pad),)
    if kind == "presplit":
        return q, r, presplit_ops(r, n_pad)
    return q, r, (prep_soa(r, n_pad),)


def phase1_tiers(device, gen, cases):
    """Each tier instance of the tensor-core kernel (B1's tiers) and B12
    against its plain version, at the slots and at the refine:
    - candidate indices agree on at least MIN_INDEX_AGREEMENT of the slots;
    - the refined (idx, d2) over the merged 128 lanes (the set the main
      path refines, tiers.refine_candidates) is identical to the plain
      path's, but for rows where the two answers' exact (f64) squared
      distances differ by at most twice the larger measured absolute score
      error of the two: a near-tie that two correct f32 orders may resolve
      apart; each such row is printed with both answers;
    - the planted exact tie resolves to the lower column in both;
    - the score error against an f64 recomputation (tiers.score_errors,
      relative to the largest |score| of the candidates) is within the
      tier's gate (tiers.tier_error_gate: its _TIER_EPS plus f32
      arithmetic, or the plain version's own error where the tier's
      arithmetic exceeds that);
    - where the certified fast path is taken (every |score| within
      select_cutoff), the top-T selection is exact at the measured error
      (tiers.selection_slack at most REFINE_TOP_T; required at k >= 3,
      printed at k < 3, where the score resolves d² only to a few ulps
      of ‖q‖²).
    "highest" (B1 on the CUDA cores) beside each, for reference. The
    "default" tier (one bf16 pass, selection-approximate) is held at the
    slots and its error only. Returns ({row: max |score diff| to plain},
    {row: largest relative score error of the kernel}, {row: largest
    share of its gate})."""
    import torch

    from tpu_knn_torch.kernels import fused, tiers
    from tpu_knn_torch.kernels.fused import REFINE_TOP_T, _refine, prep_soa, select_cutoff

    def exact_d2(q, pts, idx):
        return ((pts[idx.long()].double() - q.double()) ** 2).sum(dim=-1)

    diffs, rel, share_of_gate = {}, {}, {}
    for label, precision, kind, k, m, n in cases:
        q, pts, ops = tier_operands(gen, device, kind, k, m, n)
        parts = tiers.tier_parts(precision, m, k, n)
        ki, ks = tiers.tier_candidates(q, ops, n, parts, precision)
        pi, ps = tiers.tier_candidates_plain(q, ops, n, parts, precision)
        share = (ki == pi).float().mean().item()
        agree = (ki == pi) & torch.isfinite(ps)
        diff = (ks - ps)[agree].abs().max().item()
        err, err_mag, err_abs = tiers.score_errors(q, pts, ki, ks)
        plain_err, _, plain_abs = tiers.score_errors(q, pts, pi, ps)
        gate = tiers.tier_error_gate(precision, k, plain_err)
        eps = fused._TIER_EPS.get(tiers.resolved_tier(precision, k), 2.0 ** -8)
        hi_i, hi_s = fused.fused_candidates(q, prep_soa(pts, ops[0].shape[1]), n,
                                            fused.tiled_parts(m, k, n))
        hi_err = tiers.score_errors(q, pts, hi_i, hi_s)[0]
        del hi_i, hi_s
        cutoff = select_cutoff(precision, k)
        mk, mp = tiers.merge_partitions(ki, ks), tiers.merge_partitions(pi, ps)
        (k_idx, _), (p_idx, _) = (_refine(q, pts, c, n, cutoff=cutoff) for c in (mk, mp))
        apart = (k_idx != p_idx).nonzero().flatten()
        slack_d2 = 2.0 * max(err_abs, plain_abs)
        gap = (exact_d2(q[apart], pts, k_idx[apart])
               - exact_d2(q[apart], pts, p_idx[apart])).abs()
        same = bool((gap <= slack_d2).all())
        rows = ", ".join(f"row {int(r)}: {int(k_idx[r])} / {int(p_idx[r])} (|d2 gap| "
                         f"{float(g):.3g})" for r, g in zip(apart[:4], gap[:4]))
        want_tie = n // 5 if kind == "int8" else n // 3
        tie = int(k_idx[0]) == want_tie and int(p_idx[0]) == want_tie
        mag = float(torch.where(torch.isfinite(mk[1]), mk[1].abs(), 0.0).max())
        slack = tiers.selection_slack(q, pts, mk[0], err_abs) if mag <= cutoff else None
        certified = slack is None or slack <= REFINE_TOP_T or k < 3
        if precision == "default":
            same, tie, certified = True, True, True
        log(f"  {label} ({precision}, {kind} operand) k={k} m={m} n={n} P={parts}: "
            f"agreement {share:.6f}; refined identical but {len(apart)} near-tie rows "
            f"within {slack_d2:.3g} of each other: {same} [{rows}]; tie -> kernel "
            f"{int(k_idx[0])}, plain {int(p_idx[0])} (want {want_tie}); fast path "
            + (f"taken (max |score| {mag:.3g} <= {cutoff:.3g}), lanes within 2x the error "
               f"of the row minimum {slack} (T = {REFINE_TOP_T})" if slack is not None
               else f"not taken (max |score| {mag:.3g} > {cutoff:.3g})")
            + f"; score error {err:.3g} (plain {plain_err:.3g}, absolute {err_abs:.3g}, "
            f"per-candidate |terms| {err_mag:.3g}) against _TIER_EPS {eps:.3g}, gate "
            f"{gate:.3g} ({err / gate:.2f} of it); B1 'highest' {hi_err:.3g}")
        if share < MIN_INDEX_AGREEMENT or not same or not tie or not certified or err > gate:
            fail(f"{label} {precision} k={k} m={m} n={n}: agreement {share}, identical "
                 f"{same}, tie {tie}, selection slack {slack}, score error {err} > gate {gate}")
        diffs[label] = max(diffs.get(label, 0.0), diff)
        rel[label] = max(rel.get(label, 0.0), err)
        share_of_gate[label] = max(share_of_gate.get(label, 0.0), err / gate)
        del q, pts, ops, ki, ks, pi, ps, mk, mp
        torch.cuda.empty_cache()
    torch.cuda.synchronize(device)
    return diffs, rel, share_of_gate


# ---- the top-K kernels at a tier: B4, B5, B3 and B7's tensor-core instances --

#: Where phase 1 holds each top-K tier instance to its plain version:
#: (precision, operand kind, k, m, n): ds11 at "packed" (packed3), (128,
#: 1024, 2^20) and (768, 1024, 2^18) at bf16x3 over the f32 operand and at
#: qsplit2 (the bf16 store's tier) over a bf16 store's operand.
EMBED_TOPK = (768, 1024, 1 << 18)
TOPK_TIER_CASES = [("packed", "f32", *DS11), ("packed", "bf16", *DS11),
                   ("bf16x3", "f32", 128, 1024, 1 << 20),
                   ("qsplit2", "bf16", 128, 1024, 1 << 20),
                   ("bf16x3", "f32", *EMBED_TOPK), ("qsplit2", "bf16", *EMBED_TOPK)]
#: The cases phase 3 times, each a row of the kernels line per kernel.
TOPK_TIER_TIMED = [case for case in TOPK_TIER_CASES if case[2] != 128]
#: The K the engines' launches are made at (B5's lists, B4's passes, B3's
#: prefix and B7's cells), as the passes and seeded engines make them at ds11
#: K = 8.
TOPK_TIER_K = 8
#: The kernels each instance's device time holds (torch.profiler names):
#: the tensor-core kernel of the epilogue and the norm pass before it; B3
#: also its partition merge.
TOPK_TIER_DEVICE = {"B4": (("BandedEpi", "tensor_candidates_norms"), 2),
                    "B5": (("SweepEpi", "tensor_candidates_norms"), 2),
                    "B3": (("MinimaEpi", "tensor_candidates_norms", "minima_merge",
                            "minima_init"), 3),
                    "B7": (("MomentsEpi", "tensor_candidates_norms"), 2)}
#: Each top-K kernel's wrapper, TPU kernel and source file of its tier
#: instance (tpu_knn_torch/csrc/).
TOPK_TIER_KERNELS = {
    "B4": ("banded_candidates", "tpu_knn/kernels/fused.py:506", "tensor_banded_kernels.cu"),
    "B5": ("sweep_candidates", "tpu_knn/kernels/topk.py:188", "tensor_sweep_kernels.cu"),
    "B3": ("minima_candidates", "tpu_knn/kernels/fused.py:613", "tensor_minima_kernels.cu"),
    "B7": ("extract_moments", "tpu_knn/kernels/topk.py:509", "tensor_moments_kernels.cu"),
}


#: The top-K tier rows of B3 and B5, ranked by launches x (device ms -
#: bound ms), each with its kernel's device ms before their epilogues'
#: redesign (the score tile and the shared fold slots; tier_kernel.py time
#: on an "NVIDIA H100 80GB HBM3, 700.00 W").
RANKED_TIER_ROWS = {"B3 packed3": 0.6788, "B5 packed3": 4.0372, "B3 bf16x3": 3.8571,
                    "B5 bf16x3": 12.0563, "B3-bf16 packed3": 0.4618,
                    "B5-bf16 packed3": 3.0961, "B3-bf16 qsplit2": 2.5508,
                    "B5-bf16 qsplit2": 7.8160, "B3 packed3 depth 2": 0.6941,
                    "B3 packed3 band": 0.6802, "B5 packed3 (16, 8, 2^20) K=32": 0.4318,
                    "B5 packed3 (16, 32, 2^20) K=8": 0.3717}


def log_ranked_tier_rows(card, times, bounds):
    """Log each ranked row's device ms beside its bound and its time before
    the redesign."""
    for row, before in RANKED_TIER_ROWS.items():
        ms = times[f"{row} kernel device"]
        log(f"  ranked row {row}: device {ms:.4f} ms, bound {bounds[row][0]:.4f} ms, before "
            f"the redesign {before:.4f} ms ({ms / before:.3f}x) [{card}]")


def topk_tier_calls(q, r_op, n, precision, kk=TOPK_TIER_K):
    """kernel id -> (kernel call, plain call) of B4, B5, B3 and B7 at the
    launches the engines make over (q, r_op) at K = kk and `precision`:
    B4's second pass of the passes engine (the band at the first pass's
    lexicographic minimum, the plain version's own), B5's lists at the
    tier's P, and B3 and B7 as the
    seeded engine launches them (seeded_geometry: B3's prefix and depth,
    B7's cell and fields at the bound from B3's inflated K-th minimum).
    Also returns the launches' geometry."""
    import torch

    from tpu_knn_torch.kernels import fused, seeded, topk

    m, k = q.shape
    p4 = fused.banded_parts(precision, m, k, n)
    q_t = fused.transposed_queries(q) if precision == "highest" else None
    b_s = torch.full((m,), -torch.inf, device=q.device)
    b_i = torch.full((m,), -1, dtype=torch.int32, device=q.device)
    i1, s1 = topk._lex_min(*fused.banded_candidates(q, r_op, n, p4, b_s, b_i, q_t, precision))
    # The plain version's second pass at its own first pass's minimum (the
    # two score the bound's element in different last bits, so on the
    # kernel's bound the plain version could readmit it).
    pi1, ps1 = topk._lex_min(*fused.banded_candidates_plain(q, r_op, n, p4, b_s, b_i, precision))
    p5 = topk.sweep_parts(m, k, n, precision)
    g = seeded.seeded_geometry(m, n, k, kk, r_op.shape[1], precision)
    cs1 = fused.minima_candidates(q, r_op, n, depth=g["depth"], n_limit=g["p1_limit"], q_t=q_t,
                                  precision=precision)
    bound = seeded._inflate_bound(seeded._kth_smallest(cs1, kk))
    calls = {
        "B4": (lambda: fused.banded_candidates(q, r_op, n, p4, s1, i1, q_t, precision),
               lambda: fused.banded_candidates_plain(q, r_op, n, p4, ps1, pi1, precision)),
        "B5": (lambda: topk.sweep_candidates(q, r_op, n, p5, kk, precision),
               lambda: topk.sweep_candidates_plain(q, r_op, n, p5, kk, precision)),
        "B3": (lambda: fused.minima_candidates(q, r_op, n, depth=g["depth"],
                                               n_limit=g["p1_limit"], q_t=q_t,
                                               precision=precision),
               lambda: fused.minima_candidates_plain(q, r_op, n, g["depth"], None,
                                                     g["p1_limit"], precision)),
        "B7": (lambda: seeded.extract_moments(q, r_op, n, bound, g["cell"], g["n_fields"],
                                              q_t=q_t, precision=precision),
               lambda: seeded.extract_moments_plain(q, r_op, n, bound, g["cell"],
                                                    g["n_fields"], precision=precision)),
    }
    return calls, {"p4": p4, "p5": p5, **g}


def timed_once(fn):
    """(fn(), its ms by CUDA events): one call, the one a check makes."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def phase1_topk_tiers(device, gen, cases, kk=TOPK_TIER_K):
    """B4, B5, B3 and B7's tier instances against their plain versions at
    the engines' launches (topk_tier_calls) of each case, and against each
    other:
    - B4: candidate indices agree on at least MIN_INDEX_AGREEMENT of the
      slots, the score error against f64 (tiers.score_errors) within the
      tier's gate (tiers.tier_error_gate); the scores of agreeing slots
      within twice the gate of the plain version's (`tol` below);
    - B5: the list contract (check_lists); a slot whose column differs
      from the plain list's holds a near-tie of the plain scores
      (list_agreement, within tol), the scores within tol;
    - B4 and B5 bit for bit: kk passes of B4 from (-inf, -1), each at the
      last one's lexicographic minimum, pick exactly the (column, score)
      pairs of B5's lexicographic kk smallest;
    - B3 at the seeded launch and at depth 2 over all columns: the same
      finite lanes, values within tol;
    - B7: with the bound at the widest gap of the scores of ranks 20..400
      (bound_between; the gap is required wider than twice tol, so no score
      lies within the tiers' difference of it), the packed words identical
      to the plain version's at the seeded engine's cells for K = kk and 64;
    - B3 and B7 bit for bit: B7's remainder minima above that bound equal B3
      banded at it.
    Returns ({row: max |kernel - plain| of the row's kernel}, {row: the
    plain version's ms at the launch phase 3 times})."""
    import torch

    from tpu_knn_torch.kernels import fused, seeded, tiers, topk

    errs, plain_ms = {}, {}
    for precision, kind, k, m, n in cases:
        q, pts, ops = tier_operands(gen, device, kind, k, m, n)
        r_op = ops[0]
        tag = f"{precision} over the {kind} operand at (k={k}, m={m}, n={n})"
        row = {kid: tiers.topk_tier_row(kid, r_op, precision, k) for kid in TOPK_TIER_KERNELS}
        calls, geo = topk_tier_calls(q, r_op, n, precision, kk)
        # B4
        ki, ks = calls["B4"][0]()
        (pi, ps), plain_ms[row["B4"]] = timed_once(calls["B4"][1])
        share = (ki == pi).float().mean().item()
        err = tiers.score_errors(q, pts, ki, ks)[0]
        gate = tiers.tier_error_gate(precision, k, tiers.score_errors(q, pts, pi, ps)[0])
        agree = (ki == pi) & torch.isfinite(ps)
        diff4 = (ks - ps)[agree].abs().max().item()
        tol = 2.0 * gate * ps[torch.isfinite(ps)].abs().max().item()
        if share < MIN_INDEX_AGREEMENT or err > gate or diff4 > tol:
            fail(f"{row['B4']} {tag}: agreement {share}, score error {err} (gate {gate}), "
                 f"|diff| {diff4} > {tol}")
        # B5: where a slot's column differs from the plain list's, the two
        # are a near-tie of the plain scores (list_agreement)
        ci, cs = calls["B5"][0]()
        check_lists(f"{row['B5']} {tag}", ci, cs, n, geo["p5"], kk)
        (li, ls), plain_ms[row["B5"]] = timed_once(calls["B5"][1])
        s = fused.scores(q, r_op, n, precision)
        share5, diff5, swaps5 = list_agreement(f"{row['B5']} {tag}", ci, cs, li, s, 2.0 * gate)
        # B4 and B5 bit for bit
        b_s = torch.full((m,), -torch.inf, device=device)
        b_i = torch.full((m,), -1, dtype=torch.int32, device=device)
        picks_i, picks_s = [], []
        for _ in range(kk):
            b_i, b_s = topk._lex_min(*fused.banded_candidates(q, r_op, n, geo["p4"], b_s, b_i,
                                                              precision=precision))
            picks_i.append(b_i)
            picks_s.append(b_s)
        l_s, l_i = topk._lex_smallest(cs, ci, kk)
        same45 = (torch.equal(torch.stack(picks_i, 1), l_i)
                  and torch.equal(torch.stack(picks_s, 1), l_s))
        if not same45:
            fail(f"{tag}: B4's {kk} passes and B5's lists differ")
        # B3
        km = calls["B3"][0]()
        pm, plain_ms[row["B3"]] = timed_once(calls["B3"][1])
        km2 = fused.minima_candidates(q, r_op, n, depth=2, precision=precision)
        pm2 = fused.minima_candidates_plain(q, r_op, n, 2, precision=precision)
        diff3 = 0.0
        for got, want in ((km, pm), (km2, pm2)):
            fin = torch.isfinite(want)
            if not torch.equal(fin, torch.isfinite(got)):
                fail(f"{row['B3']} {tag}: finite lanes differ from plain")
            diff3 = max(diff3, (got - want)[fin].abs().max().item())
        if diff3 > tol:
            fail(f"{row['B3']} {tag}: |diff| {diff3} > {tol}")
        del km2, pm2
        # B7 at a bound in a gap, then B3 against B7 bit for bit
        low = torch.topk(s, 401, dim=1, largest=False).values
        del s
        half_gap = (low[:, 21:] - low[:, 20:-1]).max(dim=1).values / 2
        bound = bound_between(low, 20, 400)
        if not bool((half_gap > tol).all()):
            fail(f"{tag}: no gap of the scores wider than {2 * tol:.3g} in a row's ranks "
                 "20..400")
        words = []
        for kk7 in (kk, 64):
            g7 = seeded.seeded_geometry(m, n, k, kk7, r_op.shape[1], precision)
            got = seeded.extract_moments(q, r_op, n, bound, g7["cell"], g7["n_fields"],
                                         precision=precision)
            want = seeded.extract_moments_plain(q, r_op, n, bound, g7["cell"], g7["n_fields"],
                                                precision=precision)
            for g, w in zip(got, want):
                if not torch.equal(g, w):
                    fail(f"{row['B7']} {tag} (cell {g7['cell']}): packed words differ at "
                         f"{int((g != w).sum())} cells")
            words.append(f"cell {g7['cell']} x {g7['n_fields']} fields: "
                         f"{int((got[0] != 0).sum())} qualifying cells")
        _, plain_ms[row["B7"]] = timed_once(calls["B7"][1])
        lo = torch.full((m,), -torch.inf, device=device)
        rem = seeded.extract_moments(q, r_op, n, bound, 128, 8, lo=lo, emit_rem=True,
                                     precision=precision)[-1]
        same37 = torch.equal(rem, fused.minima_candidates(q, r_op, n, lo=bound,
                                                          precision=precision))
        if not same37:
            fail(f"{tag}: B7's remainder minima differ from B3 banded at the same bound")
        errs.update({row["B4"]: diff4, row["B5"]: diff5, row["B3"]: diff3, row["B7"]: 0.0})
        log(f"  top-K tier instances, {tag} (B4 P={geo['p4']}, B5 P={geo['p5']}): B4 "
            f"agreement {share:.6f}, score error {err:.3g} (gate {gate:.3g}), |diff| "
            f"{diff4:.3g}; B5 agreement {share5:.6f} ({swaps5} slots a near-tie apart), |diff| "
            f"{diff5:.3g}; B4's {kk} passes "
            f"== B5's lists bit for bit: {same45}; B3 |diff| {diff3:.3g} (tol {tol:.3g}); B7 "
            f"words identical ({'; '.join(words)}); B7's remainder == B3 banded bit for bit: "
            f"{same37}; plain ms {[round(plain_ms[row[kid]], 3) for kid in row]}")
        del q, pts, ops, r_op, calls, ki, ks, pi, ps, ci, cs, li, ls, km, pm, low, rem
        torch.cuda.empty_cache()
    torch.cuda.synchronize(device)
    return errs, plain_ms


#: B5 at the serving shapes auto sends it (m * K <= 256): (k, m, n, K),
#: each a row of the kernels line beside the ds11 and embedding-width ones.
B5_SERVE_CASES = [(16, 8, 1 << 20, 32), (16, 32, 1 << 20, 8)]


def b5_serve_row(k, m, n, kk):
    return f"B5 packed3 ({k}, {m}, 2^{n.bit_length() - 1}) K={kk}"


#: B3 at ds11 beside the seeded engine's depth-1 launch: at depth 2 and
#: above a lo, over the same prefix, each a row of the kernels line.
B3_EXTRA_ROWS = ("B3 packed3 depth 2", "B3 packed3 band")


def b3_b5_launches(q, r_op, n, kk, precision="packed"):
    """B3's three instances as the seeded engine's bound pass makes its
    launch at K = kk (depth 1 over its prefix; depth 2 and above lo, the
    row's median score less 0.5, over the same prefix) and B5's lists at
    the tier's P: {name: (kernel call, plain call)}."""
    from tpu_knn_torch.kernels import fused, seeded, topk

    m, k = q.shape
    g = seeded.seeded_geometry(m, n, k, kk, r_op.shape[1], precision)
    limit = g["p1_limit"] or n
    lo = fused.scores(q, r_op, min(n, limit), precision).median(dim=1).values - 0.5
    p5 = topk.sweep_parts(m, k, n, precision)
    calls = {}
    for name, depth, band in (("B3", 1, None), ("B3 depth 2", 2, None), ("B3 band", 1, lo)):
        calls[name] = (
            lambda depth=depth, band=band: fused.minima_candidates(
                q, r_op, n, depth=depth, lo=band, n_limit=limit, precision=precision),
            lambda depth=depth, band=band: fused.minima_candidates_plain(
                q, r_op, n, depth, band, limit, precision))
    calls["B5"] = (lambda: topk.sweep_candidates(q, r_op, n, p5, kk, precision),
                   lambda: topk.sweep_candidates_plain(q, r_op, n, p5, kk, precision))
    return calls


def phase1_b3_b5_exact(device, gen):
    """B3's three instances and B5's lists bit for bit against their plain
    versions at ds11 (packed3 over the f32 operand and a bf16 store's, K =
    8) and at the serving shapes (B5_SERVE_CASES), over small integer
    points and queries: every tier's products and sums are then exact, so
    the kernels' scores are the plain versions' and each minimum, list and
    tie (lowest column first) must be identical. At the serving shapes also
    over uniform points: B5's lists against the plain version's (a slot
    whose column differs holds a near-tie, list_agreement) and the list
    contract. Returns ({row: 0.0}, {row: plain ms}) for the serving rows and
    B3's extra rows."""
    import torch

    from tpu_knn_torch.kernels import fused, tiers, topk
    from tpu_knn_torch.kernels.fused import prep_soa

    errs, plain_ms = {}, {}
    cases = [(*DS11, 8, "f32"), (*DS11, 8, "bf16")]
    cases += [(k, m, n, kk, "f32") for k, m, n, kk in B5_SERVE_CASES]
    for k, m, n, kk, kind in cases:
        q = torch.randint(0, 8, (m, k), generator=gen, device=device).float()
        r = torch.randint(0, 8, (n, k), generator=gen, device=device).float()
        r_op = prep_soa(r, -(-n // 128) * 128)
        if kind == "bf16":
            r_op = r_op.to(torch.bfloat16)
        del r
        tag = f"packed3 over small integers, {kind} operand (k={k}, m={m}, n={n}) K={kk}"
        calls = b3_b5_launches(q, r_op, n, kk)
        serve = m <= tiers.B5_SERVE_ROWS
        for name, (kern, plain) in calls.items():
            if serve and name != "B5":
                continue
            got, (want, ms) = kern(), timed_once(plain)
            got, want = (got if isinstance(got, tuple) else (got,),
                         want if isinstance(want, tuple) else (want,))
            for g, w in zip(got, want):
                g, w = (t.view(torch.int32) if t.dtype == torch.float32 else t for t in (g, w))
                if not torch.equal(g, w):
                    fail(f"{name} {tag}: {int((g != w).sum())} outputs differ from the plain "
                         "version's")
            row = (b5_serve_row(k, m, n, kk) if serve
                   else {"B3 depth 2": B3_EXTRA_ROWS[0], "B3 band": B3_EXTRA_ROWS[1]}.get(name))
            if row and kind == "f32":
                errs[row] = 0.0
        log(f"  B3 and B5 tier instances bit for bit their plain versions, {tag}: "
            f"{'B5' if serve else 'B3 at depths 1 and 2 and above lo, B5'}")
        del q, r_op, calls
        torch.cuda.empty_cache()
    for k, m, n, kk in B5_SERVE_CASES:
        q, pts, (r_op,) = tier_operands(gen, device, "f32", k, m, n)
        p5 = topk.sweep_parts(m, k, n, "packed")
        ci, cs = topk.sweep_candidates(q, r_op, n, p5, kk, "packed")
        row = b5_serve_row(k, m, n, kk)
        check_lists(row, ci, cs, n, p5, kk)
        (li, _), plain_ms[row] = timed_once(
            lambda: topk.sweep_candidates_plain(q, r_op, n, p5, kk, "packed"))
        s = fused.scores(q, r_op, n, "packed")
        gate = tiers.tier_error_gate("packed", k, 0.0)
        share, diff, swaps = list_agreement(row, ci, cs, li, s, 2.0 * gate)
        errs[row] = diff
        log(f"  {row} over uniform points (P={p5}): agreement {share:.6f} ({swaps} slots a "
            f"near-tie apart), |diff| {diff:.3g}")
        del q, pts, r_op, ci, cs, li, s
        torch.cuda.empty_cache()
    q, pts, (r_op,) = tier_operands(gen, device, "f32", *DS11)
    calls = b3_b5_launches(q, r_op, DS11[2], 8)
    for name, row in (("B3 depth 2", B3_EXTRA_ROWS[0]), ("B3 band", B3_EXTRA_ROWS[1])):
        _, plain_ms[row] = timed_once(calls[name][1])
    del q, pts, r_op, calls
    torch.cuda.empty_cache()
    return errs, plain_ms


def phase3_b3_b5_rows(card, device, gen, reps):
    """Times of B3 at depth 2 and above a lo at ds11 (B3_EXTRA_ROWS) and of
    B5 at the serving shapes (B5_SERVE_CASES), each beside the same launch
    at "highest", with its device time and bound (inputs read once, outputs
    written once over the memory rate, or T·2·m·n·k16 over the bf16 peak).
    Returns (times, bounds)."""
    import torch

    from tpu_knn_torch.kernels import seeded, tiers
    from tpu_knn_torch.utils.timing import time_ms

    times, bounds = {}, {}
    terms = len(tiers.term_list("packed", 16))
    k, m, n = DS11
    q, pts, (r_op,) = tier_operands(gen, device, "f32", k, m, n)
    calls, high = b3_b5_launches(q, r_op, n, 8), b3_b5_launches(q, r_op, n, 8, "highest")
    cols = seeded.seeded_geometry(m, n, k, 8, r_op.shape[1], "packed")["p1_limit"] or n
    for name, row, depth in (("B3 depth 2", B3_EXTRA_ROWS[0], 2),
                             ("B3 band", B3_EXTRA_ROWS[1], 1)):
        got = time_ms({"kernel": calls[name][0], "highest": high[name][0]}, reps)
        times[f"{row} kernel"], times[f"{row} highest"] = got["kernel"], got["highest"]
        names, count = TOPK_TIER_DEVICE["B3"]
        times[f"{row} kernel device"] = kernel_device_ms(calls[name][0], reps, card, names,
                                                         count)
        bounds[row] = roofline(4 * m * k + 4 * k * cols + 4 * m * 128 * depth
                               + (4 * m if depth == 1 and "band" in row else 0),
                               terms * 2 * m * cols * 16, peak=BF16_PEAK_FLOPS)
    del q, pts, r_op, calls, high
    torch.cuda.empty_cache()
    for k, m, n, kk in B5_SERVE_CASES:
        row = b5_serve_row(k, m, n, kk)
        q, pts, (r_op,) = tier_operands(gen, device, "f32", k, m, n)
        calls, high = b3_b5_launches(q, r_op, n, kk), b3_b5_launches(q, r_op, n, kk, "highest")
        got = time_ms({"kernel": calls["B5"][0], "highest": high["B5"][0]}, reps)
        times[f"{row} kernel"], times[f"{row} highest"] = got["kernel"], got["highest"]
        names, count = TOPK_TIER_DEVICE["B5"]
        times[f"{row} kernel device"] = kernel_device_ms(calls["B5"][0], reps, card, names,
                                                         count)
        bounds[row] = roofline(4 * m * k + 4 * k * n + 8 * m * kk,
                               terms * 2 * m * n * 16, peak=BF16_PEAK_FLOPS)
        del q, pts, r_op, calls, high
        torch.cuda.empty_cache()
    for row in (*B3_EXTRA_ROWS, *(b5_serve_row(*c) for c in B5_SERVE_CASES)):
        log(f"  time {row}: {times[f'{row} kernel']:.4f} ms (device "
            f"{times[f'{row} kernel device']:.4f}), its highest launch "
            f"{times[f'{row} highest']:.4f} ms; bound {bounds[row][0]:.4f} ms ({bounds[row][1]}) "
            f"[{card}]")
    return times, bounds


def phase2_topk_tiers(device, gen, n=1 << 20):
    """The top-K engines at the tiers that phase 2's other paths do not
    reach, each call gated against the exact scan over the stored points:
    - "highest" (NNIndex(precision="highest")) over the f32 operand and a
      bf16 store's at (16, 1024, 2^20): seeded K = 8 (B3, B7 and their bf16
      instances), m = 8 K = 32 (B5, B5-bf16), a passes call (B4); and the
      f32 index at its own tier ("packed") beside them, seeded K = 8;
    - topk_knn at (128, 1024, 2^20) (bf16x3): seeded K = 8, passes m = 64
      K = 8, sweep m = 8 K = 32;
    - a bf16 store at (128, 1024, 2^20) (qsplit2): seeded K = 8, m = 8 K =
      32, a passes call at the index's tier.
    Returns the calls, for phase 3."""
    import tpu_knn_torch
    from tpu_knn_torch.kernels.topk import _build_topk, topk_knn

    calls = {}
    q16, r16 = uniform(gen, (DS11[1], 16), device), uniform(gen, (n, 16), device)
    q16_64 = q16[:64].contiguous()
    packed = tpu_knn_torch.NNIndex(r16)
    gate_topk("float32 index (packed) ds11 K=8 [seeded, beside 'highest']", q16, r16,
              packed.query(q16, neighbors=8)[0], 8)
    calls["float32 index (packed) ds11 K=8 [seeded, beside 'highest']"] = \
        lambda: packed.query(q16, neighbors=8)
    for store in ("float32", "bf16"):
        ix = tpu_knn_torch.NNIndex(r16, store=store, precision="highest")
        pts = ix.ref_dev.float()
        passes = _build_topk(64, n, 16, 8, ix.r_ops[0].shape[1], "passes")
        runs = {
            f"{store} index precision='highest' ds11 K=8 [seeded]":
                (q16, 8, lambda ix=ix: ix.query(q16, neighbors=8)),
            f"{store} index precision='highest' (16, 8, 2^20) K=32 [sweep]":
                (q16[:8], 32, lambda ix=ix: ix.query(q16[:8], neighbors=32)),
            f"{store} index precision='highest' (16, 64, 2^20) K=8 [passes]":
                (q16_64, 8, lambda ix=ix, passes=passes: passes(q16_64, ix.r_ops, ix.ref_dev)),
        }
        for name, (qq, kk, fn) in runs.items():
            gate_topk(name, qq, pts, fn()[0], kk)
            calls[name] = fn
        del pts
    q, r = uniform(gen, (DS11[1], 128), device), uniform(gen, (n, 128), device)
    q_64 = q[:64].contiguous()
    runs = {
        "topk_knn (128, 1024, 2^20) K=8 [seeded, bf16x3]": (q, 8, lambda: topk_knn(q, r, 8)),
        "topk_knn (128, 64, 2^20) K=8 [passes, bf16x3]":
            (q[:64], 8, lambda: topk_knn(q[:64], r, 8, method="passes")),
        "topk_knn (128, 8, 2^20) K=32 [sweep, bf16x3]": (q[:8], 32, lambda: topk_knn(q[:8], r, 32)),
    }
    for name, (qq, kk, fn) in runs.items():
        gate_topk(name, qq, r, fn()[0], kk)
        calls[name] = fn
    ix = tpu_knn_torch.NNIndex(r, store="bf16")
    pts = ix.ref_dev.float()
    passes = _build_topk(64, n, 128, 8, ix.r_ops[0].shape[1], "passes", ix.precision)
    runs = {
        f"bf16 store (128, 1024, 2^20) K=8 [seeded, {ix.precision}]":
            (q, 8, lambda: ix.query(q, neighbors=8)),
        f"bf16 store (128, 8, 2^20) K=32 [sweep, {ix.precision}]":
            (q[:8], 32, lambda: ix.query(q[:8], neighbors=32)),
        f"bf16 store (128, 64, 2^20) K=8 [passes, {ix.precision}]":
            (q_64, 8, lambda: passes(q_64, ix.r_ops, ix.ref_dev)),
    }
    for name, (qq, kk, fn) in runs.items():
        gate_topk(name, qq, pts, fn()[0], kk)
        calls[name] = fn
    return calls


def phase3_topk_tiers(card, device, gen, reps, cases=TOPK_TIER_TIMED, kk=TOPK_TIER_K):
    """Times of B4, B5, B3 and B7's tier instances at the engines' launches
    (topk_tier_calls) of each case beside the same launch at "highest"
    (the tiled f32 kernels, their bf16 instances over a bf16 operand) and
    the "matmul part" (cuBLAS's bf16 torch.matmul of the (m, k) x (k, n)
    product: a part of the work, not the same function); each instance's
    device time (the kernel, its norm pass and B3's merge). Bounds: the
    inputs read once and the outputs written once over the memory rate, or
    the tier's T·2·m·n·k16 (n: B3's prefix) over the bf16 peak. Returns
    (times, bounds)."""
    import torch

    from tpu_knn_torch.kernels import tiers
    from tpu_knn_torch.utils.timing import time_ms

    times, bounds = {}, {}
    for precision, kind, k, m, n in cases:
        q, pts, ops = tier_operands(gen, device, kind, k, m, n)
        r_op = ops[0]
        calls, geo = topk_tier_calls(q, r_op, n, precision, kk)
        high, _ = topk_tier_calls(q, r_op, n, "highest", kk)
        q_bf, r_bf = q.to(torch.bfloat16), pts.T.contiguous().to(torch.bfloat16)
        runs = reps if k < 128 else 3
        row = {kid: tiers.topk_tier_row(kid, r_op, precision, k) for kid in TOPK_TIER_KERNELS}
        fns = {f"{row[kid]} {what}": fn for kid in TOPK_TIER_KERNELS
               for what, fn in (("kernel", calls[kid][0]), ("highest", high[kid][0]))}
        fns[f"{row['B4']} matmul part"] = lambda: torch.matmul(q_bf, r_bf)
        times.update(time_ms(fns, runs))
        for kid in TOPK_TIER_KERNELS:
            times[f"{row[kid]} matmul part"] = times[f"{row['B4']} matmul part"]
            names, count = TOPK_TIER_DEVICE[kid]
            times[f"{row[kid]} kernel device"] = kernel_device_ms(calls[kid][0], runs, card,
                                                                 names, count)
        k16 = -(-k // 16) * 16
        terms = len(tiers._operand_instance(r_op, precision, k)[1])
        op_bytes = (2 if kind == "bf16" else 4) * k * n
        nc = r_op.shape[1] // geo["cell"]
        outs = {"B4": 8 * m * 128, "B5": 8 * m * kk, "B3": 4 * m * 128 * geo["depth"],
                "B7": 4 * m * nc * (2 if geo["n_fields"] == 8 else 1)}
        for kid in TOPK_TIER_KERNELS:
            cols = (geo["p1_limit"] or n) if kid == "B3" else n
            bounds[row[kid]] = roofline(4 * m * k + op_bytes * cols // n + outs[kid],
                                        terms * 2 * m * cols * k16, peak=BF16_PEAK_FLOPS)
        log(f"  top-K tier instances {precision} over the {kind} operand (k={k}, m={m}, "
            f"n={n}), {terms} terms, K={kk}: B4 P={geo['p4']}, B5 P={geo['p5']}, B3 prefix "
            f"{geo['p1_limit']}, B7 cell {geo['cell']} x {geo['n_fields']} fields")
        del q, pts, ops, r_op, calls, high, q_bf, r_bf
        torch.cuda.empty_cache()
    for name, ms in times.items():
        log(f"  time {name}: {ms:.4f} ms [{card}]")
    for name, (ms, by) in bounds.items():
        log(f"  bound {name}: {ms:.4f} ms ({by})")
    return times, bounds


# ---- the 1-NN ladder at a tier: v3's, v6's and B10's tensor-core instances --

#: Where phase 1 holds the ladder's tier instances (v3's AoS-staged, B10's
#: TMA-staged, v6's resident-q) to their plain versions and to B1's tier:
#: (precision, k, m, n, misaligned): the main path's launches (ds8..ds11 at
#: "packed"; bf16x3 at (768, 1024, 2^18) for v3 and B10 and at (768, 16,
#: 2^20), v6's live rows), m = 32 and 33 at ds11's k (v3's and B10's last
#: 32-row and first 128-row block heights), v3's 9 terms at k = 12 (B1's
#: 8), an (n, k) array whose base is not 16-byte aligned (v3's 4-byte
#: copies), ragged n, packed2, bf16x3 with 16-row chunks, bf16x4 and
#: default; v6's live rows also at (768, 1, 2^20) (two 32-row blocks an
#: SM), (768, 21, 2^20) (the guard's edge, one 64-row block an SM),
#: (128, 128, 2^18) (two 64-row blocks) and (321, 51, 2^18) (the most live
#: rows' bytes the guard admits).
LADDER_TIER_CASES = [("packed", *DS11, False), ("packed", *DS10, False),
                     ("packed", *DS9, False), ("packed", *DS8, False),
                     ("packed", 16, 32, 1 << 20, False), ("packed", 16, 33, 1 << 20, False),
                     ("packed", 12, 100, 20_077, False), ("packed", 16, 65, 20_077, True),
                     ("packed", 32, 64, 20_000, False), ("bf16x3", 40, 33, 5003, True),
                     ("bf16x4", 16, 20, 3000, False), ("default", 16, 50, 5000, False),
                     ("bf16x3", 768, 1024, 1 << 18, False), ("bf16x3", 768, 16, 1 << 20, False),
                     ("bf16x3", 768, 1, 1 << 20, False), ("bf16x3", 768, 21, 1 << 20, False),
                     ("bf16x3", 128, 128, 1 << 18, False), ("bf16x3", 321, 51, 1 << 18, False)]
#: The rungs' rows phase 3 times: (precision, (k, m, n), rungs); v3 and B10
#: also at ds9 and ds8 (m = 1: their 32-row blocks, bound by the bytes).
LADDER_TIER_TIMED = [("packed", DS11, ("v3", "v5", "v6")),
                     ("bf16x3", (768, 1024, 1 << 18), ("v3", "v5")),
                     ("bf16x3", (768, 16, 1 << 20), ("v6",)),
                     ("packed", DS9, ("v3", "v5")), ("packed", DS8, ("v3", "v5"))]
#: Each rung's wrapper, TPU kernel, and the kernels of its tier instance's
#: and "highest" launch's device time (torch.profiler names, count; v3, B10
#: and v6's live rows chain ‖r‖² in the kernel; v6 where it is B1's own
#: launch takes B1's norm pass: ladder_device_kernels).
LADDER_TIER_KERNELS = {
    "v3": ("aos_candidates", "tpu_knn/kernels/fused.py:318",
           (("tensor_aos_kernel",), 1), ("tiled_candidates", 1)),
    "v5": ("dma_candidates", "tpu_knn/kernels/dma_pipeline.py:44",
           (("tensor_tma_kernel",), 1), ("tma_candidates", 1)),
    "v6": ("const_query_candidates", "tpu_knn/kernels/fused.py:318",
           (("tensor_live_kernel",), 1), ("tiled_candidates", 1)),
}


def ladder_device_kernels(rung, precision, k):
    """The kernels of a rung's tier launch's device time at (precision, k):
    LADDER_TIER_KERNELS', but v6 where it is B1's own launch (its q parts fit
    a 64-row block) B1's kernel and norm pass."""
    from tpu_knn_torch.kernels import tiers

    if rung == "v6" and tiers.tensor_q_resident(tiers.ladder_terms(precision, k),
                                                -(-k // 16) * 16):
        return ("CandidatesEpi", "tensor_candidates_norms"), 2
    return LADDER_TIER_KERNELS[rung][2]


def ladder_timed_names():
    """(precision, (k, m, n), rung) -> its name in phase 3's times and the
    kernels line: its row (tiers.ladder_tier_row) at the row's first shape
    in LADDER_TIER_TIMED, else the row and the shape."""
    from tpu_knn_torch.kernels import tiers

    names = {}
    for precision, shape, rungs in LADDER_TIER_TIMED:
        for rung in rungs:
            row = tiers.ladder_tier_row(rung, precision, shape[0])
            names[precision, shape, rung] = (row if row not in names.values()
                                             else f"{row} {shape}")
    return names


def ladder_calls(q, r, r_op, n, precision):
    """rung -> (its launch at `precision` and its P, the same rung at
    "highest" at its own P), over (q, the (n, k) array r, its SoA operand
    r_op) as v3, v5 and v6 launch them (fused.ladder_parts)."""
    from tpu_knn_torch.kernels import dma_pipeline, fused

    m, k = q.shape
    calls = {}
    for rung, fn, operand in (("v3", fused.aos_candidates, r),
                              ("v5", dma_pipeline.dma_candidates, r_op),
                              ("v6", fused.const_query_candidates, r_op)):
        if rung == "v6" and not fused.const_query_fits(m, k):
            continue
        p = fused.ladder_parts(rung, precision, m, k, n)
        ph = fused.ladder_parts(rung, "highest", m, k, n)
        calls[rung] = ((lambda fn=fn, o=operand, p=p: fn(q, o, n, p, precision)), p,
                       (lambda fn=fn, o=operand, p=ph: fn(q, o, n, p)))
    return calls


def phase1_ladder_tiers(device, gen, cases):
    """v3's, B10's and v6's tier instances against B1's tier launch
    (tiers.tensor_candidates) and their plain versions, each case on data
    with an exact tie planted at n // 3 and n // 2:
    - B10's indices equal B1's tier indices bit for bit at the same P, in
      two launches (a wrong barrier phase shows as rare wrong candidates);
    - v6's (idx, score) equal B1's tier's bit for bit at v6's P;
    - v3's equal B1's tier's bit for bit where the term lists agree (k not
      9..14), at B1's tier P;
    - at v3's and B10's own P (fused.ladder_parts: their 32-row blocks at m
      <= 32, 128-row ones above) again: B10's indices B1's tier's, v3's
      (idx, score) B1's where the lists agree;
    - each against its plain version: slot agreement, the score error
      against f64 within the tier's gate (v3; v6's scores are B1's), and the
      same refined 1-NN (bare indices for B10), the tie at n // 3, but for
      near-tie rows within twice the larger measured error.
    Returns ({row: max |kernel - plain| (B10: of the refined d2)}, {(row,
    (k, m, n)): the plain version's ms, one call})."""
    import torch

    from tpu_knn_torch.kernels import dma_pipeline, fused, tiers
    from tpu_knn_torch.kernels.fused import _refine, select_cutoff

    def exact_d2(q, pts, idx):
        return ((pts[idx.long()].double() - q.double()) ** 2).sum(dim=-1)

    def same_refine(name, q, pts, got, want, n, cutoff, slack):
        (gi, gd), (wi, wd) = (_refine(q, pts, c, n, cutoff=cutoff) for c in (got, want))
        apart = (gi != wi).nonzero().flatten()
        gap = (exact_d2(q[apart], pts, gi[apart]) - exact_d2(q[apart], pts, wi[apart])).abs()
        if not bool((gap <= slack).all()) or int(gi[0]) != n // 3:
            fail(f"{name}: refined answers differ from plain beyond near-ties ({len(apart)} "
                 f"rows), tie -> {int(gi[0])} (want {n // 3})")
        return len(apart), (gd - wd)[gi == wi].abs().max().item()

    def beyond_ties(q, pts, ki, pi, slack):
        """(slots whose kernel and plain columns differ, those of them whose
        exact (f64) scores differ by more than slack: not a near-tie that
        two f32 summation orders may resolve apart)."""
        rows, slots = (ki != pi).nonzero(as_tuple=True)
        n = pts.shape[0]

        def s64(cols):
            c = cols.long()
            p = pts[c.clamp(max=n - 1)].double()
            s = (p * p).sum(-1) - 2.0 * (p * q[rows].double()).sum(-1)
            return torch.where(c < n, s, torch.inf)

        gap = (s64(ki[rows, slots]) - s64(pi[rows, slots])).abs()
        return rows.numel(), int((~(gap <= slack)).sum())

    errs, plain_ms = {}, {}
    for precision, k, m, n, odd in cases:
        q, pts, (r_op,) = tier_operands(gen, device, "f32", k, m, n)
        r = misaligned(pts) if odd else pts
        shape = (k, m, n)
        rows = {rung: tiers.ladder_tier_row(rung, precision, k) for rung in ("v3", "v5", "v6")}
        parts = tiers.tensor_parts(m, n)
        b1 = tiers.tensor_candidates(q, r_op, n, parts, precision)
        (pi, ps), t_plain = timed_once(
            lambda: tiers.tensor_candidates_plain(q, r_op, n, parts, precision))
        plain_err, _, plain_abs = tiers.score_errors(q, pts, pi, ps)
        gate = tiers.tier_error_gate(precision, k, plain_err)
        cutoff = select_cutoff(precision, k)
        certified = precision not in ("default", "bf16_raw")
        notes = []
        # B10
        for _ in range(2):
            di = dma_pipeline.dma_candidates(q, r_op, n, parts, precision)
            if not torch.equal(di, b1[0]):
                fail(f"{rows['v5']} {shape}: indices differ from B1's tier's")
        plain_ms[rows["v5"], shape] = t_plain
        if certified:
            near, err = same_refine(rows["v5"], q, pts, di, pi, n, cutoff,
                                    2.0 * max(plain_abs, tiers.score_errors(q, pts, *b1)[2]))
            errs[rows["v5"]] = max(errs.get(rows["v5"], 0.0), err)
            notes.append(f"B10 == B1's tier indices twice, refined {near} near-tie rows apart")
        # v6
        if fused.const_query_fits(m, k):
            p6 = tiers.resident_tier_parts(precision, m, k, n)
            want6 = b1 if p6 == parts else tiers.tensor_candidates(q, r_op, n, p6, precision)
            vi, vs = fused.const_query_candidates(q, r_op, n, p6, precision)
            if not (torch.equal(vi, want6[0]) and torch.equal(vs, want6[1])):
                fail(f"{rows['v6']} {shape}: not bit-equal to B1's tier at P={p6}")
            if p6 == parts:
                p6i, p6s = pi, ps
            else:
                (p6i, p6s), t6 = timed_once(
                    lambda: tiers.tensor_candidates_plain(q, r_op, n, p6, precision))
            plain_ms[rows["v6"], shape] = t_plain if p6 == parts else t6
            agree = (vi == p6i) & torch.isfinite(p6s)
            errs[rows["v6"]] = max(errs.get(rows["v6"], 0.0), (vs - p6s)[agree].abs().max().item())
            apart, beyond = beyond_ties(q, pts, vi, p6i, 2.0 * max(
                plain_abs, tiers.score_errors(q, pts, vi, vs)[2]))
            if beyond:
                fail(f"{rows['v6']} {shape}: {beyond} of {apart} slots apart from plain beyond "
                     "a near-tie")
            terms6, k16 = tiers.ladder_terms(precision, k), -(-k // 16) * 16
            how = ("B1 launch" if tiers.tensor_q_resident(terms6, k16) else
                   f"live rows, {tiers.tensor_live_epilogue(terms6, m, k16)}")
            notes.append(f"v6 (P={p6}, {how}) == B1's tier bit for bit")
        # v3
        ai, as_ = fused.aos_candidates(q, r, n, parts, precision)
        lists_agree = tiers.term_list(precision, k, aos=True) == tiers.term_list(precision, k)
        if lists_agree and not (torch.equal(ai, b1[0]) and torch.equal(as_, b1[1])):
            fail(f"{rows['v3']} {shape}: not bit-equal to B1's tier where the term lists agree")
        (ap, aps), plain_ms[rows["v3"], shape] = timed_once(
            lambda: fused.aos_candidates_plain(q, r, n, parts, precision))
        share3 = (ai == ap).float().mean().item()
        agree = (ai == ap) & torch.isfinite(aps)
        errs[rows["v3"]] = max(errs.get(rows["v3"], 0.0), (as_ - aps)[agree].abs().max().item())
        err3, _, abs3 = tiers.score_errors(q, pts, ai, as_)
        aos_plain_err, _, aos_plain_abs = tiers.score_errors(q, pts, ap, aps)
        gate3 = tiers.tier_error_gate(precision, k, aos_plain_err)
        # A slot apart from plain must be a near-tie (at m = 1 one slot is
        # 1/(P * 128) of the agreement, below MIN_INDEX_AGREEMENT's slack).
        apart3, beyond3 = beyond_ties(q, pts, ai, ap, 2.0 * max(abs3, aos_plain_abs))
        if beyond3 or err3 > gate3:
            fail(f"{rows['v3']} {shape}: {beyond3} of {apart3} slots apart from plain beyond a "
                 f"near-tie (agreement {share3}), score error {err3} (gate {gate3})")
        if certified:
            near, _ = same_refine(rows["v3"], q, pts, (ai, as_), (ap, aps), n, cutoff,
                                  2.0 * max(abs3, plain_abs))
            notes.append(f"v3 {'==' if lists_agree else '(9 terms, B1 8)'} B1's tier, plain "
                         f"agreement {share3:.6f} ({apart3} near-tie slots), score error "
                         f"{err3:.3g} (gate {gate3:.3g}), refined {near} near-tie rows apart")
        p_own = fused.ladder_parts("v3", precision, m, k, n)
        if p_own != parts:
            own = tiers.tensor_candidates(q, r_op, n, p_own, precision)
            if not torch.equal(dma_pipeline.dma_candidates(q, r_op, n, p_own, precision), own[0]):
                fail(f"{rows['v5']} {shape}: indices differ from B1's tier's at its own P={p_own}")
            oi, os_ = fused.aos_candidates(q, r, n, p_own, precision)
            if lists_agree and not (torch.equal(oi, own[0]) and torch.equal(os_, own[1])):
                fail(f"{rows['v3']} {shape}: not bit-equal to B1's tier at its own P={p_own}")
            notes.append(f"at their own P={p_own} ({tiers.ladder_epilogue(m)} blocks) B10 == "
                         f"B1's tier indices{', v3 == B1' if lists_agree else ''}")
            del own, oi, os_
        log(f"  ladder tier instances, {precision} (k={k}, m={m}, n={n}, P={parts}"
            f"{', misaligned (n, k) base' if odd else ''}): {'; '.join(notes)}; B1 plain "
            f"{t_plain:.1f} ms, score error {plain_err:.3g} (gate {gate:.3g})")
        del q, pts, r, r_op, b1, pi, ps, ai, as_, ap, aps
        torch.cuda.empty_cache()
    torch.cuda.synchronize(device)
    return errs, plain_ms


def ladder_launches_by_shape(run):
    """run(), logging the ladder's tier launches it made by row, (k, m, n),
    P and (v3's and B10's) block height (probes/tier_kernel.py's spy)."""
    from tpu_knn_torch.kernels import tiers
    from tpu_knn_torch.probes.tier_kernel import ladder_launches

    out, seen = ladder_launches(run)
    for (row, (k, m, n), parts), count in sorted(seen.items()):
        height = "" if row.startswith("B1 v6") else f" ({tiers.ladder_epilogue(m)})"
        log(f"  ladder tier launches: {row} (k, m, n) = {(k, m, n)} P={parts}{height}: {count}")
    return out


def phase2_ladder_tiers(device, gen, wide=(((768, 1024, 1 << 18), ("v3", "v5")),
                                            ((768, 16, 1 << 20), ("v6",))), small=DS9):
    """The rungs at embedding width, through knn_callback at their resolved
    tier (bf16x3): v3 and v5 at (768, 1024, 2^18), v6 at (768, 16, 2^20)
    (its live rows resident); and smallm_knn(tile_n=) at ds9 (B2's per-call
    pipeline), each against the exact scan."""
    import torch

    import tpu_knn_torch
    from tpu_knn_torch.kernels import smallm

    for (k, m, n), versions in wide:
        q, r = uniform(gen, (m, k), device), uniform(gen, (n, k), device)
        want = exact_scan(q, r)
        for v in versions:
            errors = gate_errors(q, r, tpu_knn_torch.knn_callback(k, m, n, q, r, version=v), want)
            torch.cuda.synchronize(device)
            log(f"  {v} {(k, m, n)} (bf16x3): errors {errors}/{m}")
            if errors:
                fail(f"{v} {(k, m, n)}: {errors} errors")
        del q, r, want
    k, m, n = small
    q, r = uniform(gen, (m, k), device), uniform(gen, (n, k), device)
    for tile_n in (1024, 1 << 16):
        idx, _ = smallm.smallm_knn(q, r, tile_n=tile_n)
        errors = gate_errors(q, r, idx)
        log(f"  smallm_knn(tile_n={tile_n}) ds9: errors {errors}/{m}")
        if errors:
            fail(f"smallm_knn(tile_n={tile_n}) ds9: {errors} errors")
    torch.cuda.empty_cache()


def phase3_ladder_tiers(card, device, gen, reps, cases=LADDER_TIER_TIMED):
    """Times of v3's, B10's and v6's tier instances at the main path's
    launches (LADDER_TIER_TIMED), each beside the same rung at "highest"
    (its tiled f32 kernel at its own P) and B1's tier launch at B1's tier
    P, by CUDA events and by their kernels' own device time (the
    instance and its norm pass); bounds: T·2·m·n·k16 over the bf16 peak,
    or the inputs read once and the candidates written once over the
    memory rate. Returns (times, bounds)."""
    import torch

    from tpu_knn_torch.kernels import tiers
    from tpu_knn_torch.utils.timing import time_ms

    times, bounds = {}, {}
    names = ladder_timed_names()
    for precision, (k, m, n), rungs in cases:
        q, pts, (r_op,) = tier_operands(gen, device, "f32", k, m, n)
        calls = ladder_calls(q, pts, r_op, n, precision)
        parts = tiers.tensor_parts(m, n)
        tier = tiers.resolved_tier(precision, k)
        b1 = f"B1 {tier} at ({k}, {m}, {n})"
        runs = reps if k < 128 else 5
        fns = {b1: lambda: tiers.tensor_candidates(q, r_op, n, parts, precision)}
        for rung in rungs:
            row = names[precision, (k, m, n), rung]
            fns[f"{row} kernel"] = calls[rung][0]
            fns[f"{row} highest"] = calls[rung][2]
        times.update(time_ms(fns, runs))
        times[f"{b1} device"] = kernel_device_ms(
            fns[b1], runs, card, ("CandidatesEpi", "tensor_candidates_norms"), 2)
        terms = len(tiers.ladder_terms(precision, k, aos=False))
        for rung in rungs:
            row = names[precision, (k, m, n), rung]
            kernel_names, count = ladder_device_kernels(rung, precision, k)
            hname, hcount = LADDER_TIER_KERNELS[rung][3]
            times[f"{row} kernel device"] = kernel_device_ms(fns[f"{row} kernel"], runs, card,
                                                             kernel_names, count)
            times[f"{row} highest device"] = kernel_device_ms(fns[f"{row} highest"], runs, card,
                                                              hname, hcount)
            t = len(tiers.ladder_terms(precision, k, aos=rung == "v3"))
            width = 4 if rung == "v5" else 8
            bounds[row] = roofline(4 * (m * k + k * n) + width * m * 128,
                                   t * 2 * m * n * (-(-k // 16) * 16), peak=BF16_PEAK_FLOPS)
            log(f"  {row} ({k}, {m}, {n}): P {calls[rung][1]}, {t} terms; time "
                f"{times[f'{row} kernel']:.4f} ms (device {times[f'{row} kernel device']:.4f}), "
                f"'highest' {times[f'{row} highest']:.4f} (device "
                f"{times[f'{row} highest device']:.4f}), B1 {tier} at P {parts} "
                f"{times[b1]:.4f} (device {times[f'{b1} device']:.4f}) [{card}]")
        log(f"  B1 {tier} ({k}, {m}, {n}): {terms} terms")
        del q, pts, r_op, calls
        torch.cuda.empty_cache()
    for name, (ms, by) in bounds.items():
        log(f"  bound {name}: {ms:.4f} ms ({by})")
    return times, bounds


def bf16_operands(r_op, n: int):
    """r_op (a bf16 SoA operand, ld a multiple of 128) and copies of it at
    every load width of B2-bf16 below 16 bytes: ld = n + 1, n + 3 and n
    (not multiples of 8), and bases 4, 2 and 1 elements past alignment."""
    ops = [r_op] + [r_op[:, :ld].contiguous() for ld in (n + 1, n + 3, n)
                    if ld <= r_op.shape[1]]
    return ops + [misaligned(r_op, offset) for offset in (4, 2, 1)]


def phase1_b2_bf16(device, gen, cases, edges=False):
    """B2 over a bf16 operand, bit-equal to B2 over the same values upcast
    to f32 at the same P (B2-bf16's own, smallm.bf16_parts); against its
    plain version like B2. With edges, each case also over the operand's
    narrower-load copies (bf16_operands), and at P = 7 where n allows it,
    each launch made twice."""
    import torch

    from tpu_knn_torch.kernels import smallm
    from tpu_knn_torch.kernels.fused import prep_soa

    err = 0.0
    for k, m, n in cases:
        q = uniform(gen, (m, k), device)
        r_op = prep_soa(uniform(gen, (n, k), device).to(torch.bfloat16), -(-n // 128) * 128)
        parts = smallm.bf16_parts(n)
        got = smallm.smallm_candidates(q, r_op, n, parts)
        want = smallm.smallm_candidates(q, r_op.float(), n, parts)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            fail(f"B2-bf16 k={k} m={m} n={n}: not bit-equal to B2 on the upcast operand")
        widths = [smallm.bf16_load_width(r_op, m)]
        if edges:
            widths = []
            for r_v in bf16_operands(r_op, n):
                widths.append(smallm.bf16_load_width(r_v, m))
                for p in sorted({parts, min(7, -(-n // 128))}):
                    w = smallm.smallm_candidates(q, r_v.float(), n, p)
                    for _ in range(2):
                        g = smallm.smallm_candidates(q, r_v, n, p)
                        if not (torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])):
                            fail(f"B2-bf16 k={k} m={m} n={n} P={p} ld={r_v.stride(0)} width "
                                 f"{widths[-1]}: not bit-equal to B2 on the upcast operand")
        pi, ps = smallm.smallm_candidates_plain(q, r_op, n, parts)
        share, e, _ = slot_agreement("B2-bf16", got[0], got[1], pi, ps)
        err = max(err, e)
        log(f"  B2-bf16: k={k} m={m} n={n} P={parts}, load widths {widths}: bit-equal to B2 on "
            f"the upcast operand; plain agreement {share:.6f}, max |score diff| {e:.3g}")
    torch.cuda.synchronize(device)
    return err


def gate_stored(name, q, pts, idx, want=None):
    """0 errors against the exact scan over the stored points (pts, in the
    query's space), by the harness rule; returns the exact answer."""
    import torch

    if want is None:
        want = exact_scan(q, pts)
    errors = gate_errors(q, pts, idx, want)
    torch.cuda.synchronize(q.device)
    log(f"  {name}: errors {errors}/{q.shape[0]}")
    if errors:
        fail(f"{name}: {errors} errors")
    return want


def stored_space(ix, q, r):
    """(queries, stored points) of an index in its query space: the bf16
    store's upcast points, the int8 grid (and grid-space queries)."""
    if ix.store == "int8":
        return ix._i8_q(q), ix.ref_dev
    return q, ix.ref_dev.float() if ix.store == "bf16" else r


def phase2_tiers(device, gen, ds11):
    """The tier path per call and prepared at ds11: fused_knn (v4) with each
    explicit tier (bf16x3, bf16x4, presplit, highest; "default", the
    TPU's single bf16 pass, is selection-approximate: its errors are
    printed, not gated), v7 at (32, 1024, 2^20) (the packed2 tier), and
    NNIndex at ds11 with the default tier and with precision=
    "bf16x3_presplit" (B12 at every m). Each run gated against the exact
    scan."""
    import torch

    import tpu_knn_torch
    from tpu_knn_torch.kernels.fused import fused_knn

    k, m, n = ds11
    q, r = uniform(gen, (m, k), device), uniform(gen, (n, k), device)
    want = exact_scan(q, r)
    for tier in ("bf16x3", "bf16x4", "bf16x3_presplit", "highest"):
        gate_stored(f"ds11 per-call fused_knn precision={tier!r}", q, r,
                    fused_knn(q, r, precision=tier)[0], want)
    errors = gate_errors(q, r, fused_knn(q, r, precision="default", allow_approximate=True)[0],
                         want)
    log(f"  ds11 per-call fused_knn precision='default' (one bf16 pass, selection-"
        f"approximate): errors {errors}/{m} (not gated)")
    for precision in (None, "bf16x3_presplit"):
        ix = tpu_knn_torch.NNIndex(r, precision=precision)
        for mm in (1, 4, m):
            gate_stored(f"ds11 NNIndex(precision={ix.precision!r}).query m={mm}", q[:mm], r,
                        ix.query(q[:mm])[0], want[:mm])
        del ix
    q32, r32 = uniform(gen, (m, 32), device), uniform(gen, (n, 32), device)
    gate_stored("(32, 1024, 2^20) per-call knn_callback default (v7, packed2)", q32, r32,
                tpu_knn_torch.knn_callback(32, m, n, q32, r32))
    return {"q": q, "r": r}


def phase2_stores(device, gen, batch, embed_ks):
    """NNIndex(store=s) for float32, bf16 and int8: at the batch-store shape
    through pipeline(1024) and query, with m = 1 and m = 4 too, and at the
    embed shapes (k in embed_ks, m = 1024, n = 2^20), whose resolved tier
    must be tpu_knn's (bf16x3 for float32, qsplit2 for the quantized
    stores). Each index is freed before the next, and the path's own peak
    of device memory stays under STORE_PEAK_LIMIT; every run is gated
    against the exact scan over the stored points (grid space for int8)."""
    import torch

    import tpu_knn_torch

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    held = torch.cuda.memory_allocated(device)   # earlier phases' live data
    k, m, n = batch
    q, r = uniform(gen, (m, k), device), uniform(gen, (n, k), device)
    for store in ("float32", "bf16", "int8"):
        ix = tpu_knn_torch.NNIndex(r, store=store)
        qs, pts = stored_space(ix, q, r)
        want = gate_stored(f"batch store={store} ({k}, {m}, 2^20) query [{ix.precision}]",
                           qs, pts, ix.query(q)[0])
        run, ops = ix.pipeline(m)
        gate_stored(f"batch store={store} pipeline({m})", qs, pts, run(q, *ops)[0], want)
        for mm in (1, 4):
            gate_stored(f"batch store={store} query m={mm}", qs[:mm], pts,
                        ix.query(q[:mm])[0], want[:mm])
        del ix, qs, pts, run, ops
    del q, r
    torch.cuda.empty_cache()
    for k in embed_ks:
        q, r = uniform(gen, (m, k), device), uniform(gen, (n, k), device)
        for store, tier in (("float32", "bf16x3"), ("bf16", "qsplit2"), ("int8", "qsplit2")):
            ix = tpu_knn_torch.NNIndex(r, store=store)
            if ix.precision != tier:
                fail(f"embed k={k} store={store}: tier {ix.precision}, tpu_knn's is {tier}")
            qs, pts = stored_space(ix, q, r)
            want = gate_stored(f"embed ({k}, {m}, 2^20) store={store} query [{tier}]", qs, pts,
                               ix.query(q)[0])
            gate_stored(f"embed ({k}, 4, 2^20) store={store} query (AoS scan)", qs[:4], pts,
                        ix.query(q[:4])[0], want[:4])
            del ix, qs, pts, want
            torch.cuda.empty_cache()
        del q, r
        torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated(device)
    log(f"  peak device memory of the store path: {(peak - held) / 2**30:.2f} GiB of its own "
        f"(limit {STORE_PEAK_LIMIT / 1e9:.0f} GB), {peak / 2**30:.2f} GiB with the "
        f"{held / 2**30:.2f} GiB that earlier phases hold")
    if peak - held > STORE_PEAK_LIMIT:
        fail(f"the store path held {peak - held} bytes at its peak, above {STORE_PEAK_LIMIT}")


def phase2_highest(device, gen):
    """"highest" 1-NN at embedding width (EMBED768, B1 in its many-chunk
    regime): fused_knn(precision="highest") per call and
    NNIndex(precision="highest") prepared, each gated against the exact
    scan. Returns the data for phase 3's times."""
    import torch

    import tpu_knn_torch
    from tpu_knn_torch.kernels.fused import fused_knn

    k, m, n = EMBED768
    q, r = uniform(gen, (m, k), device), uniform(gen, (n, k), device)
    want = gate_stored(f"embed ({k}, {m}, 2^20) per-call fused_knn precision='highest'", q, r,
                       fused_knn(q, r, precision="highest")[0])
    ix = tpu_knn_torch.NNIndex(r, precision="highest")
    gate_stored(f"embed ({k}, {m}, 2^20) NNIndex(precision='highest').query", q, r,
                ix.query(q)[0], want)
    del ix, want
    torch.cuda.empty_cache()
    return q, r


#: The store path frees each index before the next: at k = 768 the f32
#: index holds 3 GiB in each of two layouts, and the peak stays under this.
STORE_PEAK_LIMIT = 20e9


#: The H100's dense bf16 tensor-core peak (NVIDIA's data sheet, SXM, 700 W).
BF16_PEAK_FLOPS = 989e12

#: Bytes written between launches to push an operand out of the 50 MB L2.
L2_FLUSH_BYTES = 256 << 20


def phase3_tiers(card, device, gen, reps, ds11=DS11, n_embed=1 << 20):
    """Times of each tier's kernel at its main-path shape beside its plain
    version, B1 at "highest" on the same shape (the f32 operand of the
    same points), and the "matmul part" (cuBLAS's bf16 torch.matmul of the
    (m, k) x (k, n) product: a part of the work, not the same function);
    B12 and B2-bf16 likewise; then the end-to-end tier and store calls.
    Returns (times, bounds: row -> (ms, by))."""
    import torch

    import tpu_knn_torch
    from tpu_knn_torch.kernels import fused, smallm, tiers
    from tpu_knn_torch.kernels.fused import fused_knn, prep_soa
    from tpu_knn_torch.utils.timing import time_ms

    times, bounds = {}, {}
    rows = [  # row, precision, operand kind, (k, m, n)
        ("B1 packed3", "packed", "f32", ds11), ("B1 packed2", "packed", "f32", (32, *ds11[1:])),
        ("B1 bf16x4", "bf16x4", "f32", ds11), ("B1 default", "default", "f32", ds11),
        ("B12", "bf16x3_presplit", "presplit", ds11),
        ("B1 packed3 (bf16 store)", "packed", "bf16", ds11),
        ("B1 bf16x3 k=128", "bf16x3", "f32", (128, ds11[1], n_embed)),
        ("B1 qsplit2 k=128", "qsplit2", "bf16", (128, ds11[1], n_embed)),
        ("B1 bf16x3", "bf16x3", "f32", (768, ds11[1], n_embed)),
        ("B1 qsplit2", "qsplit2", "bf16", (768, ds11[1], n_embed)),
    ]
    for row, precision, kind, (k, m, n) in rows:
        q, pts, ops = tier_operands(gen, device, kind, k, m, n)
        parts = tiers.tier_parts(precision, m, k, n)
        r_f32 = prep_soa(pts, ops[0].shape[1])
        p1 = fused.tiled_parts(m, k, n)
        q_bf, r_bf = q.to(torch.bfloat16), pts.T.contiguous().to(torch.bfloat16)
        plain_reps = 3 if k >= 128 else reps
        times.update(time_ms({
            f"{row} kernel": lambda: tiers.tier_candidates(q, ops, n, parts, precision),
            f"{row} B1 highest": lambda: fused.fused_candidates(q, r_f32, n, p1),
            f"{row} matmul part": lambda: torch.matmul(q_bf, r_bf),
        }, reps))
        times.update(time_ms({f"{row} plain": lambda: tiers.tier_candidates_plain(
            q, ops, n, parts, precision)}, plain_reps, warmup=1))
        # The tensor-core kernel and, but for B12, the norm pass before it.
        times[f"{row} kernel device"] = kernel_device_ms(
            lambda: tiers.tier_candidates(q, ops, n, parts, precision), plain_reps, card,
            ("CandidatesEpi", "tensor_candidates_norms"), 1 if kind == "presplit" else 2)
        k16 = -(-k // 16) * 16
        terms = len(tiers.term_list(precision, k))
        if kind in ("bf16", "int8"):
            terms = sum(1 for _, j in tiers.term_list(precision, k) if j == 0)
        op_bytes = {"f32": 4 * k * n, "bf16": 2 * k * n, "int8": 2 * k * n,
                    "presplit": 4 * k16 * n + 4 * n}[kind]
        bounds[row] = roofline(4 * m * k + op_bytes + 8 * m * 128, terms * 2 * m * n * k16,
                               peak=BF16_PEAK_FLOPS)
        log(f"  {row}: {precision} over the {kind} operand at (k={k}, m={m}, n={n}), P={parts}, "
            f"{terms} terms; B1 'highest' at P={p1}")
        del q, pts, ops, r_f32, q_bf, r_bf
        torch.cuda.empty_cache()
    # B2-bf16 and B2 at the prepared m = 4 query of the batch-store shape,
    # both at B2-bf16's P.
    k, m, n = 16, 4, ds11[2]
    q = uniform(gen, (m, k), device)
    r_bf = prep_soa(uniform(gen, (n, k), device).to(torch.bfloat16), n)
    r_up, p2 = r_bf.float(), smallm.bf16_parts(n)
    times.update(time_ms({
        "B2-bf16 kernel": lambda: smallm.smallm_candidates(q, r_bf, n, p2),
        "B2-bf16 plain": lambda: smallm.smallm_candidates_plain(q, r_bf, n, p2),
        "B2 kernel (16, 4, 2^20)": lambda: smallm.smallm_candidates(q, r_up, n, p2),
    }, reps))
    bounds["B2-bf16"] = roofline(4 * m * k + 2 * k * n + 8 * m * 128, 3 * m * n * k)
    times["B2-bf16 kernel device"] = kernel_device_ms(
        lambda: smallm.smallm_candidates(q, r_bf, n, p2), reps, card,
        kernel="smallm_bf16_candidates_kernel")
    # Again with the operand out of L2 (33.5 MB fits its 50 MB): a 256 MB
    # write before each launch, which the name filter leaves out.
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=device)
    times["B2-bf16 kernel device L2 flushed"] = kernel_device_ms(
        lambda: (flush.fill_(1.0), smallm.smallm_candidates(q, r_bf, n, p2)), reps, card,
        kernel="smallm_bf16_candidates_kernel")
    log(f"  B2-bf16 (16, 4, 2^20): P = {p2}, load width {smallm.bf16_load_width(r_bf, m)}")
    del q, r_bf, r_up, flush
    stamp("tier kernel times")
    # End to end: ds11 per call and prepared by tier, the batch stores.
    k, m, n = ds11
    q, r = uniform(gen, (m, k), device), uniform(gen, (n, k), device)
    ix_packed = tpu_knn_torch.NNIndex(r)
    ix_presplit = tpu_knn_torch.NNIndex(r, precision="bf16x3_presplit")
    fns = {"ds11 per-call fused_knn (v4, packed)": lambda: fused_knn(q, r),
           "ds11 per-call fused_knn precision='highest'": lambda: fused_knn(q, r, precision="highest"),
           "ds11 per-call fused_knn precision='bf16x3_presplit'":
               lambda: fused_knn(q, r, precision="bf16x3_presplit"),
           "ds11 prepared NNIndex.query (packed)": lambda: ix_packed.query(q),
           "ds11 prepared NNIndex.query (bf16x3_presplit)": lambda: ix_presplit.query(q)}
    for store in ("float32", "bf16", "int8"):
        ix = tpu_knn_torch.NNIndex(r, store=store)
        run, ops = ix.pipeline(m)
        fns[f"batch store={store} query (16, 1024, 2^20)"] = lambda ix=ix: ix.query(q)
        fns[f"batch store={store} pipeline(1024)"] = lambda run=run, ops=ops: run(q, *ops)
        fns[f"batch store={store} query m=1"] = lambda ix=ix: ix.query(q[:1])
        fns[f"batch store={store} query m=4"] = lambda ix=ix: ix.query(q[:4])
    times.update(time_ms(fns, reps))
    del fns, ix, ix_packed, ix_presplit, run, ops, q, r
    torch.cuda.empty_cache()
    stamp("tier and store end-to-end times")
    for k in (128, 768):
        q, r = uniform(gen, (ds11[1], k), device), uniform(gen, (n_embed, k), device)
        for store in ("float32", "bf16", "int8"):
            ix = tpu_knn_torch.NNIndex(r, store=store)
            times.update(time_ms({f"embed k={k} store={store} query [{ix.precision}]":
                                  lambda: ix.query(q)}, 5))
            del ix
            torch.cuda.empty_cache()
        del q, r
        torch.cuda.empty_cache()
    for name, ms in times.items():
        log(f"  time {name}: median {ms:.4f} ms [{card}]")
    for name, (ms, by) in bounds.items():
        log(f"  bound {name}: {ms:.4f} ms ({by})")
    return times, bounds


# ---- phase 3: times ------------------------------------------------------


def phase3(card: str, big11, big9, reps: int):
    import tpu_knn_torch
    from tpu_knn_torch.kernels import fused, smallm
    from tpu_knn_torch.kernels.fused import fused_knn
    from tpu_knn_torch.utils.timing import time_ms

    q, r, index11 = big11
    q9, r9, index9 = big9
    k, m, n = q.shape[1], q.shape[0], r.shape[0]
    r_op, (r_op9,) = index11.r_ops[0], index9.r_ops
    p1 = fused.tiled_parts(m, k, n)
    p2 = smallm.default_parts(r9.shape[0])
    times = {}
    times.update(time_ms({
        "B1 kernel ds11": lambda: fused.fused_candidates(q, r_op, n, p1),
        "B1 plain ds11": lambda: fused.fused_candidates_plain(q, r_op, n, p1),
    }, reps))
    times.update(time_ms({
        "B2 kernel ds9": lambda: smallm.smallm_candidates(q9, r_op9, r9.shape[0], p2),
        "B2 plain ds9": lambda: smallm.smallm_candidates_plain(q9, r_op9, r9.shape[0], p2),
    }, reps))
    times.update(time_ms({
        "ds11 per-call knn_callback default (v7)":
            lambda: tpu_knn_torch.knn_callback(k, m, n, q, r),
        "ds11 per-call fused_knn (v4)": lambda: fused_knn(q, r),
        "ds11 prepared NNIndex.query": lambda: index11.query(q),
        "ds9 prepared NNIndex.query (B2)": lambda: index9.query(q9),
        "ds9 per-call fused_knn (AoS scan)": lambda: fused_knn(q9, r9),
        "ds9 per-call knn_callback default (v7)":
            lambda: tpu_knn_torch.knn_callback(q9.shape[1], 1, r9.shape[0], q9, r9),
    }, reps))
    for name, ms in times.items():
        log(f"  time {name}: median {ms:.4f} ms over {reps} runs [{card}]")
    times["B1 kernel ds11 device"] = kernel_device_ms(
        lambda: fused.fused_candidates(q, r_op, n, p1), reps, card)
    times["B2 kernel ds9 device"] = kernel_device_ms(
        lambda: smallm.smallm_candidates(q9, r_op9, r9.shape[0], p2), reps, card,
        kernel="smallm_candidates_kernel")
    return times


def kernel_device_ms(fn, reps: int, card: str, kernel="tiled_candidates",
                     count: int = 1) -> float:
    """The own device time per call of fn's `count` kernels whose names
    hold `kernel`, or any of a tuple of names (B1, B4, v3 or v6: the tiled
    kernel; B10: its TMA instance; B3: it and the partition merge; B7: the
    tiled moments kernel; the compactor; a tensor-core instance: its
    epilogue's kernel and the norm pass), summed, from torch.profiler and
    logged: the CUDA-event time around the wrapper also holds its host
    launch path, during which the card waits."""
    from tpu_knn_torch.utils.timing import device_ms

    got = device_ms({"fn": fn}, kernel, reps)
    if len(got) != count:
        fail(f"expected {count} {kernel} kernel(s) in the profile, got {sorted(got)}")
    for name, ms in got.items():
        log(f"  device time of {name[:70]}: mean {ms:.4f} ms over {reps} calls [{card}]")
    return sum(got.values())


#: "highest" 1-NN at embedding width: B1 at k = 768 (the tiled f32
#: kernel's many-chunk regime).
EMBED768 = (768, 1024, 1 << 20)


def phase3_highest(card: str, q, r, reps: int):
    """B1 at EMBED768 (its plain version, cuBLAS's f32 product of the same
    scores, and fused_knn(precision="highest") end to end), on phase 2's
    data there."""
    import torch

    from tpu_knn_torch.kernels import fused
    from tpu_knn_torch.kernels.fused import fused_knn, prep_soa
    from tpu_knn_torch.utils.timing import time_ms

    k, m, n = EMBED768
    r_op, parts = prep_soa(r, n), fused.tiled_parts(m, k, n)
    times = time_ms({
        "B1 kernel (768, 1024, 2^20)": lambda: fused.fused_candidates(q, r_op, n, parts),
        "B1 plain (768, 1024, 2^20)": lambda: fused.fused_candidates_plain(q, r_op, n, parts),
        "matmul (768, 1024, 2^20)": lambda: torch.matmul(q, r_op[:k]),
        "fused_knn highest (768, 1024, 2^20)": lambda: fused_knn(q, r, precision="highest"),
    }, reps, warmup=1)
    for name, ms in times.items():
        log(f"  time {name}: median {ms:.4f} ms over {reps} runs [{card}] (P = {parts})")
    times["B1 kernel (768, 1024, 2^20) device"] = kernel_device_ms(
        lambda: fused.fused_candidates(q, r_op, n, parts), reps, card)
    del q, r, r_op
    torch.cuda.empty_cache()
    return times


def phase3_topk(card: str, ctx, calls, reps: int):
    """Times of B4, B5 and B6 and their plain versions at the main path's
    shapes (B5 at (16, 8, 2^20) K = 32 and (16, 32, 2^20) K = 8, B6 at
    (16, 4, 2^24) K = 16; by events, and by device time), _finalize_topk
    over each kernel's candidates, the cuBLAS f32 product of B4's and B5's
    score matrices (a part of their work, not the same function), and
    each phase-2 top-K call. Returns (times, shapes), shapes holding what
    bound_ms needs."""
    import torch

    from tpu_knn_torch.kernels import fused, smallm, topk
    from tpu_knn_torch.kernels.fused import prep_soa
    from tpu_knn_torch.utils.timing import device_ms, time_ms

    q1024, q8, q32, q4, r20 = ctx["q1024"], ctx["q8"], ctx["q32"], ctx["q4"], ctx["r20"]
    r24 = ctx["r24"]
    n20 = r20.shape[0]
    r_op20 = prep_soa(r20, n20)
    r_op24 = ctx["index24"].r_ops[0]
    n24 = ctx["index24"].n
    p4 = fused.tiled_parts(q1024.shape[0], 16, n20)
    i1, s1 = topk._lex_min(*fused.fused_candidates(q1024, r_op20, n20, p4))
    p5, p5b = topk.sweep_parts(q8.shape[0], 16, n20), topk.sweep_parts(q32.shape[0], 16, n20)
    p6 = topk.smallm_topk_parts(n24, 16)
    _, cs1 = smallm.smallm_candidates(q4, r_op24, n24, smallm.default_parts(n24))
    b6 = torch.topk(cs1, 16, dim=-1, largest=False).values[:, -1].contiguous()
    b5 = topk.sweep_candidates(q8, r_op20, n20, p5, 32)
    b5b = topk.sweep_candidates(q32, r_op20, n20, p5b, 8)
    c6 = topk.smallm_topk_candidates(q4, r_op24, n24, p6, 16, b6)
    times = {}
    times.update(time_ms({
        "B4 kernel ds11": lambda: fused.banded_candidates(q1024, r_op20, n20, p4, s1, i1),
        "B4 plain ds11": lambda: fused.banded_candidates_plain(q1024, r_op20, n20, p4, s1, i1),
        "matmul ds11": lambda: torch.matmul(q1024, r_op20[:16]),
    }, reps))
    b5_fns = {
        "B5 kernel (16, 8, 2^20) K=32": lambda: topk.sweep_candidates(q8, r_op20, n20, p5, 32),
        "B5 kernel (16, 32, 2^20) K=8": lambda: topk.sweep_candidates(q32, r_op20, n20, p5b, 8),
    }
    times.update(time_ms({
        **b5_fns,
        "B5 plain (16, 8, 2^20) K=32":
            lambda: topk.sweep_candidates_plain(q8, r_op20, n20, p5, 32),
        "matmul (16, 8, 2^20)": lambda: torch.matmul(q8, r_op20[:16]),
    }, reps))
    b6_fn = {"B6 kernel (16, 4, 2^24) K=16":
             lambda: topk.smallm_topk_candidates(q4, r_op24, n24, p6, 16, b6)}
    times.update(time_ms({
        **b6_fn,
        "B6 plain (16, 4, 2^24) K=16":
            lambda: topk.smallm_topk_candidates_plain(q4, r_op24, n24, p6, 16, b6),
    }, reps))
    select_fns = {
        "selection over B5 (16, 8, 2^20) K=32":
            lambda: topk._finalize_topk(q8, r20, *b5, 32, n20),
        "selection over B5 (16, 32, 2^20) K=8":
            lambda: topk._finalize_topk(q32, r20, *b5b, 8, n20),
        "selection over B6 (16, 4, 2^24) K=16":
            lambda: topk._finalize_topk(q4, r24, *c6, 16, n24),
    }
    times.update(time_ms(select_fns, reps))
    times.update(time_ms({name: fn for name, (_, _, _, fn) in calls.items()}, reps))
    for name, ms in times.items():
        log(f"  time {name}: median {ms:.4f} ms over {reps} runs [{card}]")
    times["B4 kernel ds11 device"] = kernel_device_ms(
        lambda: fused.banded_candidates(q1024, r_op20, n20, p4, s1, i1), reps, card)
    for name, fn in b5_fns.items():
        times[f"{name} device"] = kernel_device_ms(fn, reps, card, kernel="sweep_kselect")
    for name, fn in b6_fn.items():
        times[f"{name} device"] = kernel_device_ms(fn, reps, card, kernel="smallm_kselect")
    for name, fn in select_fns.items():
        got = device_ms({"fn": fn}, "", reps)
        times[f"{name} device"] = sum(got.values())
        log(f"  device time of {name}: {times[f'{name} device']:.4f} ms a call over {reps} "
            f"calls, {len(got)} kernels [{card}]")
    m4, m5, m6 = q1024.shape[0], q8.shape[0], q4.shape[0]
    log(f"  B5 partitions (lists a row): {p5} at (16, 8, 2^20) (TM "
        f"{topk.sweep_geometry(m5, 16, n20).tm}), {p5b} at (16, 32, 2^20); B6: {p6} at 2^24")
    # The contract's outputs: K entries a row (one list's worth), however
    # many partitions a launch picks.
    shapes = {"B4": (m4, 16, n20, 128, 8 * m4),
              "B5": (m5, 16, n20, 32, 0),
              "B6": (m6, 16, n24, 16, 4 * m6)}
    return times, shapes


def seeded_launches(q, r_op, n, kk):
    """The inputs the seeded engine gives B3, B7 and the compactor for
    (q, operand, K), computed as kernels/seeded.py computes them (B3 and
    B7 with the queries' transposed copy made once, q_t in b3)."""
    from tpu_knn_torch.kernels import fused, seeded

    m, k = q.shape
    g = seeded.seeded_geometry(m, n, k, kk, r_op.shape[1])
    q_t = fused.transposed_queries(q)
    b3 = dict(depth=g["depth"], n_limit=g["p1_limit"], q_t=q_t)
    cs1 = fused.minima_candidates(q, r_op, n, **b3)
    bound = seeded._inflate_bound(seeded._kth_smallest(cs1, kk))
    b7 = (bound, g["cell"], g["n_fields"])
    moms = seeded.extract_moments(q, r_op, n, *b7, q_t=q_t)
    fields = [f.contiguous() for f in moms[:2 if g["n_fields"] == 8 else 1]]
    return g, b3, b7, (fields, g["nparts"], min(g["cap_fast"], g["nc"] // g["nparts"]))


def phase3_seeded(card, ctx, calls, reps):
    """Times of B3, B7 and the compactor and their plain versions at the
    seeded path's ds11 K = 8 and K = 64 launches (the compactor also at
    (16, 1024, 2^22) K = 8, part width 16384), and of each phase-2 seeded
    call. Returns (times, bounds: name -> (ms, by))."""
    import functools

    import torch

    from tpu_knn_torch.kernels import fused, seeded
    from tpu_knn_torch.kernels.fused import prep_soa
    from tpu_knn_torch.utils.timing import time_ms

    q, r20, r22 = ctx["q1024"], ctx["r20"], ctx["r22"]
    m, k = q.shape
    times, bounds = {}, {}
    for label, r, kk in (("ds11 K=8", r20, 8), ("ds11 K=64", r20, 64),
                         ("(16, 1024, 2^22) K=8", r22, 8)):
        n = r.shape[0]
        r_op = prep_soa(r, n)
        g, b3, b7, comp = seeded_launches(q, r_op, n, kk)
        fields, parts, cap = comp
        if label != "(16, 1024, 2^22) K=8":
            b3_kernel = functools.partial(fused.minima_candidates, q, r_op, n, **b3)
            b7_kernel = functools.partial(seeded.extract_moments, q, r_op, n, *b7, q_t=b3["q_t"])
            times.update(time_ms({
                f"B3 kernel {label}": b3_kernel,
                f"B3 plain {label}": lambda: fused.minima_candidates_plain(
                    q, r_op, n, b3["depth"], None, b3["n_limit"]),
                f"B7 kernel {label}": b7_kernel,
                f"B7 plain {label}": lambda: seeded.extract_moments_plain(q, r_op, n, *b7),
            }, reps))
            # The kernels' own device time (B3: the tiled kernel and the
            # partition merge), beside the event time above.
            times[f"B3 kernel {label} device"] = kernel_device_ms(b3_kernel, reps, card,
                                                                 "minima", 2)
            times[f"B7 kernel {label} device"] = kernel_device_ms(b7_kernel, reps, card,
                                                                 "tiled_moments")
            n_read = n if b3["n_limit"] is None else min(n, b3["n_limit"])
            bounds[f"B3 {label}"] = roofline(
                4 * (m * k + k * n_read + m * 128 * b3["depth"]), 2 * m * n_read * k)
            bounds[f"B7 {label}"] = roofline(
                4 * (m * k + k * n + m + m * g["nc"] * len(fields)), 2 * m * n * k + m * n)
        comp_kernel = functools.partial(seeded.compact_cells, fields, parts, cap)
        times.update(time_ms({
            f"compactor kernel {label}": comp_kernel,
            f"compactor plain {label}": lambda: seeded.compact_cells_plain(fields, parts, cap),
        }, reps))
        times[f"compactor kernel {label} device"] = kernel_device_ms(comp_kernel, reps, card,
                                                                    "compact_cells")
        nf = len(fields)
        bounds[f"compactor {label}"] = roofline(
            4 * (m * g["nc"] * nf + m * parts * cap * (nf + 1)), 0)
        log(f"  seeded launches {label}: cell {g['cell']}, fields {g['n_fields']}, "
            f"nc {g['nc']}, B3 depth {b3['depth']} prefix {b3['n_limit']}, compaction "
            f"{parts} part(s) x cap {cap} (part width {g['nc'] // parts})")
        del r_op
    times.update(time_ms({"matmul ds11 (seeded)": lambda: torch.matmul(q, ctx["r20"].T)},
                         reps))
    graph = {name: v for name, v in calls.items() if name.startswith("knn_graph")}
    times.update(time_ms({name: fn for name, (_, _, _, fn) in calls.items()
                          if name not in graph}, reps))
    times.update(time_ms({name: fn for name, (_, _, _, fn) in graph.items()}, 3))
    for name, ms in times.items():
        log(f"  time {name}: median {ms:.4f} ms [{card}]")
    for name, (ms, by) in bounds.items():
        log(f"  bound {name}: {ms:.4f} ms ({by})")
    return times, bounds


def profile_busy(fn, calls: int):
    """(device ms, wall ms) per call of fn: the wall by the host clock
    without the profiler, the device time summed over the CUDA kernels
    torch.profiler records in a second run of as many calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / calls
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = sum(e.device_time for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / calls
    return dev, wall


def phase3_ladder(card, big, auto_ctx, reps):
    """Times of B10 (ds11, ds9), B11 (the auto path's (3, 16, 2^24) launch,
    at its default splits and at one split) and B1's variants (ds11 and
    ds9, also by device time, with their bounds), each beside its plain
    version and B1 at the same partition count; the
    runner's rows per call (v1..v7 at ds11 and ds9, v11 at ds8 and ds10);
    prepared auto at m = 16 against prepared fused on the same points, with
    the device time, wall time and idle per host read of each; and the
    projection index's build. Returns (times, bounds)."""
    import torch

    import tpu_knn_torch
    from tpu_knn_torch.kernels import dma_pipeline, fused, projection
    from tpu_knn_torch.kernels.fused import prep_soa
    from tpu_knn_torch.kernels.tuning import resident_geometry
    from tpu_knn_torch.utils.timing import time_ms

    times, bounds = {}, {}
    for label, shape in (("ds11", DS11), ("ds9", DS9)):
        k, m, n = shape
        q, r = big[shape]
        r_op = prep_soa(r, n)
        p1 = fused.tiled_parts(m, k, n)   # B10's, v3's and v6's P at ds11 and ds9
        if resident_geometry(m, k, n).parts != p1:
            fail(f"{label}: v6's P {resident_geometry(m, k, n).parts} is not v3's {p1}")
        b10 = {
            f"B10 kernel {label}": lambda: dma_pipeline.dma_candidates(q, r_op, n, p1),
            f"B1 kernel {label} at B10's P": lambda: fused.fused_candidates(q, r_op, n, p1),
        }
        fns = {**b10, f"B10 plain {label}": lambda: dma_pipeline.dma_candidates_plain(
            q, r_op, n, p1)}
        # B1's variants beside B1 at their P (tiled_parts: both variants'
        # own at ds11 and ds9), in turns.
        variants = {
            f"B1 AoS (v3) kernel {label}": lambda: fused.aos_candidates(q, r, n, p1),
            f"B1 constant-query (v6) kernel {label}":
                lambda: fused.const_query_candidates(q, r_op, n, p1),
            f"B1 kernel {label} at the variants' P": lambda: fused.fused_candidates(
                q, r_op, n, p1),
        }
        fns.update(variants)
        if label == "ds11":
            fns[f"B1 plain {label} at the variants' P"] = lambda: fused.fused_candidates_plain(
                q, r_op, n, p1)
        times.update(time_ms(fns, reps))
        # B10 (the TMA instance) and B1 at the same P, and the variants, by
        # the kernels' own device time.
        for name, fn in variants.items():
            times[f"{name} device"] = kernel_device_ms(fn, reps, card)
        times[f"B10 kernel {label} device"] = kernel_device_ms(
            b10[f"B10 kernel {label}"], reps, card, "tma_candidates")
        times[f"B1 kernel {label} at B10's P device"] = kernel_device_ms(
            b10[f"B1 kernel {label} at B10's P"], reps, card)
        bounds[f"B10 {label}"] = roofline(4 * (m * k + k * n + m * 128), 2 * m * n * k)
        bounds[f"B1 variants {label}"] = bound(m, k, n, 128, 0, 2)
        log(f"  B10, v3 and v6 {label}: P = {p1}, TM B10 and v3 "
            f"{fused.tiled_geometry(m, k, n).tm}, v6 {resident_geometry(m, k, n).tm}")
        del r_op

    r, q16, auto, fused_ix = (auto_ctx[key] for key in ("r", "q16", "auto", "fused"))
    n, k = r.shape
    index = auto.proj_index
    window = projection.auto_window(k, n)
    w_tiles = projection.window_tiles(n, window)
    w = min(window, n)
    pos = torch.searchsorted(index[3], projection._axis_column(q16, index[2]))
    tiles = ((pos - w // 2).clamp(0, max(n - w, 0)) // projection.TILE_W).to(torch.int32)
    splits = projection.window_splits(16, w_tiles)
    times.update(time_ms({
        "B11 kernel (3, 16, 2^24)": lambda: projection.window_candidates(
            q16, index[6], tiles, w_tiles, splits),
        "B11 kernel (3, 16, 2^24) one split": lambda: projection.window_candidates(
            q16, index[6], tiles, w_tiles, 1),
        "B11 plain (3, 16, 2^24)": lambda: projection.window_candidates_plain(
            q16, index[6], tiles, w_tiles, splits),
    }, reps))
    times["B11 kernel (3, 16, 2^24) device"] = kernel_device_ms(
        lambda: projection.window_candidates(q16, index[6], tiles, w_tiles, splits), reps, card,
        kernel="window_candidates")
    bounds["B11"] = window_bound(q16, tiles, w_tiles)
    log(f"  B11 (3, 16, 2^24): window {window}, {w_tiles} tiles, {splits} splits")
    # B11 at v11's per-call launches: ds8 (m = 1) and ds10 (m = 1024, one
    # split; neighbouring windows overlap, so much of it comes from L2).
    for label, shape in (("ds8", DS8), ("ds10", DS10)):
        k_, m_, n_ = shape
        q_, r_ = big[shape]
        index_ = projection.build_projection_index(r_)
        window_ = projection.auto_window(k_, n_)
        w_tiles_ = projection.window_tiles(n_, window_)
        w_ = min(window_, n_)
        pos_ = torch.searchsorted(index_[3], projection._axis_column(q_, index_[2]))
        tiles_ = ((pos_ - w_ // 2).clamp(0, max(n_ - w_, 0)) // projection.TILE_W).to(
            torch.int32)
        splits_ = projection.window_splits(m_, w_tiles_)
        name = f"B11 kernel {label}"
        fn = (lambda q_=q_, r_aug=index_[6], t=tiles_, wt=w_tiles_, s=splits_:
              projection.window_candidates(q_, r_aug, t, wt, s))
        times.update(time_ms({name: fn}, reps))
        times[f"{name} device"] = kernel_device_ms(fn, reps, card, kernel="window_candidates")
        bounds[f"B11 {label}"] = window_bound(q_, tiles_, w_tiles_)
        log(f"  B11 {label} {shape}: window {window_}, {w_tiles_} tiles, {splits_} splits")
        del index_, q_, r_
    stamp("B10, B11 and B1 variant times")

    for label, shape, versions in (
            ("ds11", DS11, ("v1", "v2", "v3", "v4", "v5", "v6", "v7")),
            ("ds9", DS9, ("v1", "v2", "v3", "v4", "v5", "v6", "v7")),
            ("ds8", DS8, ("v3", "v5", "v6", "v11")), ("ds10", DS10, ("v3", "v5", "v6", "v11"))):
        k_, m_, n_ = shape
        q, rr = big[shape]
        times.update(time_ms({
            f"{v} per call {label}": lambda v=v, q=q, rr=rr: tpu_knn_torch.knn_callback(
                k_, m_, n_, q, rr, version=v) for v in versions}, 5))
    stamp("the ladder's per-call times")

    before = dict(projection.TALLY)
    times.update(time_ms({
        "prepared auto m=16 (3, 2^24)": lambda: auto.query(q16),
        "prepared fused m=16 (3, 2^24)": lambda: fused_ix.query(q16),
    }, reps))
    for label, ix in (("prepared auto m=16 (3, 2^24)", auto),
                      ("prepared fused m=16 (3, 2^24)", fused_ix)):
        # The first torch.profiler session pays CUPTI's start-up (12-15 s
        # on the card's machine); the second takes under a second.
        dev, wall = profile_busy(lambda ix=ix: ix.query(q16), 5)
        # One host read per call: the certificate (projection path) or
        # _refine_guarded's cutoff check (fused path).
        times[f"{label} device"], times[f"{label} wall"] = dev, wall
        log(f"  {label}: device {dev:.4f} ms, wall {wall:.4f} ms per call (busy share "
            f"{dev / wall:.3f}), 1 host read per call, idle {wall - dev:.4f} ms per read "
            f"[{card}]")
    stamp("auto and fused prepared times, profiled")
    tally = {t: c - before[t] for t, c in projection.TALLY.items()}
    log(f"  auto route after the timings: {auto.last_strategy}; projection tally {tally}; "
        f"realized certification {auto.realized_cert_rate}")
    if auto.last_strategy != "projection" or tally["fallback_batches"]:
        fail(f"timed auto calls left the certified projection path: {tally}")
    times.update(time_ms({"build_projection_index (3, 2^24)":
                          lambda: projection.build_projection_index(r)}, 3))
    for name, ms in times.items():
        log(f"  time {name}: median {ms:.4f} ms [{card}]")
    for name, (ms, by) in bounds.items():
        log(f"  bound {name}: {ms:.4f} ms ({by})")
    return times, bounds


def window_bound(q, tiles, w_tiles):
    """B11's bound at this launch: the k + 1 operand rows of the columns
    the windows cover (their union: neighbouring queries' windows overlap,
    and an input counts once), the queries, the tile starts and the (m,
    128) contract written once; 2 flops a coordinate of each (query,
    window column)."""
    import torch

    from tpu_knn_torch.kernels.projection import TILE_W

    m, k = q.shape
    covered = torch.unique(tiles.long()[:, None] + torch.arange(w_tiles, device=q.device))
    return roofline(4 * (covered.numel() * TILE_W * (k + 1) + m * k + m + m * 128),
                    2 * m * w_tiles * TILE_W * (k + 1))


#: The card's published peaks (one H100 SXM at 700 W): f32 on the CUDA
#: cores, and device-memory bandwidth.
F32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def roofline(nbytes, flops, peak=F32_PEAK_FLOPS):
    """(ms, "bytes" or "operations"): the larger of nbytes over the memory
    rate and flops over the peak of their type (f32 on the CUDA cores by
    default; BF16_PEAK_FLOPS for the tensor-core tiers, whose flops count
    the tier's T terms: T·2·m·n·k16)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bound(m, k, n, width, extra_bytes, flops_per_term):
    """The least time (ms) the card could take for a candidate launch:
    the larger of its bytes (queries and the k used rows of the operand
    read once, the (m, width) int32 + f32 candidates written once, plus
    extra_bytes of bounds) over the memory rate, and its flops
    (flops_per_term * m * n * k) over the f32 peak. width is what the
    kernel's contract must emit (128 lanes, or K * 128 for a top-K
    kernel), not the P-partition width a launch chose, so a wider grid
    cannot raise the bound."""
    return roofline(4 * (m * k + k * n) + 8 * m * width + extra_bytes,
                    flops_per_term * m * n * k)


def check_kdtree_frames(ptxas):
    """Fail unless every v10 instance (kdtree_traverse_kernel<K, G>) has
    a stack frame of 0 bytes in ptxas's report: its query, record and
    stack live in registers and shared memory, none in local memory."""
    import re

    entry, checked = None, 0
    for line in ptxas:
        got = re.search(r"Function properties for '?(\w+)", line)
        if got:
            entry = got.group(1)
            continue
        frame = re.search(r"(\d+) bytes stack frame", line)
        if entry and "kdtree_traverse_kernel" in entry and frame:
            if int(frame.group(1)):
                fail(f"v10: {entry} keeps {frame.group(1)} bytes in local memory")
            checked += 1
            entry = None
    if checked != 2 * 16:
        fail(f"checked {checked} v10 instances' stack frames, expected {2 * 16}")
    log(f"  v10: no local memory in any of its {checked} instances")


def check_no_spills(ptxas, kernels):
    """Fail if ptxas's report (-v) shows spill stores or loads in any
    instantiation of a kernel whose mangled name matches the pattern
    kernels[kid]; log each kernel's instantiations and their registers.
    Returns {mangled name: static shared-memory bytes} of the matched
    entries."""
    import re

    entry, seen, smem = None, {kid: [] for kid in kernels}, {}
    for line in ptxas:
        got = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if got:
            entry = got.group(1)
            continue
        kid = next((kid for kid, pat in kernels.items() if entry and re.search(pat, entry)),
                   None)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        regs = re.search(r"Used (\d+) registers", line)
        if kid and spill and (int(spill.group(1)) or int(spill.group(2))):
            fail(f"{kid}: ptxas spills in {entry}: {line.strip()}")
        if kid and regs:
            seen[kid].append(int(regs.group(1)))
            got_smem = re.search(r"(\d+) bytes smem", line)
            smem[entry] = int(got_smem.group(1)) if got_smem else 0
    for kid, regs in seen.items():
        if not regs:
            fail(f"{kid}: no {kernels[kid]} instantiation in the ptxas report")
        log(f"  {kid} ({kernels[kid]}): {len(regs)} instantiations, registers {sorted(regs)}, "
            "no spills")
    return smem


#: The tiled f32 kernel's instances in ptxas's report (mangled
#: tiled_candidates_kernel<TM, BANDED, AOS, QRES>, and B10's
#: tma_candidates_kernel<TM>).
TILED_ENTRY = r"tiled_candidates_kernelILi(\d+)ELb([01])ELb([01])ELb([01])E"
TMA_ENTRY = r"tma_candidates_kernelILi(\d+)E"


#: B5's and B6's instances in ptxas's report (mangled
#: sweep_kselect_kernel<TM>, smallm_kselect_kernel<M, KMAX>).
SWEEP_ENTRY = r"sweep_kselect_kernelILi(\d+)E"
SMALLM_TOPK_ENTRY = r"smallm_kselect_kernelILi(\d+)ELi(\d+)E"

#: Their bf16 instances (sweep_bf16_kselect_kernel<TM>,
#: smallm_bf16_kselect_kernel<M, V>).
SWEEP_BF16_ENTRY = r"sweep_bf16_kselect_kernelILi(\d+)E"
SMALLM_BF16_TOPK_ENTRY = r"smallm_bf16_kselect_kernelILi(\d+)ELi(\d+)E"


#: B2's, B2-bf16's and B11's instances in ptxas's report (mangled
#: smallm_candidates_kernel<M, KMAX>, smallm_bf16_candidates_kernel<M, V>,
#: window_candidates_kernel<V>).
SMALLM_ENTRY = r"smallm_candidates_kernelILi(\d+)ELi(\d+)E"
SMALLM_BF16_ENTRY = r"smallm_bf16_candidates_kernelILi(\d+)ELi(\d+)E"
WINDOW_ENTRY = r"window_candidates_kernelILi(\d+)E"


def check_scan_smem(smem):
    """Each B2-bf16 and B11 instance's static shared memory (ptxas) equals
    tuning's mirror (smallm_bf16_state_bytes, window_state_bytes): every
    (m, load width) B2-bf16 instance and both B11 widths."""
    import re

    from tpu_knn_torch.kernels import smallm, tuning

    want = {(m, v) for m in range(1, smallm.SMALLM_MAX_M + 1) for v in smallm.BF16_LOAD_WIDTHS
            if m <= smallm.BF16_WIDE_MAX_M or v <= smallm.BF16_NARROW_WIDTH}
    seen, widths = set(), set()
    for entry, nbytes in smem.items():
        bf, win = re.search(SMALLM_BF16_ENTRY, entry), re.search(WINDOW_ENTRY, entry)
        if bf:
            key = (int(bf.group(1)), int(bf.group(2)))
            mirror = tuning.smallm_bf16_state_bytes(*key)
            seen.add(key)
        elif win:
            widths.add(int(win.group(1)))
            mirror = tuning.window_state_bytes(int(win.group(1)))
        else:
            continue
        if nbytes != mirror:
            fail(f"{entry}: {nbytes} bytes of static shared memory, the mirror says {mirror}")
    if seen != want or widths != {1, 4}:
        fail(f"B2-bf16 instances {sorted(seen)} (expected {sorted(want)}), B11 widths "
             f"{sorted(widths)} (expected [1, 4])")
    log(f"  B2-bf16 and B11 instances: static shared memory as tuning.smallm_bf16_state_bytes "
        f"and window_state_bytes ({len(seen)} + {len(widths)} instances)")


def check_topk_smem(smem):
    """Each B5 and B6 instance's static shared memory (ptxas), and each of
    their bf16 instances', equals tuning's mirror (sweep_state_bytes,
    smallm_topk_state_bytes, smallm_bf16_topk_state_bytes)."""
    import re

    from tpu_knn_torch.kernels import smallm, tuning

    checked = 0
    for entry, nbytes in smem.items():
        sweep = re.search(SWEEP_ENTRY, entry) or re.search(SWEEP_BF16_ENTRY, entry)
        small = re.search(SMALLM_TOPK_ENTRY, entry)
        small_bf16 = re.search(SMALLM_BF16_TOPK_ENTRY, entry)
        if sweep:
            want = tuning.sweep_state_bytes(int(sweep.group(1)))
        elif small:
            want = tuning.smallm_topk_state_bytes(int(small.group(1)), int(small.group(2)))
        elif small_bf16:
            want = tuning.smallm_bf16_topk_state_bytes(int(small_bf16.group(1)),
                                                       int(small_bf16.group(2)))
        else:
            continue
        if nbytes != want:
            fail(f"{entry}: {nbytes} bytes of static shared memory, the mirror says {want}")
        checked += 1
    bf16_instances = sum(1 for m in range(1, smallm.SMALLM_MAX_M + 1)
                         for v in smallm.BF16_LOAD_WIDTHS
                         if m <= smallm.BF16_WIDE_MAX_M or v <= smallm.BF16_NARROW_WIDTH)
    expected = 2 * len(tuning.SWEEP_ROWS) + 4 * 3 + bf16_instances
    if checked != expected:
        fail(f"checked {checked} B5/B6 (and bf16) instances' shared memory, expected "
             f"{expected}")
    log(f"  B5 and B6 instances and their bf16 instances: static shared memory as "
        f"tuning.sweep_state_bytes, smallm_topk_state_bytes and smallm_bf16_topk_state_bytes "
        f"({checked} instances)")


#: The ladder's tier instances in ptxas's report (tensor_ladder_kernels.cu:
#: tensor_aos_kernel<T, PACKED, KC, RES, ONE, BM> and tensor_tma_kernel<...>
#: at each block height BM, 128 and 32 rows; tensor_live_kernel<T, KC, BM,
#: BPS> at 64 rows one an SM and 32 rows two).
LADDER_ENTRIES = {
    **{f"{rung}'s tier instances ({policy} staging, {bm}-row blocks)":
       rf"{kernel}I(?:L[ib]\d+E){{5}}Li{bm}EE"
       for rung, policy, kernel in (("v3", "AoS", "tensor_aos_kernel"),
                                    ("B10", "TMA", "tensor_tma_kernel"))
       for bm in (128, 32)},
    **{f"v6's live-row instances ({bm}-row blocks, {per_sm} an SM)":
       rf"tensor_live_kernelILi\d+ELi\d+ELi{bm}ELi{per_sm}EE"
       for bm, per_sm in ((64, 1), (32, 2))}}


def check_ladder_smem(smem):
    """The ladder's tier instances take no static shared memory (ptxas):
    their shared memory is the dynamic plan that tiers mirrors
    (tensor_smem for v3 and B10, B1's plan to the byte; tensor_live_smem for
    v6's live rows), and the TMA instances' ring starts at the window's
    first byte, 128-byte aligned, as their boxes need. Logs each plan at the
    main path's launches."""
    import re

    from tpu_knn_torch.kernels import tiers

    checked = 0
    for entry, nbytes in smem.items():
        if re.search("tensor_(aos|tma|live)_kernel", entry):
            if nbytes != 0:
                fail(f"{entry}: {nbytes} bytes of static shared memory, the plan has none")
            checked += 1
    # v3 16 at each block height (T = 1, 3: 16- and 32-row chunks, q resident
    # or in the ring, and the one-chunk tile; T = 4 the one-chunk tile,
    # 16-row chunks and packed2's 32-row chunk; T = 8, 9: packed3's
    # one-chunk tiles), B10 16 at each (the same, but packed2 at 16 rows),
    # v6's live rows 6 at each of their 2 plans (T = 1, 3, 4 at 16 and 32).
    if checked != 2 * 16 + 2 * 16 + 2 * 6:
        fail(f"checked {checked} ladder tier instances, expected {2 * 16 + 2 * 16 + 2 * 6}")
    plans = {f"{shape} {precision} (v3, B10, {epilogue})": tiers.tensor_smem(
                 0, tiers.term_list(precision, k), kc, k, epilogue)
             for shape, precision, k, kc in (("ds11", "packed", 16, 16),
                                             ("(768, *)", "bf16x3", 768, 32))
             for epilogue in ("ladder", "ladder-serve")}
    plans.update({
             f"({k}, {m}) bf16x3 (v6, live rows, "
             f"{tiers.tensor_live_epilogue(tiers.term_list('bf16x3', k), m, k)})":
             tiers.tensor_live_smem(tiers.term_list("bf16x3", k), m, k)
             for k, m in ((768, 16), (768, 1), (128, 128))})
    log(f"  ladder tier instances: no static shared memory ({checked} instances); dynamic "
        f"plans (tiers) {plans}")


def check_tiled_smem(smem):
    """Each v3, v6 and B10 instance's static shared memory (ptxas) equals
    the Python mirror's (tuning.candidates_state_bytes: B1's state, which
    v6's geometry adds to its ring and resident rows; B10's with its TMA
    ring's mbarriers)."""
    import re

    from tpu_knn_torch.kernels import tuning

    checked = 0
    for entry, nbytes in smem.items():
        tiled, tma = re.search(TILED_ENTRY, entry), re.search(TMA_ENTRY, entry)
        if not (tiled or tma):
            continue
        tm = int((tiled or tma).group(1))
        want = tuning.candidates_state_bytes(tm, tma=bool(tma))
        if nbytes != want:
            fail(f"{entry}: {nbytes} bytes of static shared memory, the mirror says {want}")
        checked += 1
    if checked != 3 * len(tuning.TILED_ROWS):
        fail(f"checked {checked} v3/v6/B10 instances' shared memory, expected "
             f"{3 * len(tuning.TILED_ROWS)}")
    log(f"  v3, v6 and B10 instances: static shared memory as "
        f"tuning.candidates_state_bytes ({checked} instances)")


# ---- ROADMAP A.6.1-A.6.4: bf16 instances, PAD columns, stores, metrics,
# mutable indexes and filtered views -----------------------------------------


#: The bf16 instances: launch-count key -> (wrapper module, wrapper name,
#: the f32 instance's row, the kernel's name in the profile).
BF16_ROWS = {
    "B1-bf16": ("fused", "fused_candidates", "B1", "tiled_bf16_candidates_kernel"),
    "B4-bf16": ("fused", "banded_candidates", "B4", "tiled_bf16_candidates_kernel"),
    "B3-bf16": ("fused", "minima_candidates", "B3", "bf16_minima"),
    "B5-bf16": ("topk", "sweep_candidates", "B5", "sweep_bf16_kselect"),
    "B6-bf16": ("topk", "smallm_topk_candidates", "B6", "smallm_bf16_kselect"),
    "B7-bf16": ("seeded", "extract_moments", "B7", "bf16_moments"),
}


def bf16_wrapper(kid):
    import importlib

    mod, name, _, _ = BF16_ROWS[kid]
    return getattr(importlib.import_module(f"tpu_knn_torch.kernels.{mod}"), name)


def bf16_case(gen, device, k, m, n, ld, pad=()):
    """Queries, a bf16 SoA operand (k_pad, ld) of n uniform points with the
    columns `pad` PAD_VALUE, and its exact f32 upcast."""
    import torch

    from tpu_knn_torch.engine.index import PAD_VALUE
    from tpu_knn_torch.utils.shapes import round_up

    q = uniform(gen, (m, k), device)
    r_op = torch.zeros((round_up(k, 8), ld), dtype=torch.bfloat16, device=device)
    r_op[:k, :n] = uniform(gen, (n, k), device).T
    cols = [c for c in pad if c < n]
    if cols:
        r_op[:, cols] = PAD_VALUE
    return q, r_op, r_op.float()


def same_bits(name, got, want):
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        if a.shape != b.shape or not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            fail(f"{name}: the bf16 instance differs from the f32 instance over the upcast "
                 f"operand")


def tiled_bf16_checks(tag, q, rb, rf, n, kks=(1, 8, 32), b7=True):
    """B1-, B4-, B3- (depth 1 and 2), B5- (each K) and B7-bf16 (each cell
    and mode, banded with the remainder, where ld takes the cell) bit-equal
    to their f32 instances over the upcast operand."""
    import torch

    from tpu_knn_torch.kernels import fused, seeded, topk

    m, k = q.shape
    parts = fused.tiled_parts(m, k, n)
    same_bits(f"B1-bf16 {tag}", fused.fused_candidates(q, rb, n, parts),
              fused.fused_candidates(q, rf, n, parts))
    bs = torch.full((m,), 0.25 * k, device=q.device)
    bi = torch.full((m,), n // 2, dtype=torch.int32, device=q.device)
    same_bits(f"B4-bf16 {tag}", fused.banded_candidates(q, rb, n, parts, bs, bi),
              fused.banded_candidates(q, rf, n, parts, bs, bi))
    for depth in (1, 2):
        same_bits(f"B3-bf16 depth {depth} {tag}", fused.minima_candidates(q, rb, n, depth),
                  fused.minima_candidates(q, rf, n, depth))
    p5 = topk.sweep_parts(m, k, n)
    for kk in kks:
        same_bits(f"B5-bf16 K={kk} {tag}", topk.sweep_candidates(q, rb, n, p5, kk),
                  topk.sweep_candidates(q, rf, n, p5, kk))
    if not b7:
        return
    bound = torch.full((m,), 0.2 * k, device=q.device)
    lo = torch.full((m,), 0.02 * k, device=q.device)
    for cell in (64, 128, 256):
        if rb.shape[1] % cell:
            continue
        for nf in (4, 8):
            same_bits(f"B7-bf16 cell {cell} fields {nf} {tag}",
                      seeded.extract_moments(q, rb, n, bound, cell, nf),
                      seeded.extract_moments(q, rf, n, bound, cell, nf))
        same_bits(f"B7-bf16 cell {cell} banded {tag}",
                  seeded.extract_moments(q, rb, n, bound, cell, 8, lo=lo, emit_rem=True),
                  seeded.extract_moments(q, rf, n, bound, cell, 8, lo=lo, emit_rem=True))


def b6_bf16_checks(tag, q, rb, n, kks=(1, 8, 16, 32)):
    """B6-bf16 bit-equal to B6 over the upcast operand at B6-bf16's P and at
    B6's, seeded by B2's bound, each launch made twice; its lists hold at
    least K real entries a row."""
    import torch

    from tpu_knn_torch.kernels import smallm, topk

    m, k = q.shape
    rf = rb.float()
    _, cs = smallm.smallm_candidates(q, rf, n, smallm.default_parts(n))
    for kk in kks:
        bound = torch.topk(cs, kk, dim=-1, largest=False).values[:, -1].contiguous()
        for parts in {topk.smallm_topk_operand_parts(rb, n, k), topk.smallm_topk_parts(n, k)}:
            got = topk.smallm_topk_candidates(q, rb, n, parts, kk, bound)
            same_bits(f"B6-bf16 K={kk} P={parts} {tag}", got,
                      topk.smallm_topk_candidates(q, rf, n, parts, kk, bound))
            same_bits(f"B6-bf16 K={kk} P={parts} {tag} (second launch)",
                      topk.smallm_topk_candidates(q, rb, n, parts, kk, bound), got)
            real = (got[0] < n).sum(dim=1)
            if int(real.min()) < kk:
                fail(f"B6-bf16 K={kk} {tag}: a row holds {int(real.min())} real entries")


def bf16_plain_ds11(q, rb, n, q_t):
    """The tiled bf16 instances at the main path's ds11 launches against
    their plain versions over the same bf16 operand, by the f32 rows'
    rules: B1-bf16 (compare_candidates: index agreement, scores within
    score_rtol, refined 1-NN identical), B4-bf16 (a second pass seeded by
    each version's own first, slot_agreement), B3-bf16 at the seeded K = 8
    and 64 prefix launches (finite lanes equal, scores within SCORE_RTOL),
    B7-bf16 at their cells (bounds between ranks as phase1_seeded's: packed
    words identical, remainder minima within SCORE_RTOL), B5-bf16 at (16,
    8, 2^20) K = 32 (the list contract, list_agreement, top-K identical but
    for near-ties). Returns {row: largest |score difference|}."""
    import torch

    from tpu_knn_torch.kernels import fused, seeded, topk
    from tpu_knn_torch.kernels.fused import select_cutoff

    m, k = q.shape
    errs = {}
    parts = fused.tiled_parts(m, k, n)
    ki, ks = fused.fused_candidates(q, rb, n, parts)
    pi, ps = fused.fused_candidates_plain(q, rb, n, parts)
    share, errs["B1-bf16"], scale = slot_agreement("B1-bf16 ds11", ki, ks, pi, ps,
                                                   score_rtol(k))
    ref = rb[:k, :n].T.float().contiguous()
    cutoff = select_cutoff("highest", k)
    if not torch.equal(fused._refine(q, ref, (ki, ks), n, cutoff=cutoff)[0],
                       fused._refine(q, ref, (pi, ps), n, cutoff=cutoff)[0]):
        fail("B1-bf16 ds11: refined 1-NN indices differ from the plain version's")
    log(f"  B1-bf16 ds11 P={parts}: against plain over the bf16 operand: index agreement "
        f"{share:.6f}, max |score diff| {errs['B1-bf16']:.3g} (max |score| {scale:.3g}), "
        "refined 1-NN identical")
    lo_s = torch.full((m,), -torch.inf, device=q.device)
    lo_i = torch.full((m,), -1, dtype=torch.int32, device=q.device)
    i1, s1 = topk._lex_min(ki, ks)
    ki, ks = fused.banded_candidates(q, rb, n, parts, s1, i1)
    p1_i, p1_s = topk._lex_min(*fused.banded_candidates_plain(q, rb, n, parts, lo_s, lo_i))
    pi, ps = fused.banded_candidates_plain(q, rb, n, parts, p1_s, p1_i)
    share, errs["B4-bf16"], scale = slot_agreement("B4-bf16 ds11", ki, ks, pi, ps,
                                                   score_rtol(k))
    log(f"  B4-bf16 ds11 P={parts}: pass 2 against plain over the bf16 operand: index "
        f"agreement {share:.6f}, max |score diff| {errs['B4-bf16']:.3g} (max |score| "
        f"{scale:.3g})")
    del ki, ks, pi, ps
    errs["B3-bf16"] = errs["B7-bf16"] = 0.0
    s = plain_scores(q, rb, n)
    bounds = (bound_between(s, 60, 200), bound_between(s, 5, 40))
    del s
    for kk in (8, 64):
        g = seeded.seeded_geometry(m, n, k, kk, n)
        got = fused.minima_candidates(q, rb, n, g["depth"], n_limit=g["p1_limit"], q_t=q_t)
        want = fused.minima_candidates_plain(q, rb, n, g["depth"], None, g["p1_limit"])
        fin = torch.isfinite(want)
        scale = want[fin].abs().max().item()
        err = (got - want)[fin].abs().max().item()
        if not torch.equal(fin, torch.isfinite(got)) or err > SCORE_RTOL * scale:
            fail(f"B3-bf16 ds11 K={kk}: finite lanes differ from plain, or |diff| {err} > "
                 f"{SCORE_RTOL} x {scale}")
        errs["B3-bf16"] = max(errs["B3-bf16"], err)
        for lo in (None, bounds[1]):
            banded = lo is not None
            got = seeded.extract_moments(q, rb, n, bounds[0], g["cell"], g["n_fields"], lo=lo,
                                         emit_rem=banded, q_t=q_t)
            want = seeded.extract_moments_plain(q, rb, n, bounds[0], g["cell"], g["n_fields"],
                                                lo, banded)
            for a, b in zip(got[:1 + (g["n_fields"] == 8)], want):
                if not torch.equal(a, b):
                    fail(f"B7-bf16 ds11 K={kk} banded={banded}: packed words differ from "
                         f"plain at {int((a != b).sum())} cells")
            if banded:
                fin = torch.isfinite(want[-1])
                rem = (got[-1] - want[-1])[fin].abs().max().item()
                if not torch.equal(fin, torch.isfinite(got[-1])) or \
                        rem > SCORE_RTOL * want[-1][fin].abs().max().item():
                    fail(f"B7-bf16 ds11 K={kk}: remainder minima differ from plain ({rem})")
                errs["B7-bf16"] = max(errs["B7-bf16"], rem)
        log(f"  B3-/B7-bf16 ds11 K={kk} (depth {g['depth']}, cell {g['cell']}, fields "
            f"{g['n_fields']}): B3 max |diff| to plain {err:.3g}; B7 packed words identical "
            "to plain, plain and banded")
    q8 = q[:8].contiguous()
    p5 = topk.sweep_parts(8, k, n)
    ki, ks = launched_twice("B5-bf16", topk.sweep_candidates, q8, rb, n, p5, 32)
    pi, ps = topk.sweep_candidates_plain(q8, rb, n, p5, 32)
    check_lists("B5-bf16", ki, ks, n, p5, 32)
    share, errs["B5-bf16"], swaps = list_agreement("B5-bf16", ki, ks, pi,
                                                   fused.norm_scores(q8, rb, n), score_rtol(k))
    near = same_topk("B5-bf16", topk._finalize_topk(q8, ref, ki, ks, 32, n),
                     topk._finalize_topk(q8, ref, pi, ps, 32, n))
    log(f"  B5-bf16 (16, 8, 2^20) K=32 P={p5}: against plain over the bf16 operand: slot "
        f"agreement {share:.6f} ({swaps} near-tie slots), max |score diff| "
        f"{errs['B5-bf16']:.3g}; top-K identical (near-tie ranks {near})")
    torch.cuda.synchronize(q.device)
    return errs


def b6_bf16_plain(q, rb, n, kk):
    """B6-bf16 at its main-path launch against its plain version over the
    same bf16 operand, by B6's rules: each version seeded by its own B2
    bound, the list contract, at least K real entries a row, top-K
    identical but for near-ties. Returns the largest |score difference| on
    agreeing real slots."""
    import torch

    from tpu_knn_torch.kernels import smallm, topk

    m, k = q.shape
    p2 = smallm.bf16_parts(n)
    b_k = torch.topk(smallm.smallm_candidates(q, rb, n, p2)[1], kk, dim=-1,
                     largest=False).values[:, -1].contiguous()
    b_p = torch.topk(smallm.smallm_candidates_plain(q, rb, n, p2)[1], kk, dim=-1,
                     largest=False).values[:, -1].contiguous()
    parts = topk.smallm_topk_operand_parts(rb, n, k)
    ki, ks = launched_twice("B6-bf16", topk.smallm_topk_candidates, q, rb, n, parts, kk, b_k)
    pi, ps = topk.smallm_topk_candidates_plain(q, rb, n, parts, kk, b_p)
    real = check_lists("B6-bf16", ki, ks, n, parts, kk, seed=b_k)
    least = int(real.sum(dim=1).min())
    if least < kk:
        fail(f"B6-bf16 K={kk}: a row holds {least} real entries, fewer than K")
    agree = (ki == pi) & real
    err = (ks - ps)[agree].abs().max().item() if agree.any() else 0.0
    ref = rb[:k, :n].T.float().contiguous()
    near = same_topk("B6-bf16", topk._finalize_topk(q, ref, ki, ks, kk, n),
                     topk._finalize_topk(q, ref, pi, ps, kk, n))
    log(f"  B6-bf16 (16, {m}, 2^24) K={kk} P={parts}: against plain over the bf16 operand: "
        f"{int(real.sum())} real entries (at least {least} a row); top-K identical (near-tie "
        f"ranks {near}), max |score diff| {err:.3g}")
    return err


def phase1_bf16_instances(device, gen):
    """The bf16 instances (the tiled template's BF16 policy: B1, B4, B3, B5,
    B7; and B6-bf16) bit-equal to their f32 instances over the upcast
    operand: on a grid (k = 1, 3, 16, 17, 40, 128; m past a block's rows;
    n ragged against 128 and 256; ld = n, ld % 8 != 0 and a misaligned
    base: the one-by-one staging), B6-bf16 at each load width, and at the
    main path's launches (ds11, (16, 8, 2^20) K = 32, (16, 4, 2^24) K = 16;
    the prefix and moments launches of the seeded ds11 K = 8 and 64 calls),
    where each is also held to its plain version over the same bf16
    operand (bf16_plain_ds11, b6_bf16_plain). Returns {row: the largest
    |score difference| from the plain version}."""
    import torch

    from tpu_knn_torch.kernels import fused, seeded, topk

    n_checks = 0
    for k, m, n, ld in [(1, 65, 3149, 3200), (3, 9, 1000, 1001), (16, 5, 1000, 1024),
                        (16, 40, 70_001, 70_016), (17, 33, 9077, 9077), (40, 33, 9077, 9080),
                        (128, 70, 5077, 5120), (16, 1000, 20_077, 20_224)]:
        q, rb, rf = bf16_case(gen, device, k, m, n, ld, pad=(3, 130, n - 1))
        tiled_bf16_checks(f"(k={k}, m={m}, n={n}, ld={ld})", q, rb, rf, n)
        n_checks += 1
        del q, rb, rf
    q, rb, rf = bf16_case(gen, device, 16, 40, 9000, 9216)
    tiled_bf16_checks("misaligned base (k=16, m=40, n=9000)", q, misaligned(rb, 3),
                      misaligned(rb, 3).float(), 9000, kks=(8,), b7=False)
    for k in (1, 8, 17, 32):
        for m in (1, 2, 3, 4):
            n = 20_003
            q, rb, _ = bf16_case(gen, device, k, m, n, n + 5, pad=(5,))
            for tag, r_v in (("ld % 8 != 0", rb), ("aligned", rb[:, :n + 1].contiguous()),
                             ("base + 2", misaligned(rb, 1)), ("base + 4", misaligned(rb, 2))):
                b6_bf16_checks(f"(k={k}, m={m}, {tag})", q, r_v, n, kks=(1, 8, 32))
    log(f"  bf16 instances: B1/B4/B3/B5/B7-bf16 bit-equal to the f32 instances on {n_checks} "
        "grid shapes and a misaligned base, B6-bf16 at 4 k x 4 m x 4 load widths x K 1/8/32")
    # The main path's shapes.
    k, m, n = DS11
    q, rb, rf = bf16_case(gen, device, k, m, n, n)
    tiled_bf16_checks("ds11", q, rb, rf, n, kks=(8,))
    q_t = fused.transposed_queries(q)
    for kk in (8, 64):
        g = seeded.seeded_geometry(m, n, k, kk, n)
        cs = fused.minima_candidates(q, rb, n, g["depth"], n_limit=g["p1_limit"], q_t=q_t)
        same_bits(f"B3-bf16 ds11 K={kk} launch", cs, fused.minima_candidates(
            q, rf, n, g["depth"], n_limit=g["p1_limit"], q_t=q_t))
        bound = seeded._inflate_bound(seeded._kth_smallest(cs, kk))
        same_bits(f"B7-bf16 ds11 K={kk} launch",
                  seeded.extract_moments(q, rb, n, bound, g["cell"], g["n_fields"], q_t=q_t),
                  seeded.extract_moments(q, rf, n, bound, g["cell"], g["n_fields"], q_t=q_t))
    q8 = q[:8].contiguous()
    p5 = topk.sweep_parts(8, k, n)
    same_bits("B5-bf16 (16, 8, 2^20) K=32", topk.sweep_candidates(q8, rb, n, p5, 32),
              topk.sweep_candidates(q8, rf, n, p5, 32))
    del rf
    errs = bf16_plain_ds11(q, rb, n, q_t)
    del q, rb, q_t
    torch.cuda.empty_cache()
    n24 = 1 << 24
    q4, rb, _ = bf16_case(gen, device, 16, 4, n24, n24)
    b6_bf16_checks("(16, 4, 2^24)", q4, rb, n24, kks=(16,))
    errs["B6-bf16"] = b6_bf16_plain(q4, rb, n24, 16)
    del q4, rb
    torch.cuda.empty_cache()
    log("  bf16 instances at the main path's launches (ds11 B1/B4/B3/B5/B7 and the seeded "
        "K = 8, 64 launches; B5 (16, 8, 2^20) K=32; B6 (16, 4, 2^24) K=16): bit-equal to the "
        "f32 instances, and within the f32 rows' rules of their plain versions")
    return errs


def phase1_pad(device, gen):
    """PAD_VALUE columns (1e30 in f32, bf16(1e30) = 1.0038e30), in every
    k_pad row as a mutable index's empty slots and a view's excluded
    columns hold them, through every kernel of those paths: B1 "highest"
    and the tensor-core tiers (packed3, packed2, bf16x3, bf16x4, default;
    qsplit2 over bf16), B2 / B2-bf16, B3, B4, B5, B6 and B7 and their bf16
    instances, and B4, B5, B3 and B7's tier instances at the same tiers.
    None is ever reported, no score is NaN, a PAD-only cell never
    qualifies."""
    import torch

    from tpu_knn_torch.engine.index import PAD_VALUE
    from tpu_knn_torch.kernels import fused, seeded, smallm, tiers, topk

    checked = 0
    for k, n in ((16, 70_000), (32, 20_000), (128, 20_000)):
        for bf16 in (False, True):
            m = 40
            q = uniform(gen, (m, k), device)
            r_op = case_operand(gen, device, k, n)
            pad_cols = torch.cat([torch.arange(256, device=device),
                                  torch.arange(256, n, 5, device=device)])
            r_op[:, pad_cols] = PAD_VALUE
            if bf16:
                r_op = r_op.to(torch.bfloat16)
            pads = set(pad_cols.tolist())
            tag = f"(k={k}, n={n}, {'bf16' if bf16 else 'f32'})"

            def clean(name, idx, score=None):
                nonlocal checked
                checked += 1
                if pads & set(idx.reshape(-1).tolist()):
                    fail(f"{name} {tag}: a PAD column was reported")
                if score is not None and bool(torch.isnan(score).any()):
                    fail(f"{name} {tag}: a NaN score")
                if score is not None and not bool(torch.isfinite(score[idx < n]).all()):
                    fail(f"{name} {tag}: a reported column scores non-finite")

            tier_list = (["highest", "packed"] + (["qsplit2"] if k > 32 else []) if bf16 else
                         ["highest", "packed", "bf16x4", "default"] + (["bf16x3"] if k > 32
                                                                       else []))
            for precision in tier_list:
                clean(f"tier {precision}", *tiers.tier_candidates(q, (r_op,), n, 3, precision))
            bs = torch.zeros(m, device=device)
            bi = torch.zeros(m, dtype=torch.int32, device=device)
            clean("B4", *fused.banded_candidates(q, r_op, n, 3, bs, bi))
            for depth in (1, 2):
                if bool(torch.isnan(fused.minima_candidates(q, r_op, n, depth)).any()):
                    fail(f"B3 depth {depth} {tag}: a NaN minimum")
            clean("B5", *topk.sweep_candidates(q, r_op, n, 4, 16))
            if k <= 32:
                qs = q[:4].contiguous()
                clean("B2", *smallm.smallm_candidates(qs, r_op, n, 5))
                clean("B6", *topk.smallm_topk_candidates(
                    qs, r_op, n, 4, 16, torch.full((4,), float(k), device=device)))
            a = seeded.extract_moments(q, r_op, n, torch.full((m,), 0.3 * k, device=device),
                                       64, 8)[0]
            checked += 1
            if bool((a[:, :4] != 0).any()) or not bool((a[:, 4:] != 0).any()):
                fail(f"B7 {tag}: a PAD-only cell qualified, or no live cell did")
            # The top-K kernels' tier instances: the PAD columns' |r|^2
            # overflows to +inf at every tier, so their scores are +inf.
            for precision in tier_list[1:]:
                p4, p5 = tiers.tensor_topk_parts("B4", m, n), topk.sweep_parts(m, k, n, precision)
                clean(f"B4 {precision}", *fused.banded_candidates(q, r_op, n, p4, bs, bi,
                                                                   precision=precision))
                clean(f"B5 {precision}", *topk.sweep_candidates(q, r_op, n, p5, 16,
                                                                 precision=precision))
                for depth in (1, 2):
                    if bool(torch.isnan(fused.minima_candidates(q, r_op, n, depth,
                                                                precision=precision)).any()):
                        fail(f"B3 {precision} depth {depth} {tag}: a NaN minimum")
                a = seeded.extract_moments(q, r_op, n, torch.full((m,), 0.3 * k, device=device),
                                           64, 8, precision=precision)[0]
                checked += 1
                if bool((a[:, :4] != 0).any()) or not bool((a[:, 4:] != 0).any()):
                    fail(f"B7 {precision} {tag}: a PAD-only cell qualified, or no live cell did")
            del q, r_op
    torch.cuda.synchronize(device)
    log(f"  PAD columns: {checked} launches over f32 and bf16 operands, no PAD column "
        "reported, no NaN, no PAD-only cell qualifying")


def gate_topk(name, q, pts, idx, kk):
    """0 errors rank by rank against the exact top-K scan over pts (the
    stored points in the query's space; PAD rows never win)."""
    import torch

    errors = topk_gate_errors(q, pts, idx, kk)
    torch.cuda.synchronize(q.device)
    log(f"  {name}: errors {errors}/{q.shape[0] * kk}")
    if errors:
        fail(f"{name}: {errors} errors")


def gate_radius(name, q, pts, got, radius):
    """A radius answer (idx, d2, count) against the exact scan: each row's
    count and in-radius ids equal the scan's (rows of distinct ids)."""
    import torch

    idx, _, count = got
    want_i, want_d = exact_topk_scan(q, pts, idx.shape[1])
    inside = want_d <= radius ** 2
    if not torch.equal(count.long(), inside.sum(dim=1)) or \
            not torch.equal(idx.long(), want_i.masked_fill(~inside, -1)):
        fail(f"{name}: counts {count.tolist()} against {inside.sum(dim=1).tolist()}")
    log(f"  {name}: cap {idx.shape[1]}, counts {count.tolist()}, identical to the exact scan")


def phase2_store_topk(device, gen, batch=DS11, n_big=1 << 24):
    """Top-K and radius over the quantized stores, gated against the exact
    scan over the stored points (grid space for int8), at the stores' tier
    ("packed" at k = 16): the bf16 store at (16, 1024, 2^20) (seeded K = 8
    and 64; m = 8 K = 32: B5-bf16; one passes-engine call: B4-bf16;
    "highest" 1-NN: B1-bf16) and at (16, 4,
    2^24) K = 16 (B2- and B6-bf16); the int8 store at m = 1 K = 16 over
    (16, 2^24) (the AoS engine off the grid), m = 1023 K = 8 over (16, 2^20)
    (the seeded engine over the per-call bf16 grid operand; the rows past
    the planted query 0) and a radius escalation at m = 8 over the planted
    cluster. Returns the calls, for phase 3."""
    import torch

    import tpu_knn_torch
    from tpu_knn_torch.kernels.topk import _build_topk

    k, m, n = batch
    q, r = uniform(gen, (m, k), device), uniform(gen, (n, k), device)
    ix = tpu_knn_torch.NNIndex(r, store="bf16")
    pts = ix.ref_dev.float()
    for kk in (8, 64):
        gate_topk(f"bf16 store ({k}, {m}, 2^20) query K={kk} [seeded: B3/B7-bf16]", q, pts,
                  ix.query(q, neighbors=kk)[0], kk)
    gate_topk(f"bf16 store ({k}, 8, 2^20) query K=32 [B5-bf16]", q[:8], pts,
              ix.query(q[:8], neighbors=32)[0], 32)
    passes = _build_topk(64, n, k, 8, ix.r_ops[0].shape[1], "passes", ix.precision)
    gate_topk(f"bf16 store ({k}, 64, 2^20) K=8 method='passes' [B4-bf16 at {ix.precision}]",
              q[:64], pts, passes(q[:64].contiguous(), ix.r_ops, ix.ref_dev)[0], 8)
    hi = tpu_knn_torch.NNIndex(r, store="bf16", precision="highest")
    gate_stored(f"bf16 store ({k}, {m}, 2^20) precision='highest' query [B1-bf16]", q, pts,
                hi.query(q)[0])
    del hi
    # 48 points planted near query 0, so its radius row escalates 32 -> 64.
    # They collapse onto a few grid points, more qualifiers a cell than the
    # seeded engine's moments solve: a batch holding query 0 answers through
    # its certified passes fallback; the rows past it take the fast tier
    # (and are the timed call).
    r8 = r.clone()
    r8[1000:1048] = q[0] + 0.01 * (uniform(gen, (48, k), device) - 0.5)
    ix8 = tpu_knn_torch.NNIndex(r8, store="int8")
    qg, grid = ix8._i8_q(q), ix8.ref_dev.float()
    q_rest = q[1:].contiguous()
    for lo in (0, 1):
        gate_topk(f"int8 store ({k}, {m - lo}, 2^20) query K=8 [seeded over the bf16 grid "
                  "operand]", qg[lo:], grid, ix8.query(q[lo:], neighbors=8)[0], 8)
    radius = 0.1
    got = ix8.query_radius(q[:8], radius)
    # In grid space the radius is radius / s (the index compares d2 · s² in
    # the user's units: the same set but at a boundary point's last bit).
    gate_radius("int8 store query_radius m=8 (escalating; grid space)", qg[:8], grid,
                (got[0], None, got[2]), radius * float(ix8._i8_inv_s))
    if got[0].shape[1] < 64:
        fail("int8 store query_radius: the planted cluster did not escalate the cap")
    del r8
    q4, r24 = uniform(gen, (4, k), device), uniform(gen, (n_big, k), device)
    big = tpu_knn_torch.NNIndex(r24, store="bf16")
    pts24 = big.ref_dev.float()
    gate_topk(f"bf16 store ({k}, 4, 2^24) query K=16 [B2-bf16 + B6-bf16]", q4, pts24,
              big.query(q4, neighbors=16)[0], 16)
    del pts24
    big8 = tpu_knn_torch.NNIndex(r24, store="int8")
    gate_topk(f"int8 store ({k}, 1, 2^24) query K=16 [the AoS engine off the grid]",
              big8._i8_q(q4[:1]), big8.ref_dev.float(), big8.query(q4[:1], neighbors=16)[0],
              16)
    calls = {
        "bf16 store ds11 K=8 query": lambda: ix.query(q, neighbors=8),
        "bf16 store ds11 K=64 query": lambda: ix.query(q, neighbors=64),
        "bf16 store (16, 8, 2^20) K=32 query": lambda: ix.query(q[:8], neighbors=32),
        "bf16 store (16, 4, 2^24) K=16 query": lambda: big.query(q4, neighbors=16),
        "int8 store (16, 1023, 2^20) K=8 query": lambda: ix8.query(q_rest, neighbors=8),
        "int8 store (16, 1, 2^24) K=16 query": lambda: big8.query(q4[:1], neighbors=16),
    }
    return calls, {"q": q, "r": r, "ix": ix, "q4": q4, "big": big}


def phase2_metrics(device, gen, shape=(128, 1024, 1 << 20)):
    """cosine and ip at (128, 1024, 2^20) (a tensor-core tier: bf16x3):
    1-NN and K = 10 over the stored (transformed) points with the
    transformed queries, and a cosine radius; each gated against the exact
    scan in the engines' space, the scores checked against the points'.
    Then a mutable index of each metric over the first half, the second
    half added as CUDA points: unit norms (cosine) or max-norm rows (ip),
    and 1-NN and K = 10 gated the same way."""
    import torch

    import tpu_knn_torch

    k, m, n = shape
    q, r = uniform(gen, (m, k), device) - 0.3, uniform(gen, (n, k), device) - 0.3
    # 40 points planted along query 0's direction (cosine ~0.9999), so its
    # radius row escalates.
    r[5000:5040] = q[0] + 0.02 * (uniform(gen, (40, k), device) - 0.5)
    calls = {}
    for metric in ("cosine", "ip"):
        ix = tpu_knn_torch.NNIndex(r, metric=metric)
        qt = ix._transform_q(q)
        idx, score = ix.query(q)
        gate_stored(f"metric={metric} ({k}, {m}, 2^20) query [{ix.precision}]", qt, ix.ref_dev,
                    idx)
        want = ((qt * ix.ref_dev[idx.long()]).sum(dim=1) if metric == "ip" else
                1.0 - 0.5 * ((qt - ix.ref_dev[idx.long()]) ** 2).sum(dim=1))
        if not torch.allclose(score, want, rtol=1e-4, atol=1e-4):
            fail(f"metric={metric}: scores differ from the reported points' by "
                 f"{float((score - want).abs().max())}")
        # The planted rows collapse a cell past the moments' solver: a batch
        # holding query 0 answers through the certified passes fallback, the
        # rows past it through the fast tier (the timed call).
        for lo, hi in ((1, m), (0, m)):
            ki, ks = ix.query(q[lo:hi], neighbors=10)
            gate_topk(f"metric={metric} ({k}, {hi - lo}, 2^20) query K=10", qt[lo:hi],
                      ix.ref_dev, ki, 10)
            if not bool((ks[:, 1:] <= ks[:, :-1] + 1e-5).all()):
                fail(f"metric={metric}: top-K scores are not descending")
        if metric == "cosine":
            s_min = 0.999
            got = ix.query_radius(q[:8], s_min)
            gate_radius("metric=cosine query_radius m=8 (min similarity 0.999)", qt[:8],
                        ix.ref_dev, (got[0], None, got[2]), float((2 - 2 * s_min) ** 0.5))
            if got[0].shape[1] < 64 or not bool((got[1][0, :int(got[2][0])] >= s_min).all()):
                fail("metric=cosine query_radius: no escalation, or a similarity below "
                     "the minimum")
        # A mutable index of the metric whose second half arrives as CUDA
        # points, transformed on the card by add().
        half = n // 2
        mx = tpu_knn_torch.NNIndex(r[:half], metric=metric, mutable=True)
        ids = mx.add(0.9 * r[half:])
        norm2 = (mx.ref_dev[:n] ** 2).sum(dim=1)
        target = 1.0 if metric == "cosine" else mx._ip_m2
        if mx.n_live != n or int(ids[-1]) != n - 1 or \
                float((norm2 - target).abs().max()) > 1e-4 * target:
            fail(f"mutable metric={metric}: CUDA adds not transformed (n_live {mx.n_live}, "
                 f"largest |norm^2 - {target:.4g}| {float((norm2 - target).abs().max())})")
        mqt = mx._transform_q(q)
        gate_stored(f"mutable metric={metric} ({k}, {m}, 2^20) query after CUDA adds", mqt,
                    mx.ref_dev, mx.query(q)[0])
        gate_topk(f"mutable metric={metric} ({k}, {m - 1}, 2^20) K=10 after CUDA adds", mqt[1:],
                  mx.ref_dev, mx.query(q[1:], neighbors=10)[0], 10)
        del mx, mqt, norm2
        calls[f"metric={metric} (128, 1023, 2^20) K=10 query"] = (
            lambda ix=ix: ix.query(q[1:], neighbors=10))
        calls[f"metric={metric} (128, 1024, 2^20) 1-NN query"] = (lambda ix=ix: ix.query(q))
    return calls


def phase2_mutable(device, gen, k=16, n=1 << 20, step=1 << 16):
    """A mutable f32 and a mutable bf16 index at (16, 2^20): add 2^16,
    remove 2^16, grow past capacity once, compact; after each step (and at
    build) m = 4 and 1024, 1-NN and K = 8, gated against the exact scan over
    the slot array (removed and empty slots PAD_VALUE: they never win).
    Returns both indexes' calls after compact, for phase 3."""
    import numpy as np
    import torch

    import tpu_knn_torch

    qs = uniform(gen, (1024, k), device)
    calls = {}
    for store in ("float32", "bf16"):
        ix = tpu_knn_torch.NNIndex(uniform(gen, (n, k), device), store=store, mutable=True)
        rng = np.random.default_rng(5)

        def check(what):
            pts = ix.ref_dev.float()
            for mm in (4, 1024):
                q = qs[:mm]
                idx = ix.query(q)[0]
                gate_stored(f"mutable {store} {what} m={mm} 1-NN", q, pts, idx)
                if not ix._live[idx.cpu().numpy()].all():
                    fail(f"mutable {store} {what}: a dead slot was reported")
                gate_topk(f"mutable {store} {what} m={mm} K=8", q, pts,
                          ix.query(q, neighbors=8)[0], 8)
            del pts

        check(f"build (capacity {ix.capacity})")
        ix.add(uniform(gen, (step, k), device))
        check(f"add 2^16 (n_live {ix.n_live})")
        ix.remove(rng.choice(np.nonzero(ix._live)[0], step, replace=False))
        check(f"remove 2^16 (n_live {ix.n_live})")
        cap = ix.capacity
        ix.add(uniform(gen, (cap - ix._n_slots + 1, k), device))
        if ix.capacity <= cap:
            fail(f"mutable {store}: the capacity did not grow past {cap}")
        check(f"grow ({cap} -> {ix.capacity})")
        ix.remove(rng.choice(np.nonzero(ix._live)[0], step, replace=False))
        ix.compact()
        check(f"compact (capacity {ix.capacity}, n_live {ix.n_live})")
        q4, q1024 = qs[:4], qs
        calls.update({
            f"mutable {store} m=4 1-NN query": lambda ix=ix: ix.query(q4),
            f"mutable {store} m=4 K=8 query": lambda ix=ix: ix.query(q4, neighbors=8),
            f"mutable {store} m=1024 1-NN query": lambda ix=ix: ix.query(q1024),
            f"mutable {store} m=1024 K=8 query": lambda ix=ix: ix.query(q1024, neighbors=8),
        })
    return calls


def phase2_views(device, gen, k=16, n=1 << 20):
    """filtered_view keeping half of (16, 2^20), over an f32 and a bf16
    index: 1-NN (m = 4, 1024), K = 8 (m = 1: the sweep over the masked
    operand; m = 1024) and a radius escalation at m = 8, gated against the
    exact scan over the kept points (the excluded ones PAD_VALUE: they never
    win). Returns the calls, for phase 3."""
    import numpy as np
    import torch

    import tpu_knn_torch
    from tpu_knn_torch.engine.index import PAD_VALUE

    q, r = uniform(gen, (1024, k), device), uniform(gen, (n, k), device)
    # 48 points planted near query 0, half of them excluded, so its radius
    # row escalates over the kept ones only.
    r[2000:2048] = q[0] + 0.01 * (uniform(gen, (48, k), device) - 0.5)
    keep = np.random.default_rng(3).random(n) < 0.5
    calls = {}
    for store in ("float32", "bf16"):
        view = tpu_knn_torch.NNIndex(r, store=store).filtered_view(keep)
        kept = view.ref_dev.float().clone()
        kept[~torch.as_tensor(keep, device=device)] = PAD_VALUE
        for mm in (4, 1024):
            gate_stored(f"view {store} m={mm} 1-NN", q[:mm], kept, view.query(q[:mm])[0])
        for lo, hi in ((0, 1), (1, 1024), (0, 1024)):
            gate_topk(f"view {store} m={hi - lo} K=8", q[lo:hi], kept,
                      view.query(q[lo:hi], neighbors=8)[0], 8)
        radius = 0.1
        got = view.query_radius(q[:8], radius)
        gate_radius(f"view {store} query_radius m=8", q[:8], kept, got, radius)
        if not keep[got[0][got[0] >= 0].cpu().numpy()].all():
            fail(f"view {store}: an excluded point inside the radius was reported")
        calls.update({
            f"view {store} m=4 1-NN query": lambda v=view: v.query(q[:4]),
            f"view {store} m=1023 K=8 query": lambda v=view: v.query(q[1:], neighbors=8),
        })
        del kept
    return calls


def phase3_bf16(card, gen, device, reps):
    """Times of the bf16 instances beside their f32 instances at the main
    path's shapes (B1 and B4 at ds11, B3 and B7 at the seeded ds11 K = 8
    launches, B5 at (16, 8, 2^20) K = 32, B6 at (16, 4, 2^24) K = 16): CUDA
    events around the wrapper and the kernels' own device time, the plain
    version over the bf16 operand, and each launch's bound (a bf16 operand
    moves k·n·2 bytes). Returns (times, bounds)."""
    import torch

    from tpu_knn_torch.kernels import fused, seeded, smallm, topk
    from tpu_knn_torch.utils.timing import time_ms

    k, m, n = DS11
    q, rb, rf = bf16_case(gen, device, k, m, n, n)
    parts = fused.tiled_parts(m, k, n)
    bs = torch.full((m,), 0.25 * k, device=device)
    bi = torch.full((m,), n // 2, dtype=torch.int32, device=device)
    g = seeded.seeded_geometry(m, n, k, 8, n)
    q_t = fused.transposed_queries(q)
    cs = fused.minima_candidates(q, rf, n, g["depth"], n_limit=g["p1_limit"], q_t=q_t)
    bound = seeded._inflate_bound(seeded._kth_smallest(cs, 8))
    q8 = q[:8].contiguous()
    p5 = topk.sweep_parts(8, k, n)
    launches = {
        "B1-bf16": lambda r: fused.fused_candidates(q, r, n, parts),
        "B4-bf16": lambda r: fused.banded_candidates(q, r, n, parts, bs, bi),
        "B3-bf16": lambda r: fused.minima_candidates(q, r, n, g["depth"], n_limit=g["p1_limit"],
                                                     q_t=q_t),
        "B7-bf16": lambda r: seeded.extract_moments(q, r, n, bound, g["cell"], g["n_fields"],
                                                    q_t=q_t),
        "B5-bf16": lambda r: topk.sweep_candidates(q8, r, n, p5, 32),
    }
    plains = {
        "B1-bf16": lambda: fused.fused_candidates_plain(q, rb, n, parts),
        "B4-bf16": lambda: fused.banded_candidates_plain(q, rb, n, parts, bs, bi),
        "B3-bf16": lambda: fused.minima_candidates_plain(q, rb, n, g["depth"],
                                                         n_limit=g["p1_limit"]),
        "B7-bf16": lambda: seeded.extract_moments_plain(q, rb, n, bound, g["cell"],
                                                        g["n_fields"]),
        "B5-bf16": lambda: topk.sweep_candidates_plain(q8, rb, n, p5, 32),
    }
    times, bounds = {}, {}
    width = {"B1-bf16": 128, "B4-bf16": 128, "B3-bf16": 128, "B5-bf16": 32 * 128}
    for kid, fn in launches.items():
        got = time_ms({"bf16": lambda fn=fn: fn(rb), "f32": lambda fn=fn: fn(rf),
                       "plain": plains[kid]}, reps, warmup=1)
        kname = BF16_ROWS[kid][3]
        dev = kernel_device_ms(lambda fn=fn: fn(rb), reps, card, kname)
        f32_name = {"B1-bf16": "tiled_candidates_kernel", "B4-bf16": "tiled_candidates_kernel",
                    "B3-bf16": "tiled_minima", "B7-bf16": "tiled_moments",
                    "B5-bf16": "sweep_kselect_kernel"}[kid]
        dev32 = kernel_device_ms(lambda fn=fn: fn(rf), reps, card, f32_name)
        times.update({f"{kid} kernel": got["bf16"], f"{kid} f32 instance": got["f32"],
                      f"{kid} plain": got["plain"], f"{kid} kernel device": dev,
                      f"{kid} f32 instance device": dev32})
        mm = 8 if kid == "B5-bf16" else m
        cols = g["p1_limit"] if kid == "B3-bf16" else n
        extra = 4 * m * (n // g["cell"]) if kid == "B7-bf16" else 0
        out = 8 * mm * width.get(kid, 0)
        bounds[kid] = roofline(4 * mm * k + 2 * k * cols + out + extra, 2 * mm * cols * k)
        log(f"  time {kid}: kernel {got['bf16']:.4f} ms (device {dev:.4f}), f32 instance "
            f"{got['f32']:.4f} ms (device {dev32:.4f}), plain {got['plain']:.4f} ms; bound "
            f"{bounds[kid][0]:.4f} ms ({bounds[kid][1]}) [{card}]")
    del q, rb, rf, q_t, cs
    torch.cuda.empty_cache()
    n24 = 1 << 24
    q4, rb, rf = bf16_case(gen, device, 16, 4, n24, n24)
    _, cs = smallm.smallm_candidates(q4, rb, n24, smallm.bf16_parts(n24))
    b16 = torch.topk(cs, 16, dim=-1, largest=False).values[:, -1].contiguous()
    pb, pf = topk.smallm_topk_operand_parts(rb, n24, 16), topk.smallm_topk_parts(n24, 16)
    got = time_ms({"bf16": lambda: topk.smallm_topk_candidates(q4, rb, n24, pb, 16, b16),
                   "f32": lambda: topk.smallm_topk_candidates(q4, rf, n24, pf, 16, b16),
                   "plain": lambda: topk.smallm_topk_candidates_plain(q4, rb, n24, pb, 16, b16)},
                  reps, warmup=1)
    dev = kernel_device_ms(lambda: topk.smallm_topk_candidates(q4, rb, n24, pb, 16, b16), reps,
                           card, "smallm_bf16_kselect")
    dev32 = kernel_device_ms(lambda: topk.smallm_topk_candidates(q4, rf, n24, pf, 16, b16),
                             reps, card, "smallm_kselect_kernel")
    times.update({"B6-bf16 kernel": got["bf16"], "B6-bf16 f32 instance": got["f32"],
                  "B6-bf16 plain": got["plain"], "B6-bf16 kernel device": dev,
                  "B6-bf16 f32 instance device": dev32})
    bounds["B6-bf16"] = roofline(4 * 4 * 16 + 2 * 16 * n24 + 8 * 4 * 16 * pb,
                                 3 * 4 * n24 * 16)
    log(f"  time B6-bf16 (16, 4, 2^24) K=16: kernel {got['bf16']:.4f} ms (device {dev:.4f}, "
        f"P {pb}), f32 instance B6 {got['f32']:.4f} ms (device {dev32:.4f}, P {pf}), plain "
        f"{got['plain']:.4f} ms; bound {bounds['B6-bf16'][0]:.4f} ms [{card}]")
    del q4, rb, rf
    torch.cuda.empty_cache()
    return times, bounds


def phase3_calls(card, calls, reps):
    """Device time (every kernel of the call, summed, by timing.device_ms,
    which idles the card around its profile and takes a profile that lost
    launches again; a profile that lost them three times fails the run) and
    host wall time per call of the store top-K, metric, mutable and view
    calls."""
    import torch

    from tpu_knn_torch.utils.timing import device_ms

    times = {}
    for name, fn in calls.items():
        dev = sum(device_ms({"call": fn}, "", reps).values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
        times[f"{name} device"], times[f"{name} wall"] = dev, wall
        log(f"  call {name}: device {dev:.4f} ms, wall {wall:.4f} ms per call [{card}]")
    return times


# ---- the KD-tree (v9, v10, NNIndex(strategy="kdtree")), the presplit tier
# ---- beside the stores and "auto", save -> load -------------------------

#: The reference's KD-tree row (its README.md:334-343, bench.py:786-902) and
#: v10's k <= 16 guard at its edge.
KD_ROW = (3, 1024, 1 << 16)
KD_WIDE = (16, 1024, 1 << 16)


def kd_points(seed, k, m, n, grid=False):
    """Seeded host points and queries (NumPy: the tree is built on the
    host) with exact duplicates of point 5 at n/2 and n-1, query 0 equal to
    point 5 and query 1 to point n/3; ``grid`` puts every coordinate on a
    coarse lattice, so many points lie on each split plane; grid="ties"
    draws the points from 2^k values (0 or 0.5 a coordinate), so the tree
    is deep in equal points and most of a query's visits tie."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if grid == "ties":
        r = rng.integers(0, 2, (n, k)).astype(np.float32) * 0.5
        q = rng.integers(0, 3, (m, k)).astype(np.float32) * 0.25
    elif grid:
        r = rng.integers(0, 16, (n, k)).astype(np.float32) * 0.0625
        q = rng.integers(0, 32, (m, k)).astype(np.float32) * 0.03125
    else:
        r = rng.random((n, k), np.float32)
        q = rng.random((m, k), np.float32)
    r[n // 2] = r[n - 1] = r[5]
    q[0] = r[5]
    if m > 1:
        q[1] = r[n // 3]
    return r, q


def phase1_kdtree(device, cases=((KD_ROW, False), (KD_ROW, True), ((16, 256, 1 << 12), False),
                                 ((3, 1, 1 << 16), False), ((3, 256, 1 << 12), "ties"),
                                 ((8, 256, 1 << 12), "ties"))):
    """v10's kernel against its plain version at (3, 1024, 2^16) (uniform
    and lattice points), (16, 256, 2^12), m = 1, and trees deep in equal
    points (k = 3 and 8): at every lane group (KERNEL_LANES a query;
    the wrapper's own, traversal.traverse_lanes, among them) indices
    identical and d2 bit for bit, in two launches that must be identical,
    over the node records DeviceKDTree built once, with query 2 on the
    root's split plane; 0 errors against the exact scan, and query 0 (equal
    to three points) on the lowest of them. Returns the largest |d2
    difference| (the row's max_abs_err)."""
    import numpy as np
    import torch

    from tpu_knn_torch.kdtree.build import build_kdtree
    from tpu_knn_torch.kdtree.traversal import (KERNEL_LANES, DeviceKDTree, _launch,
                                                traverse_lanes, traverse_plain)

    worst = 0.0
    for seed, ((k, m, n), grid) in enumerate(cases, start=1100):
        label = f"({k}, {m}, {n})" + ({"ties": " ties"}.get(grid, " lattice") if grid else "")
        r, q = kd_points(seed, k, m, n, grid)
        tree = build_kdtree(r)
        if m > 3:
            q[2] = q[3]
            q[2, tree.dim[1]] = tree.split_val[1]     # on the root's split plane
        dev = DeviceKDTree(tree, device)
        qt = torch.from_numpy(q).to(device)
        args = (qt, dev.ref, dev.p, dev.dim, dev.split_val)
        pi, pd, visits, _ = traverse_plain(*args, count_visits=True)
        err = 0.0
        for lanes in KERNEL_LANES:
            ki, kd = _launch(qt, dev.records, lanes)
            ki2, kd2 = _launch(qt, dev.records, lanes)
            torch.cuda.synchronize()
            if not (torch.equal(ki, ki2)
                    and torch.equal(kd.view(torch.int32), kd2.view(torch.int32))):
                fail(f"v10 {label} ({lanes} lanes a query): two launches differ")
            if not torch.equal(ki, pi):
                fail(f"v10 {label} ({lanes} lanes a query): {int((ki != pi).sum())} indices "
                     "differ from the plain version")
            if not torch.equal(kd.view(torch.int32), pd.view(torch.int32)):
                fail(f"v10 {label} ({lanes} lanes a query): d2 not bit for bit the plain "
                     "version's")
            err = max(err, float((kd - pd).abs().max()))
        ki, kd = dev.query(qt)
        worst = max(worst, err)
        lowest = int(np.flatnonzero((r == r[5]).all(axis=1)).min())
        if int(ki[0]) != lowest:
            fail(f"v10 {label}: query 0 equals points {lowest}.. but got {int(ki[0])}")
        errors = gate_errors(qt, dev.ref, ki)
        if errors:
            fail(f"v10 {label}: {errors} errors against the exact scan")
        log(f"  v10 {label}: kernel = plain (indices, d2 bits) at {KERNEL_LANES} lanes a query "
            f"(the wrapper's {traverse_lanes(k)}), max |d2 diff| {err:.3g}, {visits} visits "
            f"({visits / m:.1f} a query), 0 errors, query 0 -> {lowest}")
    return worst


def phase2_kdtree(device, gen, shapes=(("KD row (3, 1024, 2^16)", KD_ROW), ("ds10", DS10),
                                       ("(16, 1024, 2^16)", KD_WIDE))):
    """v9 and v10 through nearest_neighbors(version=) at the KD row, ds10 and
    (16, 1024, 2^16), each gated against the exact scan; then
    NNIndex(strategy="kdtree") at ds10: 1-NN at m = 4 and 1024, K = 8 and a
    radius query. Returns the data for phase 3."""
    import tpu_knn_torch

    ctx = {}
    for label, (k, m, n) in shapes:
        q, r = uniform(gen, (m, k), device), uniform(gen, (n, k), device)
        want = exact_scan(q, r)
        for v in ("v9", "v10"):
            t0 = time.perf_counter()
            idx = tpu_knn_torch.nearest_neighbors(q, r, version=v)
            wall = (time.perf_counter() - t0) * 1e3
            gate_stored(f"{label} nearest_neighbors(version={v!r}) [{wall:.1f} ms with the "
                        "host build]", q, r, idx, want)
        ctx[label] = (q, r)
    q, r = ctx["ds10"]
    ix = tpu_knn_torch.NNIndex(r, strategy="kdtree")
    if ix.device != q.device or ix._kdt2 is None:
        fail("the ds10 kdtree index is not a kdt2 index on the card's device")
    want = exact_scan(q, r)
    for mm in (4, q.shape[0]):
        idx, _ = ix.query(q[:mm])
        if idx.device != q.device:
            fail("the kdtree index answered off the index's device")
        gate_stored(f"ds10 NNIndex(strategy='kdtree').query m={mm}", q[:mm], r, idx, want[:mm])
    gate_topk("ds10 NNIndex(strategy='kdtree').query(neighbors=8)", q, r,
              ix.query(q, neighbors=8)[0], 8)
    radius = 0.01
    gate_radius("ds10 NNIndex(strategy='kdtree').query_radius m=8", q[:8], r,
                ix.query_radius(q[:8], radius), radius)
    ctx["index"] = ix
    return ctx


def phase2_presplit_stores(device, gen, shapes=(("ds11", DS11), ("(768, 1024, 2^20)", EMBED768)),
                           n_auto=1 << 24):
    """precision="bf16x3_presplit" beside store="bf16" and "int8" at ds11
    and (768, 1024, 2^20), m = 4 and 1024, and beside strategy="auto" at
    (3, 2^24) (m = 16 routed to projection, m = 64 to B12), each gated
    against the exact scan over the stored points (grid space for int8)."""
    import torch

    import tpu_knn_torch

    for label, (k, m, n) in shapes:
        q, r = uniform(gen, (m, k), device), uniform(gen, (n, k), device)
        for store in ("bf16", "int8"):
            ix = tpu_knn_torch.NNIndex(r, store=store, precision="bf16x3_presplit")
            qs, pts = stored_space(ix, q, r)
            want = gate_stored(f"{label} store={store} precision='bf16x3_presplit' m={m}",
                               qs, pts, ix.query(q)[0])
            gate_stored(f"{label} store={store} precision='bf16x3_presplit' m=4", qs[:4], pts,
                        ix.query(q[:4])[0], want[:4])
            del ix, qs, pts, want
            torch.cuda.empty_cache()
        del q, r
        torch.cuda.empty_cache()
    q, r = uniform(gen, (64, 3), device), uniform(gen, (n_auto, 3), device)
    ix = tpu_knn_torch.NNIndex(r, strategy="auto", precision="bf16x3_presplit")
    want = exact_scan(q, r)
    for mm, route in ((16, "projection"), (64, "fused")):
        gate_stored(f"(3, 2^24) auto precision='bf16x3_presplit' m={mm}", q[:mm], r,
                    ix.query(q[:mm])[0], want[:mm])
        if ix.last_strategy != route:
            fail(f"auto presplit m={mm} took {ix.last_strategy}, expected {route} "
                 f"(cert_rate {ix.cert_rate})")
    log(f"  (3, 2^24) auto presplit: cert_rate {ix.cert_rate}")
    del ix, q, r
    torch.cuda.empty_cache()


def persist_answers(ix, q):
    """What a loaded index must reproduce: 1-NN at m = 4 and len(q), top-K
    K = 8 at both where the index serves it, and auto's routes."""
    out = []
    for mm in (4, q.shape[0]):
        out.append(ix.query(q[:mm]))
        if ix.strategy == "auto":
            out.append(ix.last_strategy)
        if ix.precision != "bf16x3_presplit" and ix.strategy != "projection":
            out.append(ix.query(q[:mm], neighbors=8))
    return out


def same_answers(name, got, want):
    import torch

    for a, b in zip(got, want):
        if isinstance(a, str):
            if a != b:
                fail(f"{name}: route {a} after load, {b} before")
            continue
        for x, y in zip(a, b):
            if x.dtype != y.dtype or not torch.equal(x.contiguous().view(torch.int32),
                                                     y.contiguous().view(torch.int32)):
                fail(f"{name}: the loaded index does not answer bit for bit as the saved one")


def phase2_persist(device, gen, tmp, ds11=DS11, ds10=DS10, n_auto=1 << 24):
    """Save -> load -> query on the card: ds11 fused f32, bf16, int8,
    presplit and bf16 + presplit; auto at (3, 2^24); cosine and ip at (16,
    1024, 2^20); a mutable f32 index of 2^20 slots after removes and adds;
    the kdtree at ds10. Each loaded index answers bit for bit as the saved
    one (indices and d2, auto's routes too) at m = 4 and 1024, top-K K = 8
    where served. Logs each file's size and the save and load walls;
    returns them and the loaded ds11 f32 index for phase 3."""
    import torch

    import tpu_knn_torch

    NNIndex = tpu_knn_torch.NNIndex
    walls = {}
    k, m, n = ds11
    q, r = uniform(gen, (m, k), device), uniform(gen, (n, k), device)
    states = [(f"ds11 {label}", lambda kw=kw: NNIndex(r, **kw), q)
              for label, kw in (("f32", {}), ("bf16", {"store": "bf16"}),
                                ("int8", {"store": "int8"}),
                                ("presplit", {"precision": "bf16x3_presplit"}),
                                ("bf16 + presplit", {"store": "bf16",
                                                     "precision": "bf16x3_presplit"}))]
    q3, r3 = uniform(gen, (m, 3), device), uniform(gen, (n_auto, 3), device)
    states.append(("auto (3, 2^24)", lambda: NNIndex(r3, strategy="auto"), q3))
    for metric in ("cosine", "ip"):
        states.append((f"{metric} (16, 1024, 2^20)",
                       lambda metric=metric: NNIndex(r, metric=metric), q))

    def mutable():
        ix = NNIndex(r[: n - n // 16], mutable=True)
        ix.add(r[n - n // 16:])
        ix.remove(torch.randperm(n, generator=gen, device=device)[: n // 16].cpu().numpy())
        return ix

    states.append(("mutable f32 2^20 after removes and adds", mutable, q))
    q10, r10 = uniform(gen, (ds10[1], 3), device), uniform(gen, (ds10[2], 3), device)
    states.append(("kdtree ds10", lambda: NNIndex(r10, strategy="kdtree"), q10))
    loaded_f32 = None
    for name, build, qq in states:
        ix = build()
        want = persist_answers(ix, qq)
        path = os.path.join(tmp, "index.npz")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ix.save(path)
        t1 = time.perf_counter()
        lx = NNIndex.load(path, device=device)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        size = os.path.getsize(path)
        same_answers(name, persist_answers(lx, qq), want)
        walls[name] = {"save_ms": (t1 - t0) * 1e3, "load_ms": (t2 - t1) * 1e3, "bytes": size}
        log(f"  save -> load {name}: file {size / 2**20:.1f} MiB, save {(t1 - t0) * 1e3:.1f} ms, "
            f"load {(t2 - t1) * 1e3:.1f} ms; answers bit for bit as saved")
        if name == "ds11 f32":
            loaded_f32 = path + ".f32.npz"
            os.replace(path, loaded_f32)
        else:
            os.remove(path)
        del ix, lx, want
        torch.cuda.empty_cache()
    return {"walls": walls, "f32_file": loaded_f32, "q": q}


def phase3_kdtree(card, kd_ctx, reps):
    """v10's kernel over a built DeviceKDTree (its node records built
    once; events and device time), the records' build beside it (host wall
    of DeviceKDTree and kd_records alone by events), and its plain version
    at the KD row and ds10, with the visits the plain version counts; v9's
    native host query (its tree built once) and host build there; the
    kdtree index's 1-NN and K = 8 queries at ds10 (host wall). Returns
    (times, bounds, visits)."""
    import numpy as np
    import torch

    from tpu_knn_torch import native
    from tpu_knn_torch.kdtree.build import build_kdtree
    from tpu_knn_torch.kdtree.traversal import (DeviceKDTree, kd_records, kdtree_traverse,
                                                traverse_plain)
    from tpu_knn_torch.utils.timing import time_ms

    times, bounds, visits = {}, {}, {}
    for label in ("KD row (3, 1024, 2^16)", "ds10"):
        q, r = kd_ctx[label]
        m, k = q.shape
        n = r.shape[0]
        qh, rh = q.cpu().numpy(), r.cpu().numpy()
        t0 = time.perf_counter()
        tree = build_kdtree(rh)
        times[f"v9 build {label} host"] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev = DeviceKDTree(tree, q.device)
        torch.cuda.synchronize()
        times[f"v10 DeviceKDTree {label} host"] = (time.perf_counter() - t0) * 1e3
        args = (q, dev.ref, dev.p, dev.dim, dev.split_val)
        # Apart: the records' build reads a count back to the host, which
        # would stall the traversal's timed launches beside it.
        times.update(time_ms({f"v10 kernel {label}": lambda: dev.query(q)}, reps))
        times.update(time_ms({f"v10 records {label}": lambda: kd_records(*args[1:])}, reps))
        times.update(time_ms({f"v10 plain {label}": lambda: traverse_plain(*args)}, 3,
                             warmup=1))
        times[f"v10 kernel {label} device"] = kernel_device_ms(
            lambda: kdtree_traverse(*args, records=dev.records), reps, card,
            kernel="kdtree_traverse")
        _, _, visits[label], nodes = traverse_plain(*args, count_visits=True)
        samples = []
        for _ in range(reps):
            t0 = time.perf_counter()
            native.kdtree_query(qh, rh, tree.p, tree.dim)
            samples.append((time.perf_counter() - t0) * 1e3)
        times[f"v9 query {label} host"] = float(np.median(samples))
        # Bytes: the queries and answers, and each distinct visited node's
        # split_val, p, dim and point once (the function's, not the
        # records' padded rows); operations: 3k a visit.
        bounds[f"v10 {label}"] = roofline(4 * m * k + 8 * m + nodes * (12 + 4 * k),
                                          3 * k * visits[label])
        log(f"  v10 {label}: {visits[label]} visits ({visits[label] / m:.1f} a query) "
            f"over {nodes} distinct nodes; records {times[f'v10 records {label}']:.3f} ms "
            f"(DeviceKDTree {times[f'v10 DeviceKDTree {label} host']:.1f} ms host); "
            f"v9 host build {times[f'v9 build {label} host']:.1f} ms, "
            f"host query {times[f'v9 query {label} host']:.3f} ms [{card}]")
        del dev, args, tree
    ix = kd_ctx["index"]
    q, _ = kd_ctx["ds10"]
    for name, fn in (("kdtree index ds10 query m=1024", lambda: ix.query(q)),
                     ("kdtree index ds10 query m=4", lambda: ix.query(q[:4])),
                     ("kdtree index ds10 query(neighbors=8) m=1024",
                      lambda: ix.query(q, neighbors=8))):
        fn()
        samples = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3)
        times[f"{name} wall"] = float(np.median(samples))
    for name, ms in times.items():
        log(f"  time {name}: median {ms:.4f} ms [{card}]")
    return times, bounds, visits


def phase3_presplit(card, device, gen, persist, reps):
    """B12 over each operand source at ds11 (the f32 split, a bf16 store's
    values with lo = 0, the int8 grid's), kernel alone by events and
    device time; a loaded ds11 f32 index's first query against its steady
    state (host wall, card synchronised)."""
    import numpy as np
    import torch

    import tpu_knn_torch
    from tpu_knn_torch.kernels import tiers
    from tpu_knn_torch.kernels.tiers import presplit_ops
    from tpu_knn_torch.utils.timing import time_ms

    times = {}
    k, m, n = DS11
    q, r = uniform(gen, (m, k), device), uniform(gen, (n, k), device)
    grid = tpu_knn_torch.NNIndex(r, store="int8")
    sources = {"f32 split": presplit_ops(r, n), "bf16 store": presplit_ops(
        r.to(torch.bfloat16), n), "int8 grid": presplit_ops(grid.ref_dev, n)}
    qg = grid._i8_q(q)
    parts = tiers.tier_parts("bf16x3_presplit", m, k, n)
    fns = {f"B12 over the {src}": (lambda qq=(qg if src == "int8 grid" else q), ops=ops:
                                     tiers.presplit_candidates(qq, *ops, n, parts))
           for src, ops in sources.items()}
    times.update(time_ms(fns, reps))
    for name, fn in fns.items():
        times[f"{name} device"] = kernel_device_ms(fn, reps, card, "CandidatesEpi")
    del sources, grid, fns
    torch.cuda.empty_cache()
    # A loaded index's first query against its steady state.
    t0 = time.perf_counter()
    lx = tpu_knn_torch.NNIndex.load(persist["f32_file"], device=device)
    torch.cuda.synchronize()
    times["ds11 f32 load"] = (time.perf_counter() - t0) * 1e3
    qq = persist["q"]
    samples = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lx.query(qq)
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    times["loaded ds11 f32 first query"] = samples[0]
    times["loaded ds11 f32 steady query"] = float(np.median(samples[1:]))
    os.remove(persist["f32_file"])
    for name, ms in times.items():
        log(f"  time {name}: {ms:.4f} ms [{card}]")
    return times


# ---- the sharded tier (ROADMAP A.9): logical meshes on the card -----------

#: The logical meshes of cuda:0 the sharded phase runs ds11 over: (dcn, dp,
#: sp), dcn None for a ("dp", "sp") mesh.
SHARDED_MESHES = ((None, 1, 4), (None, 2, 2), (2, 1, 2))


def sharded_mesh(shape, devices):
    from tpu_knn_torch.distributed.sharded import default_mesh, multislice_mesh

    dcn, dp, sp = shape
    if dcn is None:
        return default_mesh(dp=dp, sp=sp, devices=devices)
    return multislice_mesh(dcn, dp=dp, sp=sp, devices=devices)


def mesh_label(mesh) -> str:
    cards = len(mesh.distinct_devices)
    return (f"({', '.join(f'{a}={v}' for a, v in mesh.shape.items())}) on "
            f"{cards} card{'s' if cards > 1 else ''}")


def same_indices(name, got, want):
    """The sharded answer's 1-NN indices identical to the unsharded one's.
    (Top-K answers go through same_topk: the unsharded engine cuts its K
    by the tier's score and the sharded merge by exact d2, so where the
    K-th and (K+1)-th points are a near-tie the two may keep either.)"""
    differ = int((got.long() != want.long()).sum().item())
    if got.shape != want.shape or differ:
        fail(f"{name}: {differ} indices differ from the unsharded answer")


def sharded_references(device, gen, ds11=DS11, n_int8=1 << 24, n_graph=1 << 17):
    """The sharded phase's data and the unsharded answers it is held to,
    made before its launch counters start: ds11 through fused_knn (1-NN)
    and topk_knn (K = 8 seeded; m = 8 K = 32 sweep), the bf16 store's
    unsharded index at ds11 (K = 8), the int8 store's at (16, 2^24)
    (m = 1, 4, 1024) and knn_graph at (16, 2^17) K = 15, each gated
    against the exact scans on the card."""
    import torch

    import tpu_knn_torch
    from tpu_knn_torch.kernels.fused import fused_knn
    from tpu_knn_torch.kernels.topk import topk_knn

    k, m, n = ds11
    ctx = {"ds11": ds11, "n int8": n_int8, "n graph": n_graph,
           "q": uniform(gen, (m, k), device), "r": uniform(gen, (n, k), device)}
    q, r = ctx["q"], ctx["r"]
    ctx["flat"] = fused_knn(q, r)[0]
    ctx["want"] = gate_stored("unsharded fused_knn ds11", q, r, ctx["flat"])
    for kk, mq in ((8, m), (32, 8)):
        got = topk_knn(q[:mq], r, kk)
        errors = topk_gate_errors(q[:mq], r, got[0], kk)
        log(f"  unsharded topk_knn ({k}, {mq}, {n}) K={kk}: errors {errors}/{mq * kk}")
        if errors:
            fail(f"unsharded topk_knn K={kk}: {errors} errors")
        ctx[f"topk {mq} {kk}"] = got
    ctx["bf16 flat"] = tpu_knn_torch.NNIndex(r, store="bf16", device=device)
    ctx["bf16 topk"] = ctx["bf16 flat"].query(q, neighbors=8)
    ctx["r24"] = uniform(gen, (n_int8, 16), device)
    ctx["int8 flat"] = tpu_knn_torch.NNIndex(ctx["r24"], store="int8", device=device)
    for mq in (1, 4, 1024):
        ctx[f"q int8 {mq}"] = uniform(gen, (mq, 16), device)
        ctx[f"int8 {mq}"] = ctx["int8 flat"].query(ctx[f"q int8 {mq}"])[0]
    ctx["points"] = uniform(gen, (n_graph, 16), device)
    before = seeded_tiers()
    ctx["graph"] = tpu_knn_torch.knn_graph(ctx["points"], 15)
    log(f"  unsharded knn_graph: seeded tiers {tier_delta(before)}")
    torch.cuda.synchronize(device)
    return ctx


def phase2_sharded(device, ctx, tmp):
    """The sharded tier on logical meshes of cuda:0 (every shard boundary,
    rebase and reduction runs on the card): sharded_knn at ds11 over
    SHARDED_MESHES with "pmin" and "ring"; sharded_topk_knn at ds11 K = 8
    (the seeded engine per shard) and at m = 8 K = 32 (the sweep); a bf16
    store's sharded index (top-K at ds11, K = 8); an int8 store's sharded
    index over (16, 2^24) at sp = 4 (a 256 MiB grid; m = 1, 4 the masked
    AoS scan, m = 1024 the per-call bf16 operand through B1's tier);
    knn_graph(mesh=(2, 2)) at (16, 2^17) K = 15; save -> load(mesh=) at
    ds11. Each answer is gated against the exact scans (0 errors) and its
    indices are identical to the unsharded answer's. On a machine with
    two or more cards, ds11 and the int8 index again over a mesh of
    distinct cards. Returns the calls phase 3 times, each beside its
    unsharded call."""
    import torch

    import tpu_knn_torch
    from tpu_knn_torch.distributed.sharded import (
        default_mesh, sharded_knn, sharded_topk_knn,
    )
    from tpu_knn_torch.kernels.fused import fused_knn
    from tpu_knn_torch.kernels.topk import topk_knn

    q, r, want, flat = ctx["q"], ctx["r"], ctx["want"], ctx["flat"]
    k, m, n = ctx["ds11"]
    n8 = f"2^{ctx['n int8'].bit_length() - 1}"
    ng = f"2^{ctx['n graph'].bit_length() - 1}"
    calls = {}

    def ds11_meshes(meshes):
        for mesh in meshes:
            for method in ("pmin", "ring"):
                name = f"sharded_knn ds11 {mesh_label(mesh)} {method}"
                idx, d2 = sharded_knn(q, r, mesh=mesh, method=method)
                if idx.device != device or not bool(torch.isfinite(d2).all()):
                    fail(f"{name}: answers on {idx.device}, finite d2 {torch.isfinite(d2).all()}")
                gate_stored(name, q, r, idx, want)
                same_indices(name, idx, flat)
                calls[name] = (lambda mesh=mesh, method=method:
                               sharded_knn(q, r, mesh=mesh, method=method),
                               lambda: fused_knn(q, r), "fused_knn ds11")

    ds11_meshes([sharded_mesh(shape, device) for shape in SHARDED_MESHES])
    mesh4 = sharded_mesh((None, 1, 4), device)
    for kk, mq in ((8, m), (32, 8)):
        name = f"sharded_topk_knn ({k}, {mq}, {n}) K={kk} {mesh_label(mesh4)}"
        before = seeded_tiers()
        got = sharded_topk_knn(q[:mq], r, kk, mesh=mesh4)
        log(f"  {name}: seeded tiers {tier_delta(before)}")
        errors = topk_gate_errors(q[:mq], r, got[0], kk)
        ties = same_topk(name, got, ctx[f"topk {mq} {kk}"])
        log(f"  {name}: errors {errors}/{mq * kk}; identical to the unsharded answer but at "
            f"{ties} near-tie ranks")
        if errors:
            fail(f"{name}: {errors} errors")
        calls[name] = (lambda mq=mq, kk=kk: sharded_topk_knn(q[:mq], r, kk, mesh=mesh4),
                       lambda mq=mq, kk=kk: topk_knn(q[:mq], r, kk),
                       f"topk_knn ({k}, {mq}, {n}) K={kk}")
    ixb = tpu_knn_torch.NNIndex(r, strategy="sharded", store="bf16", mesh=mesh4)
    name = f"sharded bf16 index ds11 K=8 {mesh_label(mesh4)}"
    got = ixb.query(q, neighbors=8)
    pts = ctx["bf16 flat"].ref_dev.float()
    errors = topk_gate_errors(q, pts, got[0], 8)
    ties = same_topk(name, got, ctx["bf16 topk"])
    log(f"  {name}: errors {errors}/{m * 8} over the stored points; identical to the "
        f"unsharded answer but at {ties} near-tie ranks")
    if errors:
        fail(f"{name}: {errors} errors")
    fxb = ctx["bf16 flat"]
    calls[name] = (lambda: ixb.query(q, neighbors=8), lambda: fxb.query(q, neighbors=8),
                   "bf16 index ds11 K=8")

    def int8_index(mesh):
        ix8 = tpu_knn_torch.NNIndex(ctx["r24"], strategy="sharded", store="int8", mesh=mesh)
        fx8 = ctx["int8 flat"]
        if not torch.equal(ix8.r_sharded.gather()[: ix8.n], fx8.ref_dev):
            fail("sharded int8 grid differs from the unsharded index's")
        for mq in (1, 4, 1024):
            qi = ctx[f"q int8 {mq}"]
            name = f"sharded int8 index (16, {mq}, {n8}) {mesh_label(mesh)}"
            got = ix8.query(qi)[0]
            gate_stored(name, fx8._i8_q(qi), fx8.ref_dev, got)
            same_indices(name, got, ctx[f"int8 {mq}"])
            calls[name] = (lambda qi=qi: ix8.query(qi), lambda qi=qi: fx8.query(qi),
                           f"int8 index (16, {mq}, {n8})")

    int8_index(mesh4)
    mesh22 = sharded_mesh((None, 2, 2), device)
    pts = ctx["points"]
    name = f"knn_graph (16, {ng}) K=15 {mesh_label(mesh22)}"
    before = seeded_tiers()
    gi, gd = tpu_knn_torch.knn_graph(pts, 15, mesh=mesh22)
    log(f"  {name}: seeded tiers {tier_delta(before)} (4 positions of 64 chunks)")
    rows = torch.arange(0, pts.shape[0], 97, device=device)
    errors = graph_gate_errors(pts, gi, rows, 15)
    ties = same_topk(name, (gi, gd), ctx["graph"])
    log(f"  {name}: errors {errors}/{rows.numel() * 15} over every 97th row; identical to "
        f"the unsharded graph but at {ties} near-tie ranks")
    if errors or not bool(torch.isfinite(gd).all()):
        fail(f"{name}: {errors} errors")
    # Events only: the graph's ~66k launches a call (four positions of 64
    # chunks) overflow the profiler's buffer, which then loses launches.
    calls[name] = (lambda: tpu_knn_torch.knn_graph(pts, 15, mesh=mesh22),
                   lambda: tpu_knn_torch.knn_graph(pts, 15), f"knn_graph (16, {ng}) K=15",
                   False)
    ix = tpu_knn_torch.NNIndex(r, strategy="sharded", mesh=mesh22)
    path = os.path.join(tmp, "sharded_ds11.npz")
    t0 = time.perf_counter()
    ix.save(path)
    t1 = time.perf_counter()
    lx = tpu_knn_torch.NNIndex.load(path, mesh=mesh4)
    torch.cuda.synchronize(device)
    t2 = time.perf_counter()
    got, saved = lx.query(q), ix.query(q)
    if not (torch.equal(got[0], saved[0]) and torch.equal(got[1], saved[1])):
        fail("sharded save -> load(mesh=): the loaded index answers otherwise")
    gate_stored(f"sharded save {mesh_label(mesh22)} -> load {mesh_label(mesh4)}", q, r,
                got[0], want)
    same_indices("sharded save -> load", got[0], flat)
    log(f"  sharded save -> load: {os.path.getsize(path) / 2**20:.1f} MiB, save "
        f"{(t1 - t0) * 1e3:.1f} ms, load {(t2 - t1) * 1e3:.1f} ms")
    os.remove(path)
    cards = torch.cuda.device_count()
    if cards >= 2:
        mesh_cards = default_mesh(dp=1, sp=cards)
        ds11_meshes([mesh_cards])
        int8_index(mesh_cards)
    else:
        log(f"  the sharded phase over distinct cards did not run: this machine has "
            f"{cards} CUDA card(s)")
    return calls


def phase3_sharded(card, calls, reps):
    """Each sharded call beside its unsharded call, in turns (CUDA events,
    medians), and, where the call's entry asks for it, the device time of
    each (every kernel of the call, summed, timing.device_ms), with the
    card's name and power limit."""
    from tpu_knn_torch.utils.timing import device_ms, time_ms

    times = {}
    for name, (sharded, flat, flat_name, *profiled) in calls.items():
        got = time_ms({"sharded": sharded, "flat": flat}, reps, warmup=1)
        times[name], times[f"{name} | unsharded"] = got["sharded"], got["flat"]
        dev = {key: "not measured" for key in ("sharded", "flat")}
        if profiled != [False]:
            dev = {key: sum(device_ms({"call": fn}, "", reps).values())
                   for key, fn in (("sharded", sharded), ("flat", flat))}
            times[f"{name} device"] = dev["sharded"]
            times[f"{name} | unsharded device"] = dev["flat"]
        log(f"  {name}: {got['sharded']:.4f} ms (device {dev['sharded']}); {flat_name} "
            f"unsharded {got['flat']:.4f} ms (device {dev['flat']}) [{card}]")
    return times


# ---- main ------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    import tpu_knn_torch
    from tpu_knn_torch.csrc import build
    from tpu_knn_torch.harness.generator import BIG_SHAPES
    from tpu_knn_torch.kernels import dma_pipeline, fused, projection, seeded, smallm, topk
    from tpu_knn_torch.kdtree import traversal
    from tpu_knn_torch.kernels.twolevel import DEFAULT_PARTITIONS

    t_start = time.perf_counter()
    from tpu_knn_torch.kernels import tiers

    # Phase 0
    log("phase 0: setup")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        fail(f"compute capability {cap}, the kernels need sm_90")
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"  torch.cuda.get_device_name(): {name}")
    log(smi)
    card = smi.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    build.load()
    log(f"  kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"({os.path.relpath(build.lib_path(), REPO)})")
    if os.path.exists(build.log_path()):
        with open(build.log_path()) as f:
            ptxas = f.read().splitlines()
        for line in ptxas:
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas: {line.strip()}")
        smem = check_no_spills(ptxas, {
            "B3": "tiled_minima_kernel", "B7": "tiled_moments_kernel",
            "tensor-core tiers and B12": "CandidatesEpi",
            "B4's tier instances": "BandedEpi", "B7's tier instances": "MomentsEpi",
            "B3's tier instances (depth 1)": r"MinimaEpiILi1ELb0E",
            "B3's tier instances (depth 1, above lo)": r"MinimaEpiILi1ELb1E",
            "B3's tier instances (depth 2)": r"MinimaEpiILi2ELb0E",
            "B5's tier instances (128-row blocks)": r"SweepEpiILi128E",
            "B5's tier instances (32-row blocks, m <= 32)": r"SweepEpiILi32E",
            "v3 (B1's tiled kernel, AoS)": r"tiled_candidates_kernelILi\d+ELb0ELb1ELb0E",
            "v6 (B1's tiled kernel, resident queries)":
                r"tiled_candidates_kernelILi\d+ELb0ELb0ELb1E",
            "B10 (B1's tiled kernel, TMA ring)": TMA_ENTRY,
            "B8/B9 compactor": "compact_cells_kernel",
            "B5 (the tiled kernel, K-list fold)": SWEEP_ENTRY,
            "B6 (K-lists over B2's scan)": SMALLM_TOPK_ENTRY,
            "B2": SMALLM_ENTRY,
            "B2-bf16 (wide loads)": SMALLM_BF16_ENTRY,
            "B11 (float4 and 4-byte rows)": WINDOW_ENTRY,
            "B1-bf16 and B4-bf16 (the tiled kernel, BF16 policy)": "tiled_bf16_candidates_kernel",
            "B3-bf16": "bf16_minima_kernel", "B7-bf16": "bf16_moments_kernel",
            "B5-bf16": SWEEP_BF16_ENTRY, "B6-bf16 (K-lists over B2-bf16's loads)":
                SMALLM_BF16_TOPK_ENTRY,
            **{f"v10 (KD-tree traversal, {g} lanes a query)":
               rf"kdtree_traverse_kernelILi\d+ELi{g}EE" for g in (1, 32)},
            **{name: pattern for name, pattern in LADDER_ENTRIES.items()}})
        check_ladder_smem(smem)
        check_kdtree_frames(ptxas)
        check_tiled_smem(smem)
        check_topk_smem(smem)
        check_scan_smem(smem)

    stamp("phase 0")
    gen = torch.Generator(device=device)
    gen.manual_seed(1000)

    # Phase 1
    log("phase 1: kernels vs plain torch versions")
    b1_cases = [(k, m, n, parts)
                for k in (3, 16) for m in (8, 1000) for n in (1000, 1 << 20)
                for parts in (1, None)]
    # The main path's own B1 launches: ds11 through v4, v7 and the prepared
    # index (default partitions), and ds9 per call through v7 (m = 1).
    k9, m9, n9 = DS9
    b1_cases += [(*DS11, None),
                 (*DS9, max(DEFAULT_PARTITIONS, fused.tiled_parts(m9, k9, n9)))]
    b2_cases = [(k, m, 1000, parts) for k in (8, 16, 32) for m in (1, 3, 4)
                for parts in (1, None)]
    b2_cases += [(16, 1, 1 << 24, None), (8, 3, 1 << 24, None), (32, 4, 1 << 24, None)]
    # B2 as pass 1 of the small-m top-K path: the prepared (16, 4, 2^24)
    # query and nearest_neighbors(neighbors=8) at (16, 3, 2^20).
    b2_cases += [(16, 4, 1 << 24, None), (16, 3, 1 << 20, None)]
    errs = phase1(device, gen, b1_cases, b2_cases)
    stamp("phase 1 B1/B2")
    # Top-K kernels: a grid with K in {1, 8, 32}, and the main path's own
    # launches (B4 at ds11 and (16, 64, 2^20); B5 at (16, 8, 2^20) K=32 and
    # (16, 32, 2^20) K=8; B6 at (16, 4, 2^24) K=16 and (16, 3, 2^20) K=8).
    b4_cases = [(k, m, n, parts) for k in (3, 16) for m in (8, 1000)
                for n in (1000, 1 << 20) for parts in (1, None)]
    b4_cases += [(*DS11, None), (16, 64, 1 << 20, None)]
    b5_cases = [(k, m, n, kk, None) for k in (3, 16) for m in (5, 40)
                for n in (1000, 1 << 20) for kk in (1, 8, 32)]
    b5_cases += [(16, 8, 1 << 20, 32, None), (16, 32, 1 << 20, 8, None),
                 (16, 13, 5000, 8, 1)]
    b6_cases = [(k, m, n, kk, None) for k in (8, 16, 32) for m in (1, 3, 4)
                for n in (1000, 1 << 20) for kk in (1, 8, 32)]
    b6_cases += [(16, 4, 1 << 24, 16, None), (16, 3, 1 << 20, 8, None),
                 (16, 2, 5000, 8, 1)]
    errs.update(phase1_topk(device, gen, b4_cases, b5_cases, b6_cases))
    # B5 at the tiled kernel's edges: m = 1, 64 and 1024 rows (TM = 1, 4,
    # 4; 65 past two blocks), k = 1, 40 and 768 (a ragged d-chunk, 48
    # chunks a tile), n ragged against 128 and 256, a partition of an odd
    # number of groups (P = 3 over 9 groups). They draw from a generator of
    # their own, so the data of the cases after them do not move.
    b5_edges = [(16, 1, 1 << 20, 4, None), (16, 64, 1 << 20, 4, None),
                (16, 65, 9000, 4, None), (16, 1024, 50_000, 4, None),
                (1, 9, 4097, 8, None), (40, 17, 3000, 16, None), (768, 10, 3000, 32, None),
                (3, 12, 1100, 5, 3)]
    gen_b5 = torch.Generator(device=device)
    gen_b5.manual_seed(1008)
    b5_edge_err = phase1_topk(device, gen_b5, [], b5_edges, [])["B5"]
    stamp("phase 1 B4/B5/B6")
    # B1 and B4 (the tiled f32 kernel) at its edges (k, m, n, P, ld): m past
    # a whole block of 8 * TM rows, n ragged against a column tile and 128,
    # k ragged against the 16-row chunk, k = 1, 768 and 7000, ld not a
    # multiple of 4 (the 4-byte copy path), with plant_lane_ties' tie inside
    # one lane within a column tile and across tiles (every B1/B4 case of
    # phase 1 has it); then B4 at each launch of phase 2's passes calls (ds11
    # K = 8, m = 64 K = 64). They draw from a generator of their own, so
    # phase 2's data do not depend on them.
    tile_edges = [(1, 65, 3149, None, 3200), (17, 9, 1000, None, 1001),
                  (40, 33, 9077, 1, None), (16, 2, 2049, None, 2051),
                  (768, 100, 5077, None, None), (768, 200, 20_077, 3, 20_077),
                  (7000, 3, 300, None, None), (16, 1000, (1 << 20) + 77, None, None)]
    # Their errors stay apart from the B1 and B4 rows (at k = 7000 |score|
    # reaches ~1e3, so its absolute differences say nothing of ds11's). B1
    # at EMBED768 (phase 2's "highest" shape there) is the "B1 k=768" row's.
    gen_edges = torch.Generator(device=device)
    gen_edges.manual_seed(1002)
    edge_errs = {"B1": phase1(device, gen_edges, tile_edges, [])["B1"],
                 "B4": phase1_topk(device, gen_edges, tile_edges, [], [])["B4"]}
    edge_errs["B5"] = b5_edge_err
    log(f"  tile edges: max |score diff| B1 {edge_errs['B1']:.3g}, B4 {edge_errs['B4']:.3g}, "
        f"B5 {edge_errs['B5']:.3g}")
    passes_errs = phase1_passes_launches(device, gen_edges, [(*DS11, 8), (16, 64, 1 << 20, 64)])
    errs["B1 k=768"] = phase1(device, gen_edges, [(*EMBED768, None)], [])["B1"]
    torch.cuda.empty_cache()
    stamp("phase 1 tiled f32 kernel edges, passes launches and k = 768")
    # The seeded engine's kernels: B3 at depth 1 and 2, banded, with a
    # prefix and at ragged n, and at the ds11 launches (K=8: half prefix;
    # K=16: 3/4 prefix; K=64: full; K=128: depth 2); B7 in the quadratic and
    # cubic modes at cells of 64/128/256, banded with the remainder minima,
    # over an operand wider than n, and at the ds11 K=8 and K=64 launches;
    # the compactor with 1 and 2 fields, 1/4/8 parts, caps 12/48/80/192, at
    # part widths <= 8192 (B9's regime) and > 8192 (B8's), and at the
    # main path's launches.
    n20 = 1 << 20
    b3_cases = [(16, 1024, n20, n20, 1, False, n20 // 2),
                (16, 1024, n20, n20, 1, False, 3 * n20 // 4),
                (16, 1024, n20, n20, 1, False, None), (16, 1024, n20, n20, 2, False, None),
                (16, 300, 70_001, 70_144, 2, True, None), (5, 40, 3001, 3072, 1, True, None),
                (7, 33, 20_000, 20_096, 2, False, 10_112)]
    b7_cases = [(16, 1024, n20, n20, 256, 4, False), (16, 1024, n20, n20, 128, 8, False),
                (16, 300, 70_001, 70_144, 256, 8, True), (7, 40, 20_000, 32_768, 64, 8, True),
                (16, 100, 50_000, 50_048, 64, 4, False), (9, 64, 9_000, 9_216, 128, 4, True)]
    compact_cases = [(m, nc, parts, cap, nf, 0.01)
                     for m, nc in ((1024, 4096), (256, 16_384 * 4))
                     for parts, cap in ((1, 12), (4, 48), (8, 80), (1, 192))
                     for nf in (1, 2)]
    compact_cases += [(1024, 4096, 1, 48, 1, 0.006), (1024, 8192, 4, 48, 2, 0.01),
                      (1024, 16_384, 1, 48, 1, 0.003), (1024, 8192, 1, 144, 2, 0.015),
                      (33, 40_000, 2, 80, 1, 0.003)]
    errs.update(phase1_seeded(device, gen, b3_cases, b7_cases, compact_cases))
    # The compactor's block-wide scan at its edges, from a generator of its
    # own: dense rows (the walk stops after its first round), cap == part
    # width, nc % 4 != 0 and a base that is not 16-byte aligned (the
    # cell-by-cell loads), parts narrower than one 256-thread round (2, 4
    # or 8 tasks a block).
    gen_compact = torch.Generator(device=device)
    gen_compact.manual_seed(1007)
    compact_edges = [(256, 16_384, 1, 48, 2, 1.0), (16, 40_000, 2, 20_000, 2, 1.0),
                     (64, 2048, 2, 1024, 2, 0.5), (100, 4098, 2, 80, 2, 0.01),
                     (50, 4098, 2, 2049, 1, 1.0), (300, 800, 8, 12, 1, 0.05),
                     (200, 4096, 8, 16, 2, 0.02), (90, 3000, 3, 40, 2, 0.03),
                     (60, 6000, 3, 2000, 2, 0.3), (129, 8192, 4, 48, 2, 0.01, 1)]
    phase1_seeded(device, gen_compact, [], [], compact_edges)
    stamp("phase 1 B3/B7/compactor grid")
    # B3 and B7 (the tiled template with their own epilogues) at its edges,
    # each launch also made with the transposed queries passed in: m past a
    # block's 8 * TM rows, n ragged against 256 and 128, an operand wider
    # than n, k ragged against the d-chunk, k = 1 and 768, ld not a multiple
    # of 4 (B3) or a base not 16-byte aligned (B7: its ld is a multiple of
    # the cell), cells of 64, 128 and 256 in both modes; then the own-minima
    # check at ds11 K = 8 and 64. A generator of their own keeps phase 2's
    # data as they were.
    gen_seeded = torch.Generator(device=device)
    gen_seeded.manual_seed(1004)
    b3_edges = [(1, 65, 3149, 3200, 1, False, None), (17, 9, 1000, 1001, 2, True, None),
                (40, 33, 9077, 9077, 1, False, 5000), (16, 70, 2049, 2051, 2, False, None),
                (768, 70, 5077, 5077, 1, True, None),
                (16, 1000, n20 + 77, n20 + 77, 2, False, None)]
    b7_edges = [(1, 65, 3149, 3200, 64, 4, False), (17, 9, 1000, 1280, 128, 8, True, 1),
                (40, 33, 9077, 9216, 256, 4, False), (16, 70, 2049, 2304, 256, 8, True),
                (768, 70, 5077, 5120, 64, 8, False), (16, 3, 20_000, 32_768, 128, 4, False, 3),
                (16, 1000, n20 + 77, n20 + 256, 128, 8, True)]
    edge_errs.update({kid: err for kid, err in phase1_seeded(
        device, gen_seeded, b3_edges, b7_edges, [], with_q_t=True).items() if kid != "B8/B9"})
    log(f"  tile edges: max |diff| B3 {edge_errs['B3']:.3g}, B7 remainder {edge_errs['B7']:.3g}")
    phase1_own_minima(device, gen_seeded)
    torch.cuda.empty_cache()
    stamp("phase 1 B3/B7 tile edges and own-minima check")
    # And at every launch of the seeded main path: phase 2's seeded calls
    # at their own shapes, on data of their own.
    own = seeded_cases(device, gen, uniform(gen, (DS11[1], 16), device),
                       uniform(gen, (1 << 20, 16), device), uniform(gen, (64, 16), device),
                       uniform(gen, (8, 16), device))
    for kid, err in phase1_seeded_main(own).items():
        errs[kid] = max(errs[kid], err)
    del own
    torch.cuda.empty_cache()
    stamp("phase 1 seeded main-path launches")
    # The 1-NN ladder's kernels: B10 on a grid and at v5's launches of
    # phase 2 (the BIG shapes), index-equal to B1 at the same P; B11 at
    # windows of 1 + 1 and 64 + 1 tiles over n ragged against 4096, query 0
    # at the last start tile with planted duplicates, and at the auto
    # path's (3, 16, 2^24) launch; B1's AoS (v3) and resident-query (v6)
    # variants bit-equal to B1 on a grid and at ds10/ds11, then (from a
    # generator of their own, so phase 2's data do not move) at phase 2's
    # other ladder launches (ds8, ds9) and the card tests' shapes: k not a
    # multiple of 4, m = 1, n ragged, v6 at its guard's extremes ((m, k) =
    # (2, 7000), (64, 256), (1, 16384)), v3 at k = 768 and 2048.
    n_rag = (1 << 20) + 77
    b10_cases = [(k, m, n, parts) for k in (3, 16) for m in (1, 8, 1000)
                 for n in (1000, n_rag) for parts in (1, None)]
    b10_cases += [(*shape, None) for shape in BIG_SHAPES]
    errs["B10"] = phase1_b10(device, gen, b10_cases)
    # B10's TMA ring at its edges (k, m, n, P), from a generator of its own:
    # k = 1, k ragged against the 16-row chunk, wide k (768 and 7000, past
    # the lane-per-thread B10's old guard of k <= 199 at m = 1), m past a
    # block's 8 * TM rows at each TM, n ragged against 128 and 256.
    gen_b10 = torch.Generator(device=device)
    gen_b10.manual_seed(1006)
    b10_edges = [(1, 65, 3149, None), (17, 9, 1000, None), (768, 100, 5077, None),
                 (7000, 3, 300, 2), (16, 1000, (1 << 16) + 77, None), (5, 33, 4099, 3),
                 (40, 70, 20_077, None), (16, 129, (1 << 16) + 128, None),
                 (250, 1, 70_001, None), (2048, 8, 4096, None)]
    edge_errs["B10"] = phase1_b10(device, gen_b10, b10_edges)
    stamp("phase 1 B10")
    b11_cases = [(k, m, n_rag, window) for k in (3, 8) for m in (1, 16, 64)
                 for window in (4096, 1 << 18)]
    b11_cases += [(3, 16, 1 << 24, projection.auto_window(3, 1 << 24))]
    errs["B11"] = phase1_b11(device, gen, b11_cases)
    # B11 at m = 1, 7, 16, 64 and k = 3, 8, 16, 40 (several row chunks a
    # column), windows of 2 + 1 and 5 + 1 tiles whose query 0 starts at the
    # last tile, n ragged against 4096; and at v11's ds8 and ds10 launches
    # (m = 1; m = 1024 at one split). A generator of their own keeps the
    # data of the cases after them as they were.
    gen_b11 = torch.Generator(device=device)
    gen_b11.manual_seed(1009)
    b11_edges = [(k, m, 70_001 + 77 * k, 8192 if m < 64 else 20_480)
                 for k in (3, 8, 16, 40) for m in (1, 7, 16, 64)]
    b11_edges += [(3, 1, 1 << 24, projection.auto_window(3, 1 << 24)),
                  (3, 1024, 1 << 20, projection.auto_window(3, 1 << 20))]
    edge_errs["B11"] = phase1_b11(device, gen_b11, b11_edges)
    stamp("phase 1 B11")
    variant_cases = [(k, m, n, parts) for k in (3, 16) for m in (8, 1000)
                     for n in (1000, 1 << 20) for parts in (1, None)]
    variant_cases += [(*DS10, None), (*DS11, None)]
    errs["B1 variants"] = phase1_b1_variants(device, gen, variant_cases)
    gen_variants = torch.Generator(device=device)
    gen_variants.manual_seed(1005)
    variant_edges = [(*DS8, None), (*DS9, None), (5, 1, 3000, 3), (7, 33, 9077, None),
                     (17, 1, 70_001, None), (5, 65, 20_077, 3), (500, 2, 3001, 2),
                     (7000, 2, 300, 2), (256, 64, 20_077, None), (16384, 1, 2000, 1),
                     (2048, 8, 4096, None), (768, 100, 5077, None)]
    edge_errs["B1 variants"] = phase1_b1_variants(device, gen_variants, variant_edges)
    log(f"  B1 variants' edges: max |score diff| {edge_errs['B1 variants']:.3g}")
    torch.cuda.empty_cache()
    stamp("phase 1 B1 variants")
    # The tensor-core tiers and B12 on a grid with ragged n: every k of
    # the slice, each tier that auto_precision or a store selects there
    # (packed at k <= 32 over f32 and bf16 operands; bf16x3 over f32 and
    # qsplit2 over bf16 and int8-grid operands above), B12, the tiers that
    # only an explicit precision= reaches (bf16x4, default), ds11 (packed3,
    # B12) and the embed shapes at m = 256.
    n_t = 20_000 + 77
    tier_cases = []
    for k in (1, 3, 16, 24, 32, 40, 128, 768):
        n_k = n_t if k < 768 else 5000 + 77
        if k <= 32:
            label = "B1 packed3" if -(-k // 8) * 8 <= 16 else "B1 packed2"
            tier_cases += [(label, "packed", "f32", k, 100, n_k),
                           (label, "packed", "bf16", k, 33, n_k)]
        else:
            tier_cases += [("B1 bf16x3", "bf16x3", "f32", k, 100, n_k),
                           ("B1 qsplit2", "qsplit2", "bf16", k, 33, n_k),
                           ("B1 qsplit2", "qsplit2", "int8", k, 70, n_k)]
        tier_cases += [("B12", "bf16x3_presplit", "presplit", k, 64, n_k)]
    tier_cases += [("B1 bf16x4", "bf16x4", "f32", k, 50, n_t) for k in (16, 40)]
    tier_cases += [("B1 default", "default", "f32", k, 50, n_t) for k in (16, 40)]
    tier_cases += [("B1 packed3", "packed", "f32", *DS11),
                   ("B12", "bf16x3_presplit", "presplit", *DS11)]
    tier_cases += [("B1 bf16x3", "bf16x3", "f32", k, 256, 1 << 20) for k in (128, 768)]
    tier_cases += [("B1 qsplit2", "qsplit2", kind, k, 256, 1 << 20)
                   for k in (128, 768) for kind in ("bf16", "int8")]
    # Then every other shape the main path gives the tiers in phase 2:
    # ds11 prepared over a bf16 store's operand and the int8 grid's per-call
    # one (packed3), bf16x4 and default per call, v7 at (32, 1024, 2^20)
    # (packed2), and the embed shapes at m = 1024 (bf16x3 over f32, qsplit2
    # over the bf16 and int8 stores' operands). They draw from a generator
    # of their own, so phase 2's data do not depend on them.
    k11, m11, n11 = DS11
    main_cases = [("B1 packed3", "packed", kind, *DS11) for kind in ("bf16", "int8")]
    main_cases += [("B1 bf16x4", "bf16x4", "f32", *DS11), ("B1 default", "default", "f32", *DS11),
                   ("B1 packed2", "packed", "f32", 32, m11, n11)]
    main_cases += [("B1 bf16x3", "bf16x3", "f32", k, m11, n11) for k in (128, 768)]
    main_cases += [("B1 qsplit2", "qsplit2", kind, k, m11, n11)
                   for k in (128, 768) for kind in ("bf16", "int8")]
    gen_main = torch.Generator(device=device)
    gen_main.manual_seed(1001)
    tier_diffs, tier_rel, tier_gate_share = phase1_tiers(device, gen, tier_cases)
    for got, mine in zip(phase1_tiers(device, gen_main, main_cases),
                         (tier_diffs, tier_rel, tier_gate_share)):
        for label, value in got.items():
            mine[label] = max(mine.get(label, 0.0), value)
    errs.update(tier_diffs)
    # The top-K kernels' tier instances (B4, B5, B3, B7), from a generator
    # of their own, so that the data of the cases after them do not move.
    gen_topk_tiers = torch.Generator(device=device)
    gen_topk_tiers.manual_seed(1013)
    topk_tier_errs, topk_tier_plain = phase1_topk_tiers(device, gen_topk_tiers, TOPK_TIER_CASES)
    errs.update(topk_tier_errs)
    # B3's and B5's instances bit for bit their plain versions over exact
    # inputs, and B5 at the serving shapes, from a generator of their own.
    gen_b3_b5 = torch.Generator(device=device)
    gen_b3_b5.manual_seed(1015)
    b3_b5_errs, b3_b5_plain = phase1_b3_b5_exact(device, gen_b3_b5)
    errs.update(b3_b5_errs)
    topk_tier_plain.update(b3_b5_plain)
    # The ladder's tier instances (v3, B10, v6) against B1's tier and their
    # plain versions, from a generator of their own.
    gen_ladder_tiers = torch.Generator(device=device)
    gen_ladder_tiers.manual_seed(1014)
    ladder_tier_errs, ladder_tier_plain = phase1_ladder_tiers(device, gen_ladder_tiers,
                                                              LADDER_TIER_CASES)
    errs.update(ladder_tier_errs)
    stamp("phase 1 ladder tier instances")
    for row, err in passes_errs.items():
        errs[row] = max(errs.get(row, 0.0), err)
    torch.cuda.empty_cache()
    stamp("phase 1 top-K tier instances")
    errs["B2-bf16"] = phase1_b2_bf16(device, gen, [(k, m, n) for k in (8, 16, 32)
                                                  for m in (1, 4) for n in (1000, n_t)]
                                     + [(16, 1, 1 << 20), (16, 4, 1 << 20)])
    # B2-bf16 at each load width (the operand's narrower-load copies), m =
    # 1..4, k = 1, 8, 9, 16, 17, 32, n ragged against 8 and 128, from a
    # generator of its own.
    gen_bf16 = torch.Generator(device=device)
    gen_bf16.manual_seed(1010)
    edge_errs["B2-bf16"] = phase1_b2_bf16(
        device, gen_bf16, [(k, m, 20_003) for m in (1, 2, 3, 4) for k in (1, 8, 9, 16, 17, 32)],
        edges=True)
    torch.cuda.empty_cache()
    stamp("phase 1 tiers, B12 and B2-bf16")
    # The bf16 instances (B1/B4/B3/B5/B7 under the tiled template's BF16
    # policy, B6-bf16) bit-equal to their f32 instances, and PAD columns
    # through every kernel of the mutable and view paths, from generators
    # of their own.
    gen_bf16i = torch.Generator(device=device)
    gen_bf16i.manual_seed(1011)
    errs.update(phase1_bf16_instances(device, gen_bf16i))
    stamp("phase 1 bf16 instances")
    gen_pad = torch.Generator(device=device)
    gen_pad.manual_seed(1012)
    phase1_pad(device, gen_pad)
    torch.cuda.empty_cache()
    stamp("phase 1 PAD columns")
    errs["v10"] = phase1_kdtree(device)
    stamp("phase 1 v10")

    # Phase 2: each path runs with every launch counter set to 0 just
    # before it and read just after.
    wrappers = {"B1": fused.fused_candidates, "B2": smallm.smallm_candidates,
                "B3": fused.minima_candidates, "B4": fused.banded_candidates,
                "B5": topk.sweep_candidates, "B6": topk.smallm_topk_candidates,
                "B7": seeded.extract_moments, "B8/B9": seeded.compact_cells,
                "B10": dma_pipeline.dma_candidates, "B11": projection.window_candidates,
                "B1 AoS (v3)": fused.aos_candidates,
                "B1 constant-query (v6)": fused.const_query_candidates,
                "v10": traversal.kdtree_traverse}
    # B1's tiers, B12 and B2-bf16 count in tiers.TIER_LAUNCHES, one key a
    # row.
    tier_rows = {f"B1 {t}": t for t in ("packed3", "packed2", "bf16x3", "bf16x4", "qsplit2",
                                        "default")}
    tier_rows.update({"B12": "bf16x3_presplit", "B2-bf16": "B2-bf16"})
    # The top-K kernels' tier instances count in tiers.TIER_LAUNCHES by
    # their row ("B4 packed3", "B4-bf16 qsplit2", ...).
    tier_rows.update({f"{kid}{bf} {t}": f"{kid}{bf} {t}" for kid in TOPK_TIER_KERNELS
                      for bf in ("", "-bf16")
                      for t in ("packed3", "packed2", "bf16x3", "bf16x4", "qsplit2", "default")})
    # The ladder's tier instances count by their row ("B1 v3 packed3", "B10
    # bf16x3", "B1 v6 packed3", ...).
    tier_rows.update({f"{row} {t}": f"{row} {t}" for row in ("B1 v3", "B10", "B1 v6")
                      for t in ("packed3", "packed2", "bf16x3", "bf16x4", "default")})
    # The bf16 instances count in their wrapper's .bf16_launches.
    counters = [*wrappers, *tier_rows, *BF16_ROWS]

    def count(kname):
        if kname in wrappers:
            return wrappers[kname].launches
        if kname in BF16_ROWS:
            return bf16_wrapper(kname).bf16_launches
        return tiers.TIER_LAUNCHES[tier_rows[kname]]

    def drive(path, needs, run):
        for fn in wrappers.values():
            fn.launches = 0
            if hasattr(fn, "bf16_launches"):
                fn.bf16_launches = 0
        tiers.TIER_LAUNCHES.clear()
        out = run()
        counts = {kname: count(kname) for kname in counters}
        log(f"  kernel launches on the {path} path: {counts}")
        for kname in needs:
            if counts[kname] < 1:
                fail(f"{kname} was not launched on the {path} path")
        stamp(f"phase 2 {path} path")
        return out, counts

    log("phase 2: main path")
    (big11, big9), counts_1nn = drive(
        "1-NN", ("B1", "B2", "B1 packed3"),
        lambda: (phase2_ta(device), phase2_big(device, gen, DS11, DS9))[1])
    log("phase 2: top-K path")
    (calls, ctx), counts_topk = drive("top-K", ("B2", "B4 packed3", "B5 packed3", "B6"),
                                      lambda: phase2_topk(device, gen))
    log("phase 2: seeded top-K path")
    cases = seeded_cases(device, gen, ctx["q1024"], ctx["r20"], ctx["q64"], ctx["q8"])
    ctx["r22"] = cases["r22"]
    seeded_calls, counts_seeded = drive("seeded top-K", ("B3 packed3", "B4 packed3", "B7 packed3",
                                                         "B8/B9"),
                                        lambda: phase2_seeded(device, cases))
    log("phase 2: the 1-NN ladder (the runner; v1, v2, v3, v5, v6, v11 at ds8..ds11)")
    big, counts_ladder = drive("ladder", ("B10", "B11", "B1 AoS (v3)",
                                          "B1 constant-query (v6)", "B1 packed3",
                                          "B1 v3 packed3", "B10 packed3", "B1 v6 packed3"),
                               lambda: ladder_launches_by_shape(
                                   lambda: phase2_ladder(device, gen)))
    log("phase 2: the ladder at embedding width (v3, v5, v6 at bf16x3) and smallm_knn(tile_n=)")
    gen_lt = torch.Generator(device=device)
    gen_lt.manual_seed(1015)
    _, counts_ladder_tiers = drive("ladder tiers", ("B1 v3 bf16x3", "B10 bf16x3", "B1 v6 bf16x3",
                                                    "B2"),
                                   lambda: phase2_ladder_tiers(device, gen_lt))
    log("phase 2: auto and projection serving")
    auto_ctx, counts_auto = drive("auto/projection", ("B1", "B11", "B1 packed3"),
                                  lambda: phase2_auto(device, gen))
    log("phase 2: the score tiers per call and prepared (ds11, v7 at k = 32)")
    _, counts_tiers = drive("tier", ("B1", "B1 packed3", "B1 packed2", "B1 bf16x3",
                                     "B1 bf16x4", "B1 default", "B12"),
                            lambda: phase2_tiers(device, gen, DS11))
    log("phase 2: the stores (batch-store and embed shapes)")
    _, counts_stores = drive("store", ("B1 packed3", "B1 bf16x3", "B1 qsplit2", "B2",
                                       "B2-bf16"),
                             lambda: phase2_stores(device, gen, DS11, (128, 768)))
    torch.cuda.empty_cache()
    log("phase 2: \"highest\" 1-NN at embedding width (768, 1024, 2^20)")
    gen_768 = torch.Generator(device=device)
    gen_768.manual_seed(1003)
    embed768, counts_768 = drive("highest k=768", ("B1",),
                                 lambda: phase2_highest(device, gen_768))
    torch.cuda.empty_cache()
    # The serving surface's paths (ROADMAP A.6.1-A.6.4), each from a generator of its
    # own: top-K and radius over the quantized stores, the metrics, mutable
    # indexes, filtered views.
    gens = {}
    for i, path in enumerate(("stores", "metrics", "mutable", "views", "kdtree", "presplit",
                              "persist")):
        gens[path] = torch.Generator(device=device)
        gens[path].manual_seed(1020 + i)
    log("phase 2: top-K and radius over the bf16 and int8 stores")
    (store_calls, _), counts_store_topk = drive(
        "store top-K", ("B1-bf16", "B2-bf16", "B3-bf16 packed3", "B4-bf16 packed3",
                        "B5-bf16 packed3", "B6-bf16", "B7-bf16 packed3", "B8/B9"),
        lambda: phase2_store_topk(device, gens["stores"]))
    log("phase 2: the top-K engines at \"highest\" and at embedding width (bf16x3, qsplit2)")
    gen_tt = torch.Generator(device=device)
    gen_tt.manual_seed(1027)
    tier_topk_calls, counts_tier_topk = drive(
        "top-K tiers", ("B3", "B4", "B5", "B7", "B3-bf16", "B4-bf16", "B5-bf16", "B7-bf16",
                        "B8/B9", "B4 bf16x3", "B5 bf16x3", "B3 bf16x3", "B7 bf16x3",
                        "B4-bf16 qsplit2", "B5-bf16 qsplit2", "B3-bf16 qsplit2",
                        "B7-bf16 qsplit2"),
        lambda: phase2_topk_tiers(device, gen_tt))
    torch.cuda.empty_cache()
    log("phase 2: metric='cosine' and 'ip' at (128, 1024, 2^20)")
    metric_calls, counts_metrics = drive("metric", ("B1 bf16x3", "B3 bf16x3", "B5 bf16x3",
                                                    "B7 bf16x3", "B8/B9"),
                                         lambda: phase2_metrics(device, gens["metrics"]))
    log("phase 2: mutable f32 and bf16 indexes at (16, 2^20)")
    mutable_calls, counts_mutable = drive(
        "mutable", ("B1 packed3", "B2", "B2-bf16", "B3 packed3", "B3-bf16 packed3", "B6",
                    "B6-bf16", "B7 packed3", "B7-bf16 packed3", "B8/B9"),
        lambda: phase2_mutable(device, gens["mutable"]))
    log("phase 2: filtered views of (16, 2^20), f32 and bf16")
    view_calls, counts_views = drive(
        "view", ("B1 packed3", "B2", "B2-bf16", "B3 packed3", "B3-bf16 packed3", "B6",
                 "B6-bf16"),
        lambda: phase2_views(device, gens["views"]))
    # The KD-tree, the presplit tier beside the stores, save -> load (ROADMAP
    # A.6.5, A.6.6, A.8).
    log("phase 2: the KD-tree: v9, v10 and NNIndex(strategy='kdtree')")
    kd_ctx, counts_kdtree = drive("kdtree", ("v10",),
                                  lambda: phase2_kdtree(device, gens["kdtree"]))
    log("phase 2: precision='bf16x3_presplit' beside the bf16 and int8 stores and 'auto'")
    _, counts_presplit = drive("presplit beside the stores", ("B12", "B11"),
                               lambda: phase2_presplit_stores(device, gens["presplit"]))
    log("phase 2: save -> load -> query")
    persist_dir = tempfile.mkdtemp(dir=build.BUILD_DIR)
    persist, counts_persist = drive(
        "save/load", ("B2", "B2-bf16", "B12", "B1 packed3", "B3 packed3", "B7 packed3", "B11"),
        lambda: phase2_persist(device, gens["persist"], persist_dir))
    # The sharded tier (ROADMAP A.9), from a generator of its own: its
    # unsharded references first, then its own calls with the counters
    # reset.
    log("phase 2: the sharded tier over logical meshes of the card")
    gen_sh = torch.Generator(device=device)
    gen_sh.manual_seed(1040)
    sharded_ctx = sharded_references(device, gen_sh)
    stamp("phase 2 the sharded tier's unsharded references")
    sharded_calls, counts_sharded = drive(
        "sharded", ("B1 packed3", "B3 packed3", "B5 packed3", "B7 packed3", "B8/B9",
                    "B3-bf16 packed3", "B7-bf16 packed3"),
        lambda: phase2_sharded(device, sharded_ctx, persist_dir))
    # The "B1 k=768" row counts that path's launches, the B1 row the others'.
    launches = {kname: sum(c[kname] for c in (counts_1nn, counts_topk, counts_seeded,
                                             counts_ladder, counts_ladder_tiers, counts_auto,
                                             counts_tiers,
                                             counts_stores, counts_store_topk,
                                             counts_tier_topk, counts_metrics,
                                             counts_mutable, counts_views, counts_kdtree,
                                             counts_presplit, counts_persist, counts_sharded))
                for kname in counters}
    launches["B1 k=768"] = counts_768["B1"]

    # Phase 3
    log("phase 3: times")
    times = phase3(card, big11, big9, reps=10)
    times.update(phase3_highest(card, *embed768, reps=3))
    del embed768
    stamp("phase 3 1-NN")
    topk_times, topk_shapes = phase3_topk(card, ctx, calls, reps=10)
    times.update(topk_times)
    stamp("phase 3 top-K")
    seeded_times, seeded_bounds = phase3_seeded(card, ctx, seeded_calls, reps=5)
    times.update(seeded_times)
    stamp("phase 3 seeded")
    ladder_times, ladder_bounds = phase3_ladder(card, big, auto_ctx, reps=10)
    times.update(ladder_times)
    stamp("phase 3 ladder")
    gen_lt3 = torch.Generator(device=device)
    gen_lt3.manual_seed(1033)
    ladder_tier_times, ladder_tier_bounds = phase3_ladder_tiers(card, device, gen_lt3, reps=10)
    times.update(ladder_tier_times)
    torch.cuda.empty_cache()
    stamp("phase 3 ladder tier instances")
    del big, auto_ctx
    torch.cuda.empty_cache()
    tier_times, tier_bounds = phase3_tiers(card, device, gen, reps=10)
    times.update(tier_times)
    stamp("phase 3 tiers and stores")
    gen_t = torch.Generator(device=device)
    gen_t.manual_seed(1030)
    bf16_times, bf16_bounds = phase3_bf16(card, gen_t, device, reps=10)
    times.update(bf16_times)
    stamp("phase 3 bf16 instances")
    gen_tt3 = torch.Generator(device=device)
    gen_tt3.manual_seed(1032)
    topk_tier_times, topk_tier_bounds = phase3_topk_tiers(card, device, gen_tt3, reps=10)
    b3_b5_times, b3_b5_bounds = phase3_b3_b5_rows(card, device, gen_tt3, reps=10)
    topk_tier_times.update(b3_b5_times)
    topk_tier_bounds.update(b3_b5_bounds)
    times.update(topk_tier_times)
    log_ranked_tier_rows(card, topk_tier_times, topk_tier_bounds)
    torch.cuda.empty_cache()
    stamp("phase 3 top-K tier instances")
    times.update(phase3_calls(card, {**store_calls, **metric_calls, **mutable_calls,
                                     **view_calls, **tier_topk_calls}, reps=5))
    del store_calls, metric_calls, mutable_calls, view_calls, tier_topk_calls
    torch.cuda.empty_cache()
    stamp("phase 3 store top-K, metric, mutable and view calls")
    kd_times, kd_bounds, kd_visits = phase3_kdtree(card, kd_ctx, reps=10)
    times.update(kd_times)
    del kd_ctx
    stamp("phase 3 KD-tree")
    gen_p = torch.Generator(device=device)
    gen_p.manual_seed(1031)
    times.update(phase3_presplit(card, device, gen_p, persist, reps=10))
    shutil.rmtree(persist_dir)
    torch.cuda.empty_cache()
    stamp("phase 3 B12 over the store operands and a loaded index's first query")
    times.update(phase3_sharded(card, sharded_calls, reps=5))
    del sharded_calls, sharded_ctx
    torch.cuda.empty_cache()
    stamp("phase 3 the sharded tier beside the unsharded calls")

    for mod in ("jax", "tpu_knn"):
        if mod in sys.modules:
            fail(f"{mod} was imported")
    # Bounds at the timed shapes: (m, k, n, candidate width, extra bytes,
    # flops per (row, column, coordinate)): 2 for the score FMA, 3 for the
    # diff-form subtract and FMA.
    bounds = {
        "B1": bound(m11, k11, n11, 128, 0, 2),
        "B1 k=768": bound(EMBED768[1], EMBED768[0], EMBED768[2], 128, 0, 2),
        "B2": bound(m9, k9, n9, 128, 0, 3),
        "B4": bound(*topk_shapes["B4"], 2),
        "B5": bound(*topk_shapes["B5"], 2),
        "B6": bound(*topk_shapes["B6"], 3),
        "B3": seeded_bounds["B3 ds11 K=8"],
        "B7": seeded_bounds["B7 ds11 K=8"],
        "B8": seeded_bounds["compactor (16, 1024, 2^22) K=8"],
        "B9": seeded_bounds["compactor ds11 K=8"],
        "B10": ladder_bounds["B10 ds11"],
        "B11": ladder_bounds["B11"],
        "B1 AoS (v3)": ladder_bounds["B1 variants ds11"],
        "B1 constant-query (v6)": ladder_bounds["B1 variants ds11"],
        **tier_bounds,
        **bf16_bounds,
        "v10": kd_bounds["v10 ds10"],
    }
    errs["B8"] = errs["B9"] = errs["B8/B9"]
    errs["B1 AoS (v3)"] = errs["B1 constant-query (v6)"] = errs["B1 variants"]
    edge_errs["B1 AoS (v3)"] = edge_errs["B1 constant-query (v6)"] = edge_errs["B1 variants"]
    launches["B8"] = launches["B9"] = launches["B8/B9"]
    rows = [
        ("B1", "fused_candidates", "tpu_knn/kernels/fused.py:318", "B1 kernel ds11",
         "B1 plain ds11", "matmul ds11"),
        # The same kernel at k = 768: its own row, as its regime differs.
        ("B1 k=768", "fused_candidates (768, 1024, 2^20)", "tpu_knn/kernels/fused.py:318",
         "B1 kernel (768, 1024, 2^20)", "B1 plain (768, 1024, 2^20)",
         "matmul (768, 1024, 2^20)"),
        ("B2", "smallm_candidates", "tpu_knn/kernels/smallm.py:82", "B2 kernel ds9",
         "B2 plain ds9", None),
        ("B4", "banded_candidates", "tpu_knn/kernels/fused.py:506", "B4 kernel ds11",
         "B4 plain ds11", "matmul ds11"),
        ("B5", "sweep_candidates", "tpu_knn/kernels/topk.py:188",
         "B5 kernel (16, 8, 2^20) K=32", "B5 plain (16, 8, 2^20) K=32",
         "matmul (16, 8, 2^20)"),
        ("B6", "smallm_topk_candidates", "tpu_knn/kernels/topk.py:262",
         "B6 kernel (16, 4, 2^24) K=16", "B6 plain (16, 4, 2^24) K=16", None),
        ("B3", "minima_candidates", "tpu_knn/kernels/fused.py:613", "B3 kernel ds11 K=8",
         "B3 plain ds11 K=8", "matmul ds11 (seeded)"),
        ("B7", "extract_moments", "tpu_knn/kernels/topk.py:509", "B7 kernel ds11 K=8",
         "B7 plain ds11 K=8", "matmul ds11 (seeded)"),
        # One CUDA kernel serves both Pallas bodies: B8's row is timed at a
        # part width of 16384 (B8's regime), B9's at 4096.
        ("B8", "compact_cells (one kernel with B9)", "tpu_knn/kernels/topk.py:817",
         "compactor kernel (16, 1024, 2^22) K=8", "compactor plain (16, 1024, 2^22) K=8",
         None),
        ("B9", "compact_cells (one kernel with B8)", "tpu_knn/kernels/topk.py:899",
         "compactor kernel ds11 K=8", "compactor plain ds11 K=8", None),
        ("B10", "dma_candidates", "tpu_knn/kernels/dma_pipeline.py:44", "B10 kernel ds11",
         "B10 plain ds11", "matmul ds11"),
        ("B11", "window_candidates", "tpu_knn/kernels/projection.py:283",
         "B11 kernel (3, 16, 2^24)", "B11 plain (3, 16, 2^24)", None),
        # B1's two ladder variants: tpu_knn built both from _fused_kernel.
        ("B1 AoS (v3)", "aos_candidates", "tpu_knn/kernels/fused.py:318",
         "B1 AoS (v3) kernel ds11", "B1 plain ds11 at the variants' P", "matmul ds11"),
        ("B1 constant-query (v6)", "const_query_candidates", "tpu_knn/kernels/fused.py:318",
         "B1 constant-query (v6) kernel ds11", "B1 plain ds11 at the variants' P",
         "matmul ds11"),
        ("B2-bf16", "smallm_candidates (bf16 operand)", "tpu_knn/kernels/smallm.py:82",
         "B2-bf16 kernel", "B2-bf16 plain", None),
        # Not Pallas: tpu_knn's XLA while_loop; the reference's CUDA kernel.
        ("v10", "kdtree_traverse (3, 1024, 2^20)", "tpu_knn/kdtree/traversal.py:40",
         "v10 kernel ds10", "v10 plain ds10", None),
    ]
    # The bf16 instances: tpu_knn ran the same kernels over a bf16 store's
    # operand, upcast at the read; "f32_instance_ms" is the f32 instance at
    # the same launch.
    bf16_replaces = {"B1-bf16": "tpu_knn/kernels/fused.py:318",
                     "B4-bf16": "tpu_knn/kernels/fused.py:506",
                     "B3-bf16": "tpu_knn/kernels/fused.py:613",
                     "B5-bf16": "tpu_knn/kernels/topk.py:188",
                     "B6-bf16": "tpu_knn/kernels/topk.py:262",
                     "B7-bf16": "tpu_knn/kernels/topk.py:509"}
    bf16_shape = {"B1-bf16": "ds11", "B4-bf16": "ds11", "B3-bf16": "ds11 K=8",
                  "B7-bf16": "ds11 K=8", "B5-bf16": "(16, 8, 2^20) K=32",
                  "B6-bf16": "(16, 4, 2^24) K=16"}
    # The tensor-core kernel's instances: B1's tiers (at their main-path
    # shapes: packed3 at ds11, packed2 at k = 32, bf16x3 and qsplit2 at the
    # k = 768 embed shape) and B12; "matmul part" is cuBLAS's bf16 product.
    rows += [(row, "tensor_candidates" if row != "B12" else "presplit_candidates",
              "tpu_knn/kernels/fused.py:" + ("290" if row == "B12" else "318"),
              f"{row} kernel", f"{row} plain", f"{row} matmul part")
             for row in ("B1 packed3", "B1 packed2", "B1 bf16x3", "B1 bf16x4", "B1 qsplit2",
                         "B1 default", "B12")]
    # Each kernel's source file under tpu_knn_torch/csrc/.
    family = {"B1": "fused", "B1 k=768": "fused", "B4": "fused", "B10": "fused", "B1 AoS (v3)": "fused",
              "B1 constant-query (v6)": "fused", "B2": "smallm", "B6": "smallm",
              "B5": "sweep", "B3": "seeded", "B7": "seeded", "B8": "seeded", "B9": "seeded",
              "B11": "window", "B2-bf16": "smallm", "B1-bf16": "fused", "B4-bf16": "fused",
              "B3-bf16": "seeded", "B7-bf16": "seeded", "B5-bf16": "sweep", "B6-bf16": "smallm",
              "v10": "kdtree"}
    family.update({row: "tensor" for row in tier_rows if row != "B2-bf16"})
    # B11 also at v11's ds8 and ds10 launches; B2-bf16 also with its
    # operand out of L2.
    extras = {"B11": {f"{key}_{label}": value for label in ("ds8", "ds10")
                      for key, value in (("device_ms", times[f"B11 kernel {label} device"]),
                                         ("ms", times[f"B11 kernel {label}"]),
                                         ("bound_ms", ladder_bounds[f"B11 {label}"][0]))},
              "B2-bf16": {"device_ms_l2_flushed": times["B2-bf16 kernel device L2 flushed"]},
              "v10": {"ms_kd_row": times["v10 kernel KD row (3, 1024, 2^16)"],
                      "records_ms_ds10": times["v10 records ds10"],
                      "DeviceKDTree_host_ms_ds10": times["v10 DeviceKDTree ds10 host"],
                      "lanes_a_query": traversal.traverse_lanes(3),
                      "device_ms_kd_row": times["v10 kernel KD row (3, 1024, 2^16) device"],
                      "plain_ms_kd_row": times["v10 plain KD row (3, 1024, 2^16)"],
                      "bound_ms_kd_row": kd_bounds["v10 KD row (3, 1024, 2^16)"][0],
                      "visits_ds10": kd_visits["ds10"],
                      "visits_kd_row": kd_visits["KD row (3, 1024, 2^16)"],
                      "v9_query_host_ms_ds10": times["v9 query ds10 host"],
                      "v9_query_host_ms_kd_row": times["v9 query KD row (3, 1024, 2^16) host"]},
              "B12": {"launches_beside_the_stores": counts_presplit["B12"],
                      **{f"ds11_ms_over_the_{src.replace(' ', '_')}":
                         times[f"B12 over the {src}"]
                         for src in ("f32 split", "bf16 store", "int8 grid")}}}
    # No single PyTorch call computes a per-lane fold, so library_ms is
    # null; matmul_part_ms is cuBLAS's product of the same score matrix
    # (f32 with TF32 off for the f32 kernels, bf16 for the tensor-core
    # tiers), a part of the kernel's work only.
    kernels = [
        {"name": f"{kid} {fname}", "route": "cuda",
         "source": f"tpu_knn_torch/csrc/{family[kid]}_kernels.cu", "replaces": replaces,
         "launches": launches[kid], "max_abs_err": errs[kid],
         "ms": times[t_kernel], "plain_ms": times[t_plain],
         "bound_ms": bounds[kid][0], "bound_by": bounds[kid][1],
         "library_ms": None,
         "matmul_part_ms": times[t_matmul] if t_matmul else None,
         **({"tier_rel_err": tier_rel[kid], "tier_err_over_gate": tier_gate_share[kid],
             "tier_eps": fused._TIER_EPS["bf16x3_presplit" if kid == "B12" else kid[3:]],
             "highest_ms": times[f"{kid} B1 highest"]} if kid in tier_rel else {}),
         **({"tile_edges_max_abs_err": edge_errs[kid]} if kid in edge_errs else {}),
         **({"device_ms": times[f"{t_kernel} device"]} if f"{t_kernel} device" in times
            else {}),
         **extras.get(kid, {})}
        for kid, fname, replaces, t_kernel, t_plain, t_matmul in rows]
    kernels += [
        {"name": f"{kid} {BF16_ROWS[kid][1]} (bf16 operand) {bf16_shape[kid]}", "route": "cuda",
         "source": f"tpu_knn_torch/csrc/{family[kid]}_kernels.cu",
         "replaces": bf16_replaces[kid], "launches": launches[kid], "max_abs_err": errs[kid],
         "ms": times[f"{kid} kernel"], "plain_ms": times[f"{kid} plain"],
         "bound_ms": bounds[kid][0], "bound_by": bounds[kid][1], "library_ms": None,
         "device_ms": times[f"{kid} kernel device"],
         "f32_instance_ms": times[f"{kid} f32 instance"],
         "f32_instance_device_ms": times[f"{kid} f32 instance device"]}
        for kid in BF16_ROWS]
    # The top-K kernels' tier instances: each kernel at the engines' ds11
    # launch (packed3) and at k = 768 (bf16x3 over f32, qsplit2 over a bf16
    # store's operand), "highest_ms" the same launch on the tiled f32 kernel
    # (its bf16 instance over a bf16 operand); "matmul part" as for B1's
    # tiers.
    for precision, kind, k, m, n in TOPK_TIER_TIMED:
        tier = tiers.resolved_tier(precision, k)
        for kid, (wrapper, replaces, source) in TOPK_TIER_KERNELS.items():
            row = f"{kid}{'-bf16' if kind == 'bf16' else ''} {tier}"
            kernels.append({
                "name": f"{row} {wrapper} (k={k}, m={m}, n={n}) K={TOPK_TIER_K}", "route": "cuda",
                "source": f"tpu_knn_torch/csrc/{source}", "replaces": replaces,
                "launches": launches[row], "max_abs_err": errs[row],
                "ms": times[f"{row} kernel"], "plain_ms": topk_tier_plain[row],
                "bound_ms": topk_tier_bounds[row][0], "bound_by": topk_tier_bounds[row][1],
                "library_ms": None, "matmul_part_ms": times[f"{row} matmul part"],
                "highest_ms": times[f"{row} highest"],
                "device_ms": times[f"{row} kernel device"]})
    # B3 at depth 2 and above a lo at ds11, B5 at the serving shapes: their
    # rows' launches (every launch of the tier row on the main path).
    extra = [(row, "B3", DS11, 8, "B3 packed3") for row in B3_EXTRA_ROWS]
    extra += [(b5_serve_row(k, m, n, kk), "B5", (k, m, n), kk, "B5 packed3")
              for k, m, n, kk in B5_SERVE_CASES]
    for row, kid, (k, m, n), kk, launch_row in extra:
        wrapper, replaces, source = TOPK_TIER_KERNELS[kid]
        kernels.append({
            "name": f"{row} {wrapper} (k={k}, m={m}, n={n}) K={kk}", "route": "cuda",
            "source": f"tpu_knn_torch/csrc/{source}", "replaces": replaces,
            "launches": launches[launch_row], "max_abs_err": errs[row],
            "ms": times[f"{row} kernel"], "plain_ms": topk_tier_plain[row],
            "bound_ms": topk_tier_bounds[row][0], "bound_by": topk_tier_bounds[row][1],
            "library_ms": None, "highest_ms": times[f"{row} highest"],
            "device_ms": times[f"{row} kernel device"]})
    # The ladder's tier instances: v3, B10 and v6 at the main path's ds11
    # launch (packed3) and at k = 768 (bf16x3: v3 and B10 at (768, 1024,
    # 2^18), v6 with its live rows at (768, 16, 2^20)); "highest_ms" the same
    # rung on its tiled f32 kernel, "b1_tier_ms" B1's tier launch at its P.
    timed_names = ladder_timed_names()
    for precision, (k, m, n), rungs in LADDER_TIER_TIMED:
        tier = tiers.resolved_tier(precision, k)
        for rung in rungs:
            row = tiers.ladder_tier_row(rung, precision, k)
            timed = timed_names[precision, (k, m, n), rung]
            wrapper, replaces = LADDER_TIER_KERNELS[rung][:2]
            kernels.append({
                "name": f"{row} {wrapper} (k={k}, m={m}, n={n})", "route": "cuda",
                "source": "tpu_knn_torch/csrc/tensor_ladder_kernels.cu", "replaces": replaces,
                "launches": launches[row], "max_abs_err": errs[row],
                "ms": times[f"{timed} kernel"], "plain_ms": ladder_tier_plain[row, (k, m, n)],
                "bound_ms": ladder_tier_bounds[timed][0],
                "bound_by": ladder_tier_bounds[timed][1],
                "library_ms": None, "device_ms": times[f"{timed} kernel device"],
                "highest_ms": times[f"{timed} highest"],
                "highest_device_ms": times[f"{timed} highest device"],
                "b1_tier_ms": times[f"B1 {tier} at ({k}, {m}, {n})"],
                "b1_tier_device_ms": times[f"B1 {tier} at ({k}, {m}, {n}) device"]})
    log(f"version {tpu_knn_torch.__version__}; {card}; "
        f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
