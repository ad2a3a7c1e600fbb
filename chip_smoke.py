#!/usr/bin/env python3
"""Smoke run of the tpu_knn_torch port on one H100.

    python3 chip_smoke.py        # from the repository root; one CUDA card

Phases, in order; any failure raises and the script exits nonzero:

0. setup: requires an sm_90 card, prints its name and power limit, turns
   TF32 off, builds the CUDA kernels from tpu_knn_torch/csrc (build time
   and the ptxas report are printed);
1. each kernel (B1 fused candidates, B2 small-m candidates, B4 banded
   candidates, B5 sweep candidates, B6 small-m top-K candidates) against
   its plain torch version on the card, at a grid of shapes and at the
   shapes the main path gives it, with planted exact duplicates at a
   partition boundary and a lane boundary; B4 also bit-equal to B1 with a
   bound that masks exactly, B5 also equal to the passes engine;
2. the main paths, each with every launch counter set to 0 just before it
   and read just after:
   - 1-NN: the 8 TA shapes through knn_callback (v7 default, v4, v0)
     against tests/golden/results_seed1000.csv, and ds11 = (16, 1024,
     2^20) / ds9 = (16, 1, 2^24) per call and through NNIndex, checked by
     an independent exact scan on the card with the harness's ±1e-3 rule;
   - top-K: topk_knn (sweep at m = 8 and 32, passes at ds11 and K = 64),
     NNIndex.query(neighbors=16) at (16, 4, 2^24) and m = 1,
     nearest_neighbors(neighbors=8), each checked rank by rank against an
     independent exact top-K scan with the same rule; one
     within_radius_complete escalation; auto at m*K > 256 raising;
3. times (CUDA events, medians) of the kernels, their plain versions, the
   cuBLAS product of B1/B4/B5's score matrices and the main paths, each
   printed beside the card's name and power limit.

The last two lines are a JSON summary of the kernels and the result line
{"ok": true, "device": {...}}. The script imports neither jax nor the
JAX package tpu_knn.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden", "results_seed1000.csv")

DS11 = (16, 1024, 1 << 20)
DS9 = (16, 1, 1 << 24)

#: Phase 1 tolerances: candidate indices agree on at least this share of
#: (row, lane) slots (a near-tie inside one lane may resolve differently
#: under another f32 summation order); scores agree within this fraction
#: of the largest |score| (f32 summation order, k <= 32 terms).
MIN_INDEX_AGREEMENT = 0.9999
SCORE_RTOL = 1e-5


def log(*args):
    print(*args, flush=True)


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


# ---- phase 1: kernel vs plain ------------------------------------------


def compare_candidates(name, kern, plain, q, r_op, n, parts, cutoff):
    """Run kernel and plain version on the same inputs; check the phase-1
    tolerances and that the refined 1-NN answers are identical. Returns
    the largest |score difference| on agreeing slots."""
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
    if err > SCORE_RTOL * max(scale, 1e-30):
        fail(f"{name}: score difference {err} > {SCORE_RTOL} x {scale}")
    if not same:
        fail(f"{name}: refined 1-NN indices differ")
    if q.is_cuda:
        torch.cuda.synchronize(q.device)
    return err


def slot_agreement(name, ki, ks, pi, ps):
    """Share of candidate slots whose indices agree, and the largest score
    difference on those slots; fails below MIN_INDEX_AGREEMENT or above
    SCORE_RTOL of the largest |score|."""
    import torch

    agree = ki == pi
    share = agree.float().mean().item()
    finite = agree & torch.isfinite(ps) & torch.isfinite(ks)
    scale = ps[finite].abs().max().item() if finite.any() else 0.0
    err = (ks - ps)[finite].abs().max().item() if finite.any() else 0.0
    if share < MIN_INDEX_AGREEMENT:
        fail(f"{name}: candidate indices agree on {share:.6f} < {MIN_INDEX_AGREEMENT}")
    if err > SCORE_RTOL * max(scale, 1e-30):
        fail(f"{name}: score difference {err} > {SCORE_RTOL} x {scale}")
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


def phase1_topk(device, gen, b4_cases, b5_cases, b6_cases):
    """B4, B5 and B6 against their plain versions (and B4 against B1)."""
    import torch

    from tpu_knn_torch.kernels import fused, smallm, topk
    from tpu_knn_torch.kernels.fused import prep_soa
    from tpu_knn_torch.utils.shapes import round_up

    errs = {"B4": 0.0, "B5": 0.0, "B6": 0.0}
    for k, m, n, parts in b4_cases:
        q = uniform(gen, (m, k), device)
        r_op = prep_soa(uniform(gen, (n, k), device), round_up(n, 128))
        parts = parts or fused.default_parts(m, k, n)
        plant_duplicates(q, r_op, n, parts)
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
        share, err, scale = slot_agreement("B4", ki, ks, pi, ps)
        errs["B4"] = max(errs["B4"], err)
        log(f"  B4: m={m} k={k} n={n} P={parts}: bit-equal to B1, bound masks exactly; "
            f"pass-2 index agreement {share:.6f}, max |score diff| {err:.3g} "
            f"(max |score| {scale:.3g})")
    for k, m, n, kk, parts in b5_cases:
        q = uniform(gen, (m, k), device)
        r = uniform(gen, (n, k), device)
        r_op = prep_soa(r, round_up(n, 128))
        parts = parts or topk.sweep_parts(m, kk, n)
        plant_duplicates(q, r_op, n, parts)
        r = r_op[:k, :n].T.contiguous()
        ki, ks = topk.sweep_candidates(q, r_op, n, parts, kk)
        pi, ps = topk.sweep_candidates_plain(q, r_op, n, parts, kk)
        share, err, _ = slot_agreement("B5", ki, ks, pi, ps)
        errs["B5"] = max(errs["B5"], err)
        got = topk._finalize_topk(q, r, ki, ks, kk, n)
        near = same_topk("B5", got, topk._finalize_topk(q, r, pi, ps, kk, n))
        passes = topk._build_topk(m, n, k, kk, "passes")(q, (r_op,), r)
        if not (torch.equal(got[0], passes[0]) and torch.equal(got[1], passes[1])):
            fail(f"B5 m={m} k={k} n={n} K={kk}: sweep and passes disagree on the card")
        log(f"  B5: m={m} k={k} n={n} K={kk} P={parts}: slot agreement {share:.6f}, "
            f"top-K identical to plain (near-tie ranks {near}) and to the passes engine")
    for k, m, n, kk, parts in b6_cases:
        q = uniform(gen, (m, k), device)
        r = uniform(gen, (n, k), device)
        r_op = prep_soa(r, round_up(n, 128))
        parts = parts or topk.smallm_topk_parts(m, kk, n)
        plant_duplicates(q, r_op, n, parts)
        r = r_op[:k, :n].T.contiguous()
        p1 = smallm.default_parts(n)

        def bound_of(b2):
            _, cs1 = b2(q, r_op, n, p1)
            return torch.topk(cs1, kk, dim=-1, largest=False).values[:, -1].contiguous()

        b_k, b_p = bound_of(smallm.smallm_candidates), bound_of(smallm.smallm_candidates_plain)
        ki, ks = topk.smallm_topk_candidates(q, r_op, n, parts, kk, b_k)
        pi, ps = topk.smallm_topk_candidates_plain(q, r_op, n, parts, kk, b_p)
        real = ki < n
        if not (((ks <= b_k[:, None]) | ~real).all()
                and (ks[~real] == b_k[:, None].expand_as(ks)[~real]).all()):
            fail(f"B6 m={m} k={k} n={n} K={kk}: an entry above the bound or a bad seed")
        agree = (ki == pi) & real
        err = (ks - ps)[agree].abs().max().item() if agree.any() else 0.0
        errs["B6"] = max(errs["B6"], err)
        near = same_topk("B6", topk._finalize_topk(q, r, ki, ks, kk, n),
                         topk._finalize_topk(q, r, pi, ps, kk, n))
        log(f"  B6: m={m} k={k} n={n} K={kk} P={parts}: {int(real.sum())} real entries "
            f"under the bound, top-K identical to plain (near-tie ranks {near}), "
            f"max |score diff| {err:.3g}")
    torch.cuda.synchronize(device)
    return errs


def phase1(device, gen, b1_cases, b2_cases):
    from tpu_knn_torch.kernels import fused, smallm
    from tpu_knn_torch.kernels.fused import prep_soa, select_cutoff
    from tpu_knn_torch.utils.shapes import round_up

    errs = {"B1": 0.0, "B2": 0.0}
    for k, m, n, parts in b1_cases:
        q = uniform(gen, (m, k), device)
        r_op = prep_soa(uniform(gen, (n, k), device), round_up(n, 128))
        parts = parts or fused.default_parts(m, k, n)
        plant_duplicates(q, r_op, n, parts)
        errs["B1"] = max(errs["B1"], compare_candidates(
            "B1", fused.fused_candidates, fused.fused_candidates_plain,
            q, r_op, n, parts, select_cutoff("highest", k)))
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


def gate_errors(q, r, idx) -> int:
    """The harness rule (tpu_knn_torch.harness.checker.check_results) on
    the card: an index is right if it equals the exact scan's, or if the
    two points' true distances agree within ±1e-3."""
    import torch

    from tpu_knn_torch.harness.checker import TOLERANCE

    idx = torch.as_tensor(idx, device=q.device).long()
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
    0 errors under the harness rule, for v7 (default), v4 and v0."""
    import numpy as np

    import tpu_knn_torch
    from tpu_knn_torch.harness.checker import check_results
    from tpu_knn_torch.harness.generator import ta_sample_stream

    golden = read_golden()
    for ((k, m, n), search, ref), gold in zip(ta_sample_stream(), golden):
        for version in (None, "v4", "v0"):
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
    ctx = {"q1024": q1024, "q8": q8, "q32": q32, "q4": q4, "r20": r20,
           "index24": index24}
    try:
        topk_knn(q64, r20, 8)
    except NotImplementedError as e:
        if "A.5.4" not in str(e):
            fail(f"auto at m*K > 256 raised without naming A.5.4: {e}")
        log("  topk_knn auto at m*K = 512 raises NotImplementedError naming A.5.4")
    else:
        fail("topk_knn auto at m*K > 256 did not raise NotImplementedError")
    return calls, ctx


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
    p1 = fused.default_parts(m, k, n)
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
    return times


def phase3_topk(card: str, ctx, calls, reps: int):
    """Times of B4, B5 and B6 and their plain versions at the main path's
    shapes, the cuBLAS f32 product of B4's and B5's score matrices (a part
    of their work, not the same function), and each phase-2 top-K call.
    Returns (times, shapes), shapes holding what bound_ms needs."""
    import torch

    from tpu_knn_torch.kernels import fused, smallm, topk
    from tpu_knn_torch.kernels.fused import prep_soa
    from tpu_knn_torch.utils.timing import time_ms

    q1024, q8, q4, r20 = ctx["q1024"], ctx["q8"], ctx["q4"], ctx["r20"]
    n20 = r20.shape[0]
    r_op20 = prep_soa(r20, n20)
    r_op24 = ctx["index24"].r_ops[0]
    n24 = ctx["index24"].n
    p4 = fused.default_parts(q1024.shape[0], 16, n20)
    i1, s1 = topk._lex_min(*fused.fused_candidates(q1024, r_op20, n20, p4))
    p5 = topk.sweep_parts(q8.shape[0], 32, n20)
    p6 = topk.smallm_topk_parts(q4.shape[0], 16, n24)
    _, cs1 = smallm.smallm_candidates(q4, r_op24, n24, smallm.default_parts(n24))
    b6 = torch.topk(cs1, 16, dim=-1, largest=False).values[:, -1].contiguous()
    times = {}
    times.update(time_ms({
        "B4 kernel ds11": lambda: fused.banded_candidates(q1024, r_op20, n20, p4, s1, i1),
        "B4 plain ds11": lambda: fused.banded_candidates_plain(q1024, r_op20, n20, p4, s1, i1),
        "matmul ds11": lambda: torch.matmul(q1024, r_op20[:16]),
    }, reps))
    times.update(time_ms({
        "B5 kernel (16, 8, 2^20) K=32": lambda: topk.sweep_candidates(q8, r_op20, n20, p5, 32),
        "B5 plain (16, 8, 2^20) K=32":
            lambda: topk.sweep_candidates_plain(q8, r_op20, n20, p5, 32),
        "matmul (16, 8, 2^20)": lambda: torch.matmul(q8, r_op20[:16]),
    }, reps))
    times.update(time_ms({
        "B6 kernel (16, 4, 2^24) K=16":
            lambda: topk.smallm_topk_candidates(q4, r_op24, n24, p6, 16, b6),
        "B6 plain (16, 4, 2^24) K=16":
            lambda: topk.smallm_topk_candidates_plain(q4, r_op24, n24, p6, 16, b6),
    }, reps))
    times.update(time_ms({name: fn for name, (_, _, _, fn) in calls.items()}, reps))
    for name, ms in times.items():
        log(f"  time {name}: median {ms:.4f} ms over {reps} runs [{card}]")
    m4, m5, m6 = q1024.shape[0], q8.shape[0], q4.shape[0]
    shapes = {"B4": (m4, 16, n20, 128, 8 * m4),
              "B5": (m5, 16, n20, 32 * 128, 0),
              "B6": (m6, 16, n24, 16 * 128, 4 * m6)}
    return times, shapes


#: The card's published peaks (one H100 SXM at 700 W): f32 on the CUDA
#: cores, and device-memory bandwidth.
F32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound(m, k, n, width, extra_bytes, flops_per_term):
    """The least time (ms) the card could take for a candidate launch:
    the larger of its bytes (queries and the k used rows of the operand
    read once, the (m, width) int32 + f32 candidates written once, plus
    extra_bytes of bounds) over the memory rate, and its flops
    (flops_per_term * m * n * k) over the f32 peak. width is what the
    kernel's contract must emit (128 lanes, or K * 128 for a top-K
    kernel), not the P-partition width a launch chose, so a wider grid
    cannot raise the bound."""
    nbytes = 4 * (m * k + k * n) + 8 * m * width + extra_bytes
    flops = flops_per_term * m * n * k
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_PEAK_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---- main ------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    import tpu_knn_torch
    from tpu_knn_torch.csrc import build
    from tpu_knn_torch.kernels import fused, smallm, topk
    from tpu_knn_torch.kernels.twolevel import DEFAULT_PARTITIONS

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
            for line in f.read().splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    log(f"  ptxas: {line.strip()}")

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
                 (*DS9, max(DEFAULT_PARTITIONS, fused.default_parts(m9, k9, n9)))]
    b2_cases = [(k, m, 1000, parts) for k in (8, 16, 32) for m in (1, 3, 4)
                for parts in (1, None)]
    b2_cases += [(16, 1, 1 << 24, None), (8, 3, 1 << 24, None), (32, 4, 1 << 24, None)]
    # B2 as pass 1 of the small-m top-K path: the prepared (16, 4, 2^24)
    # query and nearest_neighbors(neighbors=8) at (16, 3, 2^20).
    b2_cases += [(16, 4, 1 << 24, None), (16, 3, 1 << 20, None)]
    errs = phase1(device, gen, b1_cases, b2_cases)
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

    # Phase 2: each path runs with every launch counter set to 0 just
    # before it and read just after.
    counters = {"B1": fused.fused_candidates, "B2": smallm.smallm_candidates,
                "B4": fused.banded_candidates, "B5": topk.sweep_candidates,
                "B6": topk.smallm_topk_candidates}

    def drive(path, needs, run):
        for fn in counters.values():
            fn.launches = 0
        out = run()
        counts = {kname: fn.launches for kname, fn in counters.items()}
        log(f"  kernel launches on the {path} path: {counts}")
        for kname in needs:
            if counts[kname] < 1:
                fail(f"{kname} was not launched on the {path} path")
        return out, counts

    log("phase 2: main path")
    (big11, big9), counts_1nn = drive(
        "1-NN", ("B1", "B2"),
        lambda: (phase2_ta(device), phase2_big(device, gen, DS11, DS9))[1])
    log("phase 2: top-K path")
    (calls, ctx), counts_topk = drive("top-K", ("B2", "B4", "B5", "B6"),
                                      lambda: phase2_topk(device, gen))
    launches = {kname: counts_1nn[kname] + counts_topk[kname] for kname in counters}

    # Phase 3
    log("phase 3: times")
    times = phase3(card, big11, big9, reps=10)
    topk_times, topk_shapes = phase3_topk(card, ctx, calls, reps=10)
    times.update(topk_times)

    for mod in ("jax", "tpu_knn"):
        if mod in sys.modules:
            fail(f"{mod} was imported")
    # Bounds at the timed shapes: (m, k, n, candidate width, extra bytes,
    # flops per (row, column, coordinate)): 2 for the score FMA, 3 for the
    # diff-form subtract and FMA.
    k11, m11, n11 = DS11
    bounds = {
        "B1": bound(m11, k11, n11, 128, 0, 2),
        "B2": bound(m9, k9, n9, 128, 0, 3),
        "B4": bound(*topk_shapes["B4"], 2),
        "B5": bound(*topk_shapes["B5"], 2),
        "B6": bound(*topk_shapes["B6"], 3),
    }
    rows = [
        ("B1", "fused_candidates", "tpu_knn/kernels/fused.py:318", "B1 kernel ds11",
         "B1 plain ds11", "matmul ds11"),
        ("B2", "smallm_candidates", "tpu_knn/kernels/smallm.py:82", "B2 kernel ds9",
         "B2 plain ds9", None),
        ("B4", "banded_candidates", "tpu_knn/kernels/fused.py:506", "B4 kernel ds11",
         "B4 plain ds11", "matmul ds11"),
        ("B5", "sweep_candidates", "tpu_knn/kernels/topk.py:188",
         "B5 kernel (16, 8, 2^20) K=32", "B5 plain (16, 8, 2^20) K=32",
         "matmul (16, 8, 2^20)"),
        ("B6", "smallm_topk_candidates", "tpu_knn/kernels/topk.py:262",
         "B6 kernel (16, 4, 2^24) K=16", "B6 plain (16, 4, 2^24) K=16", None),
    ]
    # No single PyTorch call computes a per-lane fold, so library_ms is
    # null; matmul_part_ms is cuBLAS's f32 product of the same score
    # matrix (TF32 off), a part of the kernel's work only.
    kernels = [
        {"name": f"{kid} {fname}", "route": "cuda",
         "source": "tpu_knn_torch/csrc/knn_kernels.cu", "replaces": replaces,
         "launches": launches[kid], "max_abs_err": errs[kid],
         "ms": times[t_kernel], "plain_ms": times[t_plain],
         "bound_ms": bounds[kid][0], "bound_by": bounds[kid][1],
         "library_ms": None,
         "matmul_part_ms": times[t_matmul] if t_matmul else None}
        for kid, fname, replaces, t_kernel, t_plain, t_matmul in rows]
    log(f"version {tpu_knn_torch.__version__}; {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
