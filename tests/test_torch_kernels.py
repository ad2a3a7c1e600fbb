"""Kernels B1–B12 (B8/B9 one compactor; B1's tensor-core tiers, its AoS and
resident-query variants, B2 over a bf16 operand, and B4, B5, B3 and B7's
tensor-core tier instances) and v10's KD-tree
traversal against their plain torch versions on an sm_90 card, and a save
-> load round trip there.

Skipped without a card. This file imports no jax, so on a machine with the
card but without jax it runs apart from the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import pytest
import torch

from tpu_knn_torch.kernels import dma_pipeline, fused, projection, seeded, smallm, tiers, topk
from tpu_knn_torch.kernels.fused import _refine, prep_soa, select_cutoff

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an sm_90 CUDA card")
    return torch.device("cuda", 0)


def _inputs(device, m, k, n, seed):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    q = torch.rand((m, k), generator=gen, device=device)
    r = torch.rand((n, k), generator=gen, device=device)
    r[n // 2] = r[n // 2 + 1] = q[0]          # exact duplicate pair
    return q, r, prep_soa(r, -(-n // 128) * 128 + 128)


def _check(kernel, plain, q, r, r_op, n, parts, cutoff):
    before = kernel.launches
    ki, ks = kernel(q, r_op, n, parts)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    pi, ps = plain(q, r_op, n, parts)
    agree = ki == pi
    assert agree.float().mean().item() >= 0.9999
    # Two f32 summation orders of k terms: the gap grows with k (1e-5
    # covers k <= 32, as in chip_smoke.py).
    rtol = max(1e-5, 4 * q.shape[1] * 2.0 ** -24)
    scale = ps[torch.isfinite(ps)].abs().max()
    assert ((ks - ps)[agree & torch.isfinite(ps)].abs() <= rtol * scale).all()
    assert torch.equal(_refine(q, r, (ki, ks), n, cutoff=cutoff)[0],
                       _refine(q, r, (pi, ps), n, cutoff=cutoff)[0])
    assert int(_refine(q, r, (ki, ks), n, cutoff=cutoff)[0][0]) == n // 2


@pytest.mark.parametrize("k,m,n,parts", [
    (3, 40, 1000, 1), (16, 100, 70_000, 7), (5, 1, 3000, 3), (40, 9, 5000, 4),
    (768, 40, 5000, 5),   # 48 d-chunks per column tile
    (7000, 3, 300, 2),    # 438 d-chunks, the last one ragged
])
def test_b1_matches_plain(device, k, m, n, parts):
    q, r, r_op = _inputs(device, m, k, n, seed=k + m)
    _check(fused.fused_candidates, fused.fused_candidates_plain, q, r, r_op,
           n, parts, select_cutoff("highest", k))


# The tiled f32 kernel's edges (k, m, n, P, ld): m past a whole block of
# 8 * TM rows, n ragged against a column tile and 128, k ragged against the
# 16-row chunk, k = 1, 768 and 7000, and ld not a multiple of 4 (its
# 4-byte copy path).
TILE_EDGES = [
    (1, 65, 3149, 2, 3200), (17, 9, 1000, 1, 1001), (40, 33, 9077, 3, None),
    (16, 2, 2049, 5, 2051), (768, 70, 5077, 4, None), (7000, 3, 300, 1, None),
]


def _edge_inputs(device, m, k, n, ld, seed):
    """_inputs over an operand of ld columns, with query min(2, m-1) copied
    into lane 37's columns of groups 1, 2 (one column tile) and 9 (the
    next)."""
    q, r, _ = _inputs(device, m, k, n, seed)
    for g in (1, 2, 9):
        if g * 128 + 37 < n:
            r[g * 128 + 37] = q[min(2, m - 1)]
    return q, r, prep_soa(r, ld or -(-n // 128) * 128)


def _lane37_columns(n, parts):
    """The tie's columns that lie in partition 0 (lane 37 folds them)."""
    end = min(n, -(-(-(-n // 128)) // parts) * 128)
    return [c for c in (128 + 37, 256 + 37, 9 * 128 + 37) if c < end]


@pytest.mark.parametrize("k,m,n,parts,ld", TILE_EDGES)
def test_b1_matches_plain_at_tile_edges(device, k, m, n, parts, ld):
    q, r, r_op = _edge_inputs(device, m, k, n, ld, seed=k + m)
    _check(fused.fused_candidates, fused.fused_candidates_plain, q, r, r_op,
           n, parts, select_cutoff("highest", k))
    ties = _lane37_columns(n, parts)
    if ties:   # the lane keeps its earliest column through equal scores
        ki, _ = fused.fused_candidates(q, r_op, n, parts)
        assert int(ki[min(2, m - 1), 37]) == ties[0]


@pytest.mark.parametrize("k,m,n,parts,ld", TILE_EDGES)
def test_b4_is_b1_and_masks_exactly_at_tile_edges(device, k, m, n, parts, ld):
    q, r, r_op = _edge_inputs(device, m, k, n, ld, seed=k + 3 * m)
    lo_s = torch.full((m,), -torch.inf, device=device)
    lo_i = torch.full((m,), -1, dtype=torch.int32, device=device)
    bi, bs = fused.banded_candidates(q, r_op, n, parts, lo_s, lo_i)
    fi, fs = fused.fused_candidates(q, r_op, n, parts)
    assert torch.equal(bi, fi) and torch.equal(bs, fs)
    # Bound at each row's lane-37 candidate: every slot reports what lies
    # lexicographically above it, and the tie's next column takes lane 37.
    b_s, b_i = fs[:, 37].contiguous(), fi[:, 37].contiguous()
    ki, ks = fused.banded_candidates(q, r_op, n, parts, b_s, b_i)
    # The passes engine's form, q's transposed copy made once per call.
    got = fused.banded_candidates(q, r_op, n, parts, b_s, b_i, fused.transposed_queries(q))
    assert torch.equal(got[0], ki) and torch.equal(got[1], ks)
    above = (ks > b_s[:, None]) | ((ks == b_s[:, None]) & (ki > b_i[:, None]))
    assert (above | (ki == 2**31 - 1)).all()
    ties = _lane37_columns(n, parts)
    if len(ties) > 1:
        row = min(2, m - 1)
        assert int(ki[row, 37]) == ties[1] and float(ks[row, 37]) == float(fs[row, 37])


@pytest.mark.parametrize("k,m,n,parts", [
    (8, 1, 1000, 1), (16, 3, 70_000, 9), (32, 4, 5000, 2), (3, 2, 777, 3),
])
def test_b2_matches_plain(device, k, m, n, parts):
    q, r, r_op = _inputs(device, m, k, n, seed=k * m)
    _check(smallm.smallm_candidates, smallm.smallm_candidates_plain, q, r, r_op,
           n, parts, select_cutoff("exact", k))


def test_wrappers_raise_instead_of_falling_back(device):
    q = torch.rand((4, 3), device=device)
    r_op = torch.rand((8, 256), device=device)
    with pytest.raises(ValueError, match="contiguous"):
        fused.fused_candidates(q, torch.rand((256, 8), device=device).T, 200, 1)
    with pytest.raises(ValueError):
        fused.fused_candidates(q, r_op.cpu(), 200, 1)
    with pytest.raises(ValueError):
        smallm.smallm_candidates(torch.rand((5, 3), device=device), r_op, 200, 1)
    with pytest.raises(ValueError, match="bound_s"):
        fused.banded_candidates(q, r_op, 200, 1, torch.zeros(4).cuda().double(),
                                torch.zeros(4, dtype=torch.int32, device=device))
    with pytest.raises(ValueError, match="bound"):
        topk.smallm_topk_candidates(q, r_op, 200, 1, 4, torch.zeros(3, device=device))
    with pytest.raises(ValueError, match="q_t"):
        fused.banded_candidates(q, r_op, 200, 1, torch.zeros(4, device=device),
                                torch.zeros(4, dtype=torch.int32, device=device),
                                torch.zeros((3, 3), device=device))


# ---- top-K kernels B4, B5, B6 ---------------------------------------------


def _dup_inputs(device, m, k, n, seed):
    """Inputs with exact duplicates of query 0 astride a lane boundary
    (127 | 128) and a duplicate pair far apart in one lane."""
    q, r, _ = _inputs(device, m, k, n, seed)
    r[127] = r[128] = q[0]
    r[300] = r[300 + 128 * 3] = r[n // 3]
    return q, r, prep_soa(r, -(-n // 128) * 128)


@pytest.mark.parametrize("k,m,n,parts", [
    (16, 100, 70_000, 7), (5, 1, 3000, 3), (3, 40, 1000, 1), (40, 9, 5000, 4),
])
def test_b4_scores_are_b1s_and_the_bound_masks_exactly(device, k, m, n, parts):
    q, r, r_op = _dup_inputs(device, m, k, n, seed=k + 2 * m)
    lo_s = torch.full((m,), -torch.inf, device=device)
    lo_i = torch.full((m,), -1, dtype=torch.int32, device=device)
    before = fused.banded_candidates.launches
    bi, bs = fused.banded_candidates(q, r_op, n, parts, lo_s, lo_i)
    torch.cuda.synchronize()
    assert fused.banded_candidates.launches == before + 1
    fi, fs = fused.fused_candidates(q, r_op, n, parts)
    assert torch.equal(bi, fi) and torch.equal(bs, fs)      # bit-identical to B1
    # Pass 2, seeded with pass 1's report, never reports it again and
    # reports what lies lexicographically above it.
    i1, s1 = topk._lex_min(bi, bs)
    i2, s2 = topk._lex_min(*fused.banded_candidates(q, r_op, n, parts, s1, i1))
    assert not (i2 == i1).any()
    assert ((s2 > s1) | ((s2 == s1) & (i2 > i1))).all()
    assert int(i1[0]) == 127 and int(i2[0]) == 128          # the planted tie
    # The plain version against the kernel, each seeded with its own
    # pass 1 (their scores differ in the last bits).
    p1_i, p1_s = topk._lex_min(*fused.banded_candidates_plain(q, r_op, n, parts,
                                                              lo_s, lo_i))
    pi, ps = fused.banded_candidates_plain(q, r_op, n, parts, p1_s, p1_i)
    ki, ks = fused.banded_candidates(q, r_op, n, parts, s1, i1)
    assert torch.equal(p1_i, i1)
    assert (ki == pi).float().mean().item() >= 0.9999
    assert torch.equal(topk._lex_min(pi, ps)[0], i2)


def _topk_from(cand, q, r, n, kk):
    ci, cs = cand
    return topk._finalize_topk(q, r, ci, cs, kk, n)


def _twice(kernel, *args):
    """Two launches of a top-K kernel on the same inputs: identical
    outputs (the order in which a list's queue filled cannot show)."""
    a, b = kernel(*args), kernel(*args)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    return a


def _check_lists(ci, cs, n, parts, kk, seed=None):
    """The list contract on the card: each real column lies in its list
    (topk.list_of), each list ascends lexicographically, the slots left
    over hold (+inf, I32_MAX) or (seed[row], I32_MAX)."""
    m = ci.shape[0]
    li, ls = ci.view(m, parts, kk).long(), cs.view(m, parts, kk)
    real = li < n
    lists = torch.arange(parts, device=ci.device).view(1, parts, 1).expand_as(li)
    assert (topk.list_of(li, n, parts)[real] == lists[real]).all()
    key = topk._lex_key(ls, li.int())
    assert (key[..., 1:] >= key[..., :-1]).all()
    assert (li[~real] == 2**31 - 1).all()
    fill = torch.full_like(ls, torch.inf) if seed is None else seed.view(m, 1, 1).expand_as(ls)
    assert (ls[~real] == fill[~real]).all()
    return real.view(m, -1)


@pytest.mark.parametrize("k,m,n,kk,parts", [
    (16, 8, 70_000, 32, 5), (5, 24, 3000, 8, 3), (3, 3, 1000, 1, 1),
    (16, 13, 20_000, 16, 9), (40, 6, 5000, 4, 2),
    # m at and past the tiled kernel's 8*TM rows, K = 4; k at 1, 3, 40, 768
    (16, 1, 9000, 4, None), (16, 8, 9000, 4, None), (16, 64, 9000, 4, None),
    (16, 65, 9000, 4, None), (1, 9, 4097, 8, None), (3, 33, 4097, 8, None),
    (40, 17, 3000, 16, None), (768, 10, 3000, 32, None),
])
def test_b5_matches_plain_and_the_passes_engine(device, k, m, n, kk, parts):
    q, r, r_op = _dup_inputs(device, m, k, n, seed=k * kk + m)
    parts = parts or topk.sweep_parts(m, k, n)
    before = topk.sweep_candidates.launches
    cand = _twice(topk.sweep_candidates, q, r_op, n, parts, kk)
    assert topk.sweep_candidates.launches == before + 2
    assert cand[0].shape == (m, parts * kk)
    _check_lists(*cand, n, parts, kk)
    got = _topk_from(cand, q, r, n, kk)
    want = _topk_from(topk.sweep_candidates_plain(q, r_op, n, parts, kk), q, r, n, kk)
    assert torch.equal(got[0], want[0])
    passes = topk._build_topk(m, n, k, kk, r_op.shape[1], "passes")(q, (r_op,), r)
    assert torch.equal(got[0], passes[0]) and torch.equal(got[1], passes[1])
    if kk >= 2:
        assert got[0][0, :2].tolist() == [127, 128]


def test_b5_through_the_sweep_engine_at_m_1024(device):
    """topk_knn(method="sweep") at m = 1024 (16 row tiles of 64) takes B5
    once, at topk_knn's tier (packed3 at k = 16: B5's tier instance), and
    answers as the passes engine does, bit for bit."""
    q, r, r_op = _dup_inputs(device, 1024, 16, 50_000, seed=7)
    before = tiers.TIER_LAUNCHES["B5 packed3"]
    got = topk.topk_knn(q, r, 4, method="sweep")
    assert tiers.TIER_LAUNCHES["B5 packed3"] == before + 1
    passes = topk.topk_knn(q, r, 4, method="passes")
    assert torch.equal(got[0], passes[0]) and torch.equal(got[1], passes[1])


def _b6_case(device, k, m, n, kk, parts, seed):
    q, r, r_op = _dup_inputs(device, m, k, n, seed=seed)

    def bound_of(b2):   # each version is seeded from its own B2 pass
        _, cs1 = b2(q, r_op, n, smallm.default_parts(n))
        return torch.topk(cs1, kk, dim=-1, largest=False).values[:, -1].contiguous()

    bound = bound_of(smallm.smallm_candidates)
    before = topk.smallm_topk_candidates.launches
    ci, cs = _twice(topk.smallm_topk_candidates, q, r_op, n, parts, kk, bound)
    assert topk.smallm_topk_candidates.launches == before + 2
    assert ci.shape == (m, parts * kk)
    real = _check_lists(ci, cs, n, parts, kk, seed=bound)
    assert ((cs <= bound[:, None]) | ~real).all()
    assert (real.sum(dim=1) >= kk).all()       # the bound holds K real entries a row
    got = topk._finalize_topk(q, r, ci, cs, kk, n)
    want = _topk_from(topk.smallm_topk_candidates_plain(
        q, r_op, n, parts, kk, bound_of(smallm.smallm_candidates_plain)), q, r, n, kk)
    assert torch.equal(got[0], want[0])
    if kk >= 2:
        assert got[0][0, :2].tolist() == [127, 128]


@pytest.mark.parametrize("k,m,n,kk,parts", [
    (16, 4, 70_000, 16, 9), (8, 1, 3000, 32, 3), (32, 4, 5000, 32, 2),
    (3, 2, 777, 1, 1), (16, 3, 20_000, 8, 40), (16, 4, 70_000, 16, None),
])
def test_b6_matches_plain(device, k, m, n, kk, parts):
    _b6_case(device, k, m, n, kk, parts or topk.smallm_topk_parts(n, k), seed=k + kk + m)


@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_b6_over_k_and_kk(device, m):
    """B6 over k = 1..32 (each KMAX instance, its edges) and K = 1..32 at
    each m: every row ends with at least K real entries and the plain
    version's top-K."""
    for k in (1, 7, 8, 9, 16, 17, 31, 32):
        for kk in (1, 2, 5, 16, 31, 32):
            _b6_case(device, k, m, 6000, kk, topk.smallm_topk_parts(6000, k), seed=k * 37 + kk)


# ---- the seeded engine's kernels: B3, B7 and the B8/B9 compactor ----------


def _plain_scores(q, r_op, n):
    return torch.cat([s for _, s in fused.score_chunks(q, r_op, n)], dim=1)


def _bound_between(s, lo_rank, hi_rank):
    """Per row, the midpoint of the widest gap between consecutive sorted
    scores of ranks lo_rank..hi_rank: no score lies near it, so the
    kernel's and the plain version's last-bit differences cannot move an
    element across it."""
    srt = torch.sort(s, dim=1).values[:, :hi_rank + 1]
    j = (srt[:, lo_rank + 1:] - srt[:, lo_rank:-1]).argmax(dim=1, keepdim=True) + lo_rank
    return ((srt.gather(1, j) + srt.gather(1, j + 1)) / 2).squeeze(1).contiguous()


def _misaligned(r_op, offset):
    """A contiguous copy of r_op starting `offset` floats into its storage
    (a base that is not 16-byte aligned: the tiled kernels' 4-byte
    copies)."""
    flat = torch.zeros(r_op.numel() + offset, dtype=r_op.dtype, device=r_op.device)
    out = flat[offset:].view(r_op.shape)
    out.copy_(r_op)
    return out


def _check_b3(q, r_op, n, depth, banded, n_limit):
    """B3 against its plain version (and, unbanded, bit-equal to B1's lane
    minima over the same prefix), the same with q's transposed copy passed
    in as the seeded engine passes it."""
    m, k = q.shape
    lo = _bound_between(_plain_scores(q, r_op, n), 3, 40) if banded else None
    before = fused.minima_candidates.launches
    got = fused.minima_candidates(q, r_op, n, depth=depth, lo=lo, n_limit=n_limit)
    again = fused.minima_candidates(q, r_op, n, depth=depth, lo=lo, n_limit=n_limit,
                                    q_t=fused.transposed_queries(q))
    torch.cuda.synchronize()
    assert fused.minima_candidates.launches == before + 2
    assert torch.equal(again, got)
    want = fused.minima_candidates_plain(q, r_op, n, depth, lo, n_limit)
    assert got.shape == want.shape == (m, 128 * depth)
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got))
    scale = want[fin].abs().max()
    assert ((got - want)[fin].abs() <= max(1e-5, 4 * k * 2.0 ** -24) * scale).all()
    if not banded:
        n_eff = n if n_limit is None else min(n, n_limit)
        _, b1 = fused.fused_candidates(q, r_op, n_eff, 1)
        assert torch.equal(got[:, :128], b1)


@pytest.mark.parametrize("k,m,n,depth,banded,n_limit", [
    (16, 100, 70_000, 1, False, None), (16, 100, 70_000, 2, False, None),
    (5, 40, 3001, 1, True, None), (16, 9, 70_000, 1, False, 32_768),
    (7, 33, 20_000, 2, True, 10_000), (40, 3, 5000, 2, False, None),
])
def test_b3_matches_plain_and_b1(device, k, m, n, depth, banded, n_limit):
    q, _, r_op = _inputs(device, m, k, n, seed=k + m + depth)
    _check_b3(q, r_op, n, depth, banded, n_limit)


# B3 and B7 (the tiled template with epilogues of their own) at its edges:
# m past a block's 8 * TM rows, n ragged against 256 and 128, an operand
# wider than n, k ragged against the 16-row chunk, k = 1 and 768, ld not a
# multiple of 4 (B3) or an operand base that is not 16-byte aligned (B7,
# whose ld is a multiple of its cell), cells of 64, 128 and 256 in the
# quadratic and cubic modes.
B3_EDGES = [  # k, m, n, ld, depth, banded, n_limit
    (1, 65, 3149, 3200, 1, False, None), (17, 9, 1000, 1001, 2, True, None),
    (40, 33, 9077, 9077, 1, False, 5000), (16, 70, 2049, 2051, 2, False, None),
    (768, 70, 5077, 5077, 1, True, None), (3, 5, 777, 779, 2, False, None),
]
B7_EDGES = [  # k, m, n, n_ops, cell, fields, banded, operand offset
    (1, 65, 3149, 3200, 64, 4, False, 0), (17, 9, 1000, 1280, 128, 8, True, 1),
    (40, 33, 9077, 9216, 256, 4, False, 0), (16, 70, 2049, 2304, 256, 8, True, 0),
    (768, 70, 5077, 5120, 64, 8, False, 0), (16, 3, 20_000, 32_768, 128, 4, False, 3),
    (5, 40, 3000, 3072, 64, 4, True, 2),
]


@pytest.mark.parametrize("k,m,n,ld,depth,banded,n_limit", B3_EDGES)
def test_b3_matches_plain_and_b1_at_tile_edges(device, k, m, n, ld, depth, banded, n_limit):
    q, r, _ = _inputs(device, m, k, n, seed=k + 5 * m)
    _check_b3(q, prep_soa(r, ld), n, depth, banded, n_limit)


def _check_b7(q, r_op, n, cell, nf, banded):
    """B7's packed words identical to its plain version's (bounds set
    between scores), the remainder minima within 1e-5, the same with q's
    transposed copy passed in."""
    m = q.shape[0]
    s = _plain_scores(q, r_op, n)
    bound = _bound_between(s, 60, 200)
    lo = _bound_between(s, 5, 40) if banded else None
    before = seeded.extract_moments.launches
    got = seeded.extract_moments(q, r_op, n, bound, cell, nf, lo=lo, emit_rem=banded)
    again = seeded.extract_moments(q, r_op, n, bound, cell, nf, lo=lo, emit_rem=banded,
                                   q_t=fused.transposed_queries(q))
    torch.cuda.synchronize()
    assert seeded.extract_moments.launches == before + 2
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    want = seeded.extract_moments_plain(q, r_op, n, bound, cell, nf, lo, banded)
    assert len(got) == len(want)
    for g, w in zip(got[:1 + (nf == 8)], want):
        assert g.shape == (m, r_op.shape[1] // cell) and torch.equal(g, w)
    assert bool((got[0] != 0).any())
    if banded:
        fin = torch.isfinite(want[-1])
        assert torch.equal(fin, torch.isfinite(got[-1]))
        scale = want[-1][fin].abs().max()
        assert ((got[-1] - want[-1])[fin].abs() <= 1e-5 * scale).all()


@pytest.mark.parametrize("k,m,n,n_ops,cell,nf,banded", [
    (16, 100, 70_000, 70_144, 256, 4, False), (16, 100, 70_000, 70_016, 128, 8, False),
    (7, 40, 20_000, 32_768, 64, 8, True), (5, 9, 3000, 3072, 256, 8, True),
    (16, 33, 50_000, 50_048, 64, 4, False),
])
def test_b7_packed_words_equal_plain(device, k, m, n, n_ops, cell, nf, banded):
    q, r, _ = _inputs(device, m, k, n, seed=n + cell + nf)
    _check_b7(q, prep_soa(r, n_ops), n, cell, nf, banded)


@pytest.mark.parametrize("k,m,n,n_ops,cell,nf,banded,offset", B7_EDGES)
def test_b7_packed_words_equal_plain_at_tile_edges(device, k, m, n, n_ops, cell, nf, banded,
                                                   offset):
    q, r, _ = _inputs(device, m, k, n, seed=k + 7 * m)
    r_op = prep_soa(r, n_ops)
    _check_b7(q, _misaligned(r_op, offset) if offset else r_op, n, cell, nf, banded)


def test_b3_and_b7_raise_on_a_malformed_q_t(device):
    q, _, r_op = _inputs(device, 10, 16, 3000, seed=3)
    bound = torch.zeros((10,), device=device)
    q_t = fused.transposed_queries(q)
    for bad in (q_t[:, :8].contiguous(), q_t.double(), q.T.contiguous(), q_t.cpu(),
                torch.zeros((17, 12), device=device)):
        with pytest.raises(ValueError, match="q_t"):
            fused.minima_candidates(q, r_op, 3000, q_t=bad)
        with pytest.raises(ValueError, match="q_t"):
            seeded.extract_moments(q, r_op, 3000, bound, 128, 4, q_t=bad)


def _fields(device, m, nc, nf, density, seed):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    qual = torch.rand((m, nc), generator=gen, device=device) < density
    f0 = torch.randint(1, 1 << 30, (m, nc), generator=gen, device=device, dtype=torch.int32)
    out = [torch.where(qual, f0, 0)]
    if nf == 2:
        f1 = torch.randint(0, 1 << 30, (m, nc), generator=gen, device=device,
                           dtype=torch.int32)
        out.append(torch.where(qual, f1, 0))
    return out


@pytest.mark.parametrize("m,nc,parts,cap,nf,density", [
    (16, 512, 1, 8, 1, 0.02), (16, 512, 1, 8, 2, 0.08), (12, 1024, 4, 8, 2, 0.02),
    (8, 8192, 1, 48, 2, 0.004), (4, 16_384, 1, 16, 2, 0.001),
    (100, 32_768, 8, 192, 2, 0.01), (33, 40_000, 2, 80, 1, 0.003), (16, 512, 1, 8, 2, 0.0),
    # Dense rows: every cell qualifies, so the walk stops after its first
    # round; cap == part width, dense and sparse; nc % 4 != 0 (the
    # cell-by-cell loads); parts narrower than one 256-thread round (a
    # block packs 2, 4 or 8 of them: widths 100, 512, 1000, 2000).
    (16, 4096, 1, 48, 2, 1.0), (3, 40_000, 2, 20_000, 2, 1.0), (8, 2048, 2, 1024, 2, 0.5),
    (12, 4098, 2, 80, 2, 0.01), (5, 4098, 2, 2049, 1, 1.0), (24, 800, 8, 12, 1, 0.05),
    (40, 4096, 8, 16, 2, 0.02), (30, 3000, 3, 40, 2, 0.03), (20, 6000, 3, 2000, 2, 0.3),
    # Tasks enough for more than one wave of blocks: fewer warps a task,
    # several rounds each (the seeded K = 64 fields' shape, and 3000 rows).
    (1024, 8192, 4, 48, 2, 0.01), (3000, 4096, 1, 48, 1, 0.004),
])
def test_compactor_matches_plain(device, m, nc, parts, cap, nf, density):
    """Part widths on both sides of 8192 (tpu_knn's two Pallas bodies) and
    on both sides of one round of the kernel's groups, twice each."""
    fields = _fields(device, m, nc, nf, density, seed=m + nc + cap)
    want = seeded.compact_cells_plain(fields, parts, cap)
    for _ in range(2):
        before = seeded.compact_cells.launches
        got = seeded.compact_cells(fields, parts, cap)
        torch.cuda.synchronize()
        assert seeded.compact_cells.launches == before + 1
        assert len(got) == nf + 1
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("nc,parts", [(4096, 1), (8192, 4), (3000, 3)])
def test_compactor_reads_a_misaligned_field_cell_by_cell(device, nc, parts):
    """Fields whose base is not 16-byte aligned take the kernel's
    cell-by-cell loads; the outputs are the plain version's."""
    m, cap = 9, 40
    fields = [_misaligned(f, 1) for f in _fields(device, m, nc, 2, 0.02, seed=nc + parts)]
    assert fields[0].data_ptr() % 16
    got = seeded.compact_cells(fields, parts, cap)
    for g, w in zip(got, seeded.compact_cells_plain(fields, parts, cap)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("m,k,n,kk", [(64, 16, 70_000, 8), (40, 7, 40_000, 32),
                                      (16, 8, 1 << 16, 128), (24, 8, 1 << 16, 200)])
def test_seeded_engine_matches_an_exact_scan(device, m, k, n, kk):
    """The seeded engine selects by exact d2, so it agrees with an exact
    diff-form scan; a rank may differ only between two points whose d2
    agree to f32 rounding."""
    q, r, _ = _inputs(device, m, k, n, seed=m * kk)
    # topk_knn's tier at k <= 16 is packed3: B3's and B7's tier instances.
    counts = [tiers.TIER_LAUNCHES["B3 packed3"], tiers.TIER_LAUNCHES["B7 packed3"],
              seeded.compact_cells.launches]
    si, sd = topk.topk_knn(q, r, kk, method="seeded")
    torch.cuda.synchronize()
    assert tiers.TIER_LAUNCHES["B3 packed3"] > counts[0]
    assert tiers.TIER_LAUNCHES["B7 packed3"] > counts[1]
    assert seeded.compact_cells.launches > counts[2]
    d2 = ((q[:, None, :] - r[None, :, :]) ** 2).sum(dim=-1)
    wd, wi = torch.sort(d2, dim=1, stable=True)    # (d2, index) lex order
    wd, wi = wd[:, :kk], wi[:, :kk].to(torch.int32)
    torch.testing.assert_close(sd, wd, rtol=1e-6, atol=1e-7)
    bad = si != wi
    assert ((sd - wd).abs()[bad] <= 1e-6 * wd.abs().max()).all()


# ---- the 1-NN ladder's kernels: B1's variants (v3, v6), B10 (v5), B11 (v11)


# (k, m, n, P): B1's variants at k not a multiple of 4 (their 4-byte
# copies), m = 1, n ragged against 128 and a column tile, P = 1 and
# tiled_parts; v6 at its guard's extremes (m = 2 by k = 7000, 64 by 256,
# 1 by 16384); v3 (no guard) alone past k*m = 16384.
B1_VARIANT_CASES = [
    (3, 40, 1000, 1), (16, 100, 70_000, 7), (5, 1, 3000, 3), (16, 1024, 1 << 16, None),
    (40, 9, 5000, 4), (3, 300, 4099, None), (7, 33, 9077, None), (17, 1, 70_001, None),
    (5, 65, 20_000 + 77, 3), (500, 2, 3001, 2), (380, 2, 3000, 2),
    (7000, 2, 300, 2), (256, 64, 20_000 + 77, None), (16384, 1, 2000, 1),
    (2048, 8, 4096, None), (768, 100, 5077, None),
]


@pytest.mark.parametrize("k,m,n,parts", B1_VARIANT_CASES)
def test_b1_variants_are_bit_equal_to_b1(device, k, m, n, parts):
    """The AoS (v3) and resident-query (v6) variants, where their guards
    admit the shape, are B1's tiled kernel under the template's other
    operand policies: identical candidates at the same partition count."""
    q, r, r_op = _inputs(device, m, k, n, seed=3 * k + m)
    parts = parts or fused.tiled_parts(m, k, n)
    want = fused.fused_candidates(q, r_op, n, parts)
    variants = [(fused.aos_candidates, r)]
    if fused.const_query_fits(m, k):
        variants.append((fused.const_query_candidates, r_op))
    for wrapper, operand in variants:
        before = wrapper.launches
        got = wrapper(q, operand, n, parts)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_constant_query_launches_on_two_streams_do_not_overwrite_each_other(device):
    """Two query sets swept on two streams, issued back to back with no
    synchronisation between them, give each stream its own answer: v6's
    queries live in each block's shared memory (once they sat in one
    constant bank per library, which a launch on another stream could
    refill mid-sweep)."""
    k, n = 16, 1 << 22
    q1, r, r_op = _inputs(device, 1024, k, n, seed=31)
    q2 = torch.rand_like(q1)
    parts = fused.tiled_parts(1024, k, n)
    want1 = fused.fused_candidates(q1, r_op, n, parts)
    want2 = fused.fused_candidates(q2, r_op, n, parts)
    torch.cuda.synchronize()
    s1, s2 = torch.cuda.Stream(device), torch.cuda.Stream(device)
    for _ in range(3):
        with torch.cuda.stream(s1):
            got1 = fused.const_query_candidates(q1, r_op, n, parts)
        with torch.cuda.stream(s2):
            got2 = fused.const_query_candidates(q2, r_op, n, parts)
        torch.cuda.synchronize()
        assert torch.equal(got1[0], want1[0]) and torch.equal(got1[1], want1[1])
        assert torch.equal(got2[0], want2[0]) and torch.equal(got2[1], want2[1])


@pytest.mark.parametrize("k,m,n,parts", [
    (3, 8, 1000, 1), (16, 1, 70_001, None), (16, 1000, 1 << 16, None), (5, 33, 3000, 3),
    (100, 9, 5000, 4), (3, 1, (1 << 16) + 77, None), (196, 2, 3000, 2),
    # The TMA ring's edges: k = 1, k ragged against the 16-row chunk, wide
    # k (768, 7000: past the lane-per-thread kernel's old guard), m past a
    # block's rows at each TM (8 * TM = 8, 32, 64), n ragged against 128
    # and 256 (a column tile's quarter).
    (1, 65, 3149, None), (17, 9, 1000, None), (768, 100, 5077, None), (7000, 3, 300, 2),
    (16, 1000, (1 << 16) + 77, None), (5, 33, 4099, 3), (40, 70, 20_000 + 77, None),
    (16, 129, (1 << 16) + 128, None),
])
def test_b10_indices_equal_b1s(device, k, m, n, parts):
    """B10 is B1's tiled kernel under the TMA policy: at the same P its
    indices are B1's, in two launches (a wrong barrier phase shows as rare
    wrong candidates, not as a fault)."""
    q, r, r_op = _inputs(device, m, k, n, seed=k * m + 5)
    parts = parts or fused.tiled_parts(m, k, n)
    want = fused.fused_candidates(q, r_op, n, parts)[0]
    for _ in range(2):
        before = dma_pipeline.dma_candidates.launches
        got = dma_pipeline.dma_candidates(q, r_op, n, parts)
        torch.cuda.synchronize()
        assert dma_pipeline.dma_candidates.launches == before + 1
        assert got.shape == (m, parts * 128)
        assert torch.equal(got, want)
    plain = dma_pipeline.dma_candidates_plain(q, r_op, n, parts)
    assert (got == plain).float().mean().item() >= 0.9999
    assert int(_refine(q, r, got, n)[0][0]) == n // 2


def test_b10_raises_on_an_operand_its_tensor_map_cannot_take(device):
    """The operand's tensor map needs a row stride that is a multiple of 128
    floats and a 16-byte aligned base; the wrapper raises, nothing falls
    back."""
    q, r, r_op = _inputs(device, 8, 5, 1000, seed=3)
    with pytest.raises(ValueError, match="multiple of 128"):
        dma_pipeline.dma_candidates(q, prep_soa(r, 1000), 1000, 2)
    with pytest.raises(ValueError, match="16-byte aligned"):
        dma_pipeline.dma_candidates(q, _misaligned(r_op, 1), 1000, 2)
    launches = dma_pipeline.dma_candidates.launches
    assert torch.equal(dma_pipeline.dma_candidates(q, r_op, 1000, 2),
                       fused.fused_candidates(q, r_op, 1000, 2)[0])
    assert dma_pipeline.dma_candidates.launches == launches + 1


@pytest.mark.parametrize("k,m,n,window", [
    (3, 16, 50_000, 4096), (3, 1, 20_000, 8192), (8, 64, 70_000, 20_480), (4, 7, 9000, 9000),
    (16, 5, 30_000, 4096), (40, 3, 30_000, 4096),   # several chunks of loads per column
])
def test_b11_matches_plain(device, k, m, n, window):
    gen = torch.Generator(device=device)
    gen.manual_seed(n + m)
    r = torch.rand((n, k), generator=gen, device=device)
    q = torch.rand((m, k), generator=gen, device=device)
    r[n // 2] = r[n // 2 + 1] = q[0]                 # exact duplicates in a window
    index = projection.build_projection_index(r)
    ref_sorted, order, axis, proj = index[:4]
    w_tiles = projection.window_tiles(n, window)
    pos = torch.searchsorted(proj, projection._axis_column(q, axis))
    start = (pos - min(window, n) // 2).clamp(0, max(n - min(window, n), 0))
    tiles = (start // projection.TILE_W).to(torch.int32)
    for splits in (1, projection.window_splits(m, w_tiles)):
        before = projection.window_candidates.launches
        got = projection.window_candidates(q, index[6], tiles, w_tiles, splits)
        torch.cuda.synchronize()
        assert projection.window_candidates.launches == before + 1
        want = projection.window_candidates_plain(q, index[6], tiles, w_tiles, splits)
        assert got.shape == want.shape == (m, splits * 128)
        assert (got == want).float().mean().item() >= 0.999
        gi, gd = fused._exact_rerank(q, ref_sorted, got, n, tie_src=order)
        wi, wd = fused._exact_rerank(q, ref_sorted, want, n, tie_src=order)
        assert torch.equal(gi, wi) and torch.equal(gd, wd)
        assert int(gi[0]) == n // 2 and float(gd[0]) == 0.0


@pytest.mark.parametrize("version", ["v1", "v2", "v3", "v5", "v6", "v9", "v10", "v11"])
def test_ladder_versions_are_exact_on_the_card(device, version):
    import tpu_knn_torch

    k, m, n = 3, 64, 70_000
    q, r, _ = _inputs(device, m, k, n, seed=17)
    got = torch.as_tensor(tpu_knn_torch.knn_callback(k, m, n, q, r, version=version),
                          device=device).long()
    d2 = ((q[:, None, :] - r[None, :, :]) ** 2).sum(dim=-1)
    best = d2.min(dim=1).values
    assert (d2.gather(1, got[:, None]).squeeze(1) - best).abs().max().item() <= 1e-6
    assert int(got[0]) == n // 2


# ---- the tensor-core tiers (B1) and B12, and B2 over a bf16 operand ----------


@pytest.mark.parametrize("precision,k,m,n,parts,bf16", [
    ("packed", 3, 40, 1000, 1, False),        # packed3, 9 terms
    ("packed", 16, 100, 70_000, 7, False),    # packed3, 8 terms
    ("packed", 24, 9, 5000, 4, False),        # packed2, 16-row chunks
    ("packed", 32, 64, 20_000, None, False),
    ("bf16x3", 40, 33, 5000, 3, False),
    ("bf16x3", 128, 70, 20_000, None, False),  # the split q resident
    ("bf16x3", 768, 64, 3000, 2, False),      # q walked in chunks beside r
    ("bf16x4", 16, 20, 3000, 2, False),
    ("qsplit2", 128, 64, 20_000, None, True),
    ("qsplit2", 768, 80, 5000, 3, True),
    ("packed", 16, 100, 20_000, None, True),  # a bf16 store's packed tier
    ("packed", 32, 10, 3000, 1, True),
    ("default", 16, 50, 5000, 2, False),
    ("bf16_raw", 40, 10, 3000, 1, True),
])
def test_tensor_tiers_match_plain(device, precision, k, m, n, parts, bf16):
    """Each tier's kernel against its plain version: slot agreement, the
    kernel's score error against an f64 recomputation within the tier's
    gate (tiers.tier_error_gate, with the plain version's error as the
    reference arithmetic's), and (for the certified tiers) the same refined
    1-NN, the planted duplicate resolving to the lower column."""
    q, r, r_op = _inputs(device, m, k, n, seed=k * m + n)
    if bf16:
        r = r.to(torch.bfloat16).float()        # the stored points
        r_op = r_op.to(torch.bfloat16)
    parts = parts or tiers.tensor_parts(m, n)
    tier = tiers.resolved_tier(precision, k)
    before = dict(tiers.TIER_LAUNCHES)
    ki, ks = tiers.tensor_candidates(q, r_op, n, parts, precision)
    torch.cuda.synchronize()
    assert tiers.TIER_LAUNCHES == {**before, tier: before.get(tier, 0) + 1}
    pi, ps = tiers.tensor_candidates_plain(q, r_op, n, parts, precision)
    assert (ki == pi).float().mean().item() >= 0.999
    plain_err = tiers.score_errors(q, r, pi, ps)[0]
    assert tiers.score_errors(q, r, ki, ks)[0] <= tiers.tier_error_gate(precision, k, plain_err)
    if precision not in ("default", "bf16_raw"):
        cutoff = select_cutoff(precision, k)
        got = _refine(q, r, (ki, ks), n, cutoff=cutoff)[0]
        assert torch.equal(got, _refine(q, r, (pi, ps), n, cutoff=cutoff)[0])
        assert int(got[0]) == n // 2


@pytest.mark.parametrize("k,m,n,parts", [
    (16, 100, 70_000, 7), (3, 40, 1000, 1), (40, 9, 5000, None), (128, 64, 20_000, None),
])
def test_b12_matches_plain(device, k, m, n, parts):
    q, r, _ = _inputs(device, m, k, n, seed=5 * k + m)
    hi, lo, rn = tiers.presplit_ops(r, -(-n // 128) * 128 + 128)
    parts = parts or tiers.tensor_parts(m, n)
    before = tiers.TIER_LAUNCHES["bf16x3_presplit"]
    ki, ks = tiers.presplit_candidates(q, hi, lo, rn, n, parts)
    torch.cuda.synchronize()
    assert tiers.TIER_LAUNCHES["bf16x3_presplit"] == before + 1
    pi, ps = tiers.presplit_candidates_plain(q, hi, lo, rn, n, parts)
    assert (ki == pi).float().mean().item() >= 0.999
    plain_err = tiers.score_errors(q, r, pi, ps)[0]
    assert tiers.score_errors(q, r, ki, ks)[0] <= tiers.tier_error_gate("bf16x3_presplit", k,
                                                                         plain_err)
    cutoff = select_cutoff("bf16x3_presplit", k)
    got = _refine(q, r, (ki, ks), n, cutoff=cutoff)[0]
    assert torch.equal(got, _refine(q, r, (pi, ps), n, cutoff=cutoff)[0])
    assert int(got[0]) == n // 2


@pytest.mark.parametrize("precision,kind,k,m,n,parts", [
    ("packed", "f32", 16, 63, 5003, 3),        # one row below the 64-row tile
    ("packed", "f32", 16, 65, 5003, 3),        # one above; n ragged in a 16-byte unit
    ("packed", "f32", 3, 65, 2051, 4),         # 9 terms
    ("bf16x3", "f32", 40, 65, 3001, 2),        # k16 = 48: 16-row chunks
    ("bf16x4", "f32", 32, 1, 777, 2),          # one row, 32-row chunks
    ("qsplit2", "bf16", 40, 63, 3003, 2),      # a bf16 operand, ragged in its 8-value unit
    ("packed", "bf16", 16, 65, 1030, 3),
    ("bf16x3_presplit", "presplit", 40, 65, 5003, 3),
    ("bf16x3", "f32", 768, 65, 1001, 2),       # the q parts ride in the ring
    ("qsplit2", "bf16", 768, 63, 1003, 1),
    ("bf16x3_presplit", "presplit", 768, 64, 999, 1),
])
def test_tensor_kernel_matches_plain_at_tile_edges(device, precision, kind, k, m, n, parts):
    """The tensor-core kernel at its tile's edges (64-row tiles, column
    tiles of 4 groups x a 32-lane slice, 16- or 32-row chunks, the q parts
    resident or in the ring), in each operand mode, against its plain
    version: slot agreement, the score error within the tier's gate, the
    same refined 1-NN; and query 0's point planted at columns 5, 5 + 128
    (the same lane, the next group of the column tile) and 5 + 640 (the
    same lane, the next column tile), which its lane must resolve to 5."""
    q, r, r_op = _inputs(device, m, k, n, seed=3 * k + m + n)
    r[5] = r[5 + 128] = r[5 + 640] = q[0]
    if kind == "bf16":
        r = r.to(torch.bfloat16).float()
    n_pad = -(-n // 128) * 128 + 128
    if kind == "presplit":
        ops = tiers.presplit_ops(r, n_pad)
    else:
        ops = (prep_soa(r, n_pad).to(torch.bfloat16 if kind == "bf16" else torch.float32),)
    tier = "bf16x3_presplit" if kind == "presplit" else tiers.resolved_tier(precision, k)
    before = dict(tiers.TIER_LAUNCHES)
    ki, ks = tiers.tier_candidates(q, ops, n, parts, precision)
    torch.cuda.synchronize()
    assert tiers.TIER_LAUNCHES == {**before, tier: before.get(tier, 0) + 1}
    pi, ps = tiers.tier_candidates_plain(q, ops, n, parts, precision)
    assert ki.shape == ks.shape == (m, parts * 128)
    assert (ki == pi).float().mean().item() >= 0.999
    plain_err = tiers.score_errors(q, r, pi, ps)[0]
    assert tiers.score_errors(q, r, ki, ks)[0] <= tiers.tier_error_gate(precision, k, plain_err)
    assert int(ki[0, 5]) == 5 and int(pi[0, 5]) == 5
    cutoff = select_cutoff(precision, k)
    got = _refine(q, r, (ki, ks), n, cutoff=cutoff)[0]
    assert torch.equal(got, _refine(q, r, (pi, ps), n, cutoff=cutoff)[0])
    assert int(got[0]) == 5


def _fma32(a, b, c):
    """fmaf(a, b, c) of f32 tensors, correctly rounded, in f64: the product
    is exact, the sum is rounded to odd (TwoSum's error nudges an even
    result one ulp towards it), and 53 >= 24 + 2 bits make the final
    rounding to f32 the single rounding of fmaf."""
    a, b, c = a.double(), b.double(), c.double()
    p = a * b
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    nudge = torch.isfinite(s) & (e != 0) & even
    s = torch.where(nudge, torch.nextafter(s, torch.where(e > 0, torch.inf, -torch.inf)), s)
    return s.float()


def _window_candidates_exact(q, r_aug, tiles, w_tiles, splits):
    """B11's contract, bit for bit: s' = fmaf(-0.5, |r|^2, acc) after acc =
    fmaf(q[d], r[d, col], acc) for d = 0..k-1, the earliest column of each
    lane's maximum, INT32_MAX for a lane that saw only -inf."""
    m, k = q.shape
    cols = tiles.long()[:, None] * projection.TILE_W + torch.arange(
        w_tiles * projection.TILE_W, device=q.device)
    rc = r_aug[:k + 1][:, cols]
    acc = torch.zeros(cols.shape, dtype=torch.float32, device=q.device)
    for d in range(k):
        acc = _fma32(q[:, d, None].expand_as(acc), rc[d], acc)
    s = _fma32(torch.full_like(acc, -0.5), rc[k], acc)
    idx, _ = fused._lane_fold(-s, splits)
    return torch.where(idx < 2**31 - 1, idx + tiles[:, None] * projection.TILE_W, idx)


@pytest.mark.parametrize("m", [1, 7, 16, 64])
@pytest.mark.parametrize("k", [3, 8, 16, 40])
def test_b11_is_bit_equal_to_its_contract(device, k, m):
    """B11 (float4 rows, and 4-byte rows over an operand whose base is not
    16-byte aligned) against the fold it must compute, bit for bit, at one
    split, three and the default; query 0 at the corner, whose window
    starts at the last tile; each launch made twice."""
    n, window = 37_000 + 77 * k, 8192 if k < 16 else 4096
    gen = torch.Generator(device=device)
    gen.manual_seed(31 * k + m)
    r = torch.rand((n, k), generator=gen, device=device)
    q = torch.rand((m, k), generator=gen, device=device)
    q[0] = 1.0
    index = projection.build_projection_index(r)
    w_tiles = projection.window_tiles(n, window)
    pos = torch.searchsorted(index[3], projection._axis_column(q, index[2]))
    start = (pos - window // 2).clamp(0, n - window)
    tiles = (start // projection.TILE_W).to(torch.int32)
    assert int(tiles[0]) * projection.TILE_W + w_tiles * projection.TILE_W >= n
    for r_aug in (index[6], _misaligned(index[6], 1)):
        for splits in sorted({1, 3, projection.window_splits(m, w_tiles)}):
            want = _window_candidates_exact(q, r_aug, tiles, w_tiles, splits)
            got = [projection.window_candidates(q, r_aug, tiles, w_tiles, splits)
                   for _ in range(2)]
            assert torch.equal(got[0], got[1]) and torch.equal(got[0], want), splits


@pytest.mark.parametrize("k,m,n,parts", [(8, 1, 1000, 1), (16, 3, 70_000, 9),
                                         (32, 4, 5000, 2), (3, 2, 777, 3)])
def test_b2_bf16_is_bit_equal_to_b2_on_the_upcast_operand(device, k, m, n, parts):
    q, r, r_op = _inputs(device, m, k, n, seed=k * m + 1)
    r_bf = r_op.to(torch.bfloat16)
    before = tiers.TIER_LAUNCHES["B2-bf16"], smallm.smallm_candidates.launches
    got = smallm.smallm_candidates(q, r_bf, n, parts)
    want = smallm.smallm_candidates(q, r_bf.float(), n, parts)
    torch.cuda.synchronize()
    assert (tiers.TIER_LAUNCHES["B2-bf16"],
            smallm.smallm_candidates.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    plain = smallm.smallm_candidates_plain(q, r_bf, n, parts)
    assert (got[0] == plain[0]).float().mean().item() >= 0.9999


@pytest.mark.parametrize("m", [1, 2, 3, 4])
@pytest.mark.parametrize("k", [1, 8, 9, 16, 17, 32])
def test_b2_bf16_load_widths_are_bit_equal_to_b2(device, k, m):
    """B2-bf16 at every load width its launcher picks (16 bytes over an
    aligned operand; 8, 4 and 2 over an ld that is not a multiple of 8 or a
    base 1, 2 or 4 elements past alignment), n ragged against 8 and 128:
    bit-equal to B2 on the upcast operand at two partition counts, each
    launch made twice."""
    n = 20_003
    q, _, r_op = _inputs(device, m, k, n, seed=97 * k + m)
    r_bf = r_op.to(torch.bfloat16)
    operands = [r_bf] + [r_bf[:, :ld].contiguous() for ld in (n + 1, n + 3, n)]
    operands += [_misaligned(r_bf, offset) for offset in (1, 2, 4)]
    widths = {smallm.bf16_load_width(v, m) for v in operands}
    assert widths == ({8, 4, 2, 1} if m <= 2 else {4, 2, 1})
    for r_v in operands:
        want = {p: smallm.smallm_candidates(q, r_v.float(), n, p)
                for p in (7, smallm.bf16_parts(n))}
        for parts, (wi, ws) in want.items():
            for _ in range(2):
                gi, gs = smallm.smallm_candidates(q, r_v, n, parts)
                assert torch.equal(gi, wi) and torch.equal(gs, ws), (r_v.stride(), parts)


def test_tier_wrappers_raise(device):
    q = torch.rand((4, 16), device=device)
    r_op = torch.rand((16, 256), device=device)
    with pytest.raises(TypeError):
        tiers.tensor_candidates(q, r_op.double(), 200, 1, "packed")
    with pytest.raises(ValueError, match="contiguous"):
        tiers.tensor_candidates(q, torch.rand((256, 16), device=device).T, 200, 1, "packed")
    with pytest.raises(ValueError, match="term-list"):
        tiers.tensor_candidates(q, r_op, 200, 1, "highest")
    hi, lo, rn = tiers.presplit_ops(torch.rand((200, 16), device=device), 256)
    with pytest.raises(ValueError, match="presplit"):
        tiers.presplit_candidates(q, hi, lo, rn[:, :128].contiguous(), 200, 1)


# The bf16 instances of the tiled template (B1, B4, B3, B5, B7) and B6-bf16:
# each bit-equal to its f32 instance over the upcast operand, at the
# template's edges (k, m, n, ld): k = 1, ragged d-chunks, 768; m past a
# block's rows; n ragged against 128 and 256; ld not a multiple of 8 (the
# one-by-one staging) and a multiple (16-byte copies).
BF16_EDGES = [(1, 65, 3149, 3200), (17, 9, 1000, 1001), (40, 33, 9077, 9080),
              (16, 1000, 70_000, 70_144), (768, 70, 5077, 5120), (3, 5, 300, 301)]


def _bf16_pair(device, k, m, n, ld, seed, pad=(3, 130)):
    """Queries, a bf16 SoA operand of ld columns with PAD columns planted,
    and its f32 upcast."""
    q, _, r_op = _inputs(device, m, k, n, seed)
    r_bf = torch.zeros((r_op.shape[0], ld), dtype=torch.bfloat16, device=device)
    r_bf[:, :n] = r_op[:, :n]
    r_bf[:, [c for c in pad if c < n]] = torch.tensor(1e30, dtype=torch.bfloat16)
    return q, r_bf, r_bf.float()


def _bits_equal(a, b):
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b))


@pytest.mark.parametrize("k,m,n,ld", BF16_EDGES)
def test_tiled_bf16_instances_are_bit_equal_to_the_f32_instances(device, k, m, n, ld):
    q, rb, rf = _bf16_pair(device, k, m, n, ld, seed=k + m)
    parts = fused.tiled_parts(m, k, n)
    bs = torch.full((m,), 0.25 * k, device=device)
    bi = torch.full((m,), n // 2, dtype=torch.int32, device=device)
    wrappers = (fused.fused_candidates, fused.banded_candidates, fused.minima_candidates,
                topk.sweep_candidates) + ((seeded.extract_moments,) if ld % 64 == 0 else ())
    launches = [(f, f.bf16_launches) for f in wrappers]
    assert _bits_equal(fused.fused_candidates(q, rb, n, parts),
                       fused.fused_candidates(q, rf, n, parts))
    assert _bits_equal(fused.banded_candidates(q, rb, n, parts, bs, bi),
                       fused.banded_candidates(q, rf, n, parts, bs, bi))
    assert torch.equal(fused.minima_candidates(q, rb, n, 2),
                       fused.minima_candidates(q, rf, n, 2))
    for kk in (1, 8, 32):
        p = topk.sweep_parts(m, k, n)
        got = topk.sweep_candidates(q, rb, n, p, kk)
        assert _bits_equal(got, topk.sweep_candidates(q, rf, n, p, kk))
        assert not ({3, 130} & set(got[0].reshape(-1).tolist()))
    if ld % 64 == 0:
        bound, lo = torch.full((m,), 0.2 * k, device=device), torch.full((m,), 0.02 * k,
                                                                           device=device)
        for cell, nf in ((64, 4), (128, 8), (256, 8)):
            if ld % cell == 0:
                assert _bits_equal(
                    seeded.extract_moments(q, rb, n, bound, cell, nf, lo=lo, emit_rem=True),
                    seeded.extract_moments(q, rf, n, bound, cell, nf, lo=lo, emit_rem=True))
    torch.cuda.synchronize()
    for f, before in launches:
        assert f.bf16_launches > before, f.__name__


@pytest.mark.parametrize("m", [1, 2, 3, 4])
@pytest.mark.parametrize("k", [1, 8, 17, 32])
def test_b6_bf16_is_bit_equal_to_b6_at_each_load_width(device, k, m):
    """B6-bf16 at every load width (an aligned operand, ld not a multiple
    of 8, a misaligned base), K = 1, 8 and 32, seeded by B2's bound: its
    lists are B6's over the upcast operand bit for bit at the same P."""
    n = 20_003
    q, _, r_op = _inputs(device, m, k, n, seed=31 * k + m)
    r_bf = r_op.to(torch.bfloat16)
    r_bf[:, 5] = torch.tensor(1e30, dtype=torch.bfloat16)
    operands = [r_bf, r_bf[:, :n + 3].contiguous(), _misaligned(r_bf, 1), _misaligned(r_bf, 2)]
    for kk in (1, 8, 32):
        _, cs = smallm.smallm_candidates(q, r_bf, n, smallm.bf16_parts(n))
        bound = torch.topk(cs, kk, dim=-1, largest=False).values[:, -1].contiguous()
        for r_v in operands:
            before = topk.smallm_topk_candidates.bf16_launches
            parts = topk.smallm_topk_operand_parts(r_v, n, k)
            got = topk.smallm_topk_candidates(q, r_v, n, parts, kk, bound)
            assert _bits_equal(got, topk.smallm_topk_candidates(q, r_v.float(), n, parts, kk,
                                                                bound))
            assert topk.smallm_topk_candidates.bf16_launches == before + 1
            assert 5 not in set(got[0].reshape(-1).tolist())


@pytest.mark.parametrize("bf16", [False, True])
def test_pad_columns_are_never_reported(device, bf16):
    """PAD_VALUE columns (1e30, or bf16(1e30) = 1.0038e30) in all k_pad rows,
    as a mutable index's empty slots hold them: every kernel on the path
    (B1 "highest" and each tier, B2 / B2-bf16, B3-B7) scores them +inf,
    never NaN, and never reports one."""
    m, k, n = 40, 16, 20_000
    q, _, r_op = _inputs(device, m, k, n, seed=7)
    pad_cols = torch.cat([torch.arange(64, device=device), torch.arange(64, n, 7, device=device)])
    r_op[:, pad_cols] = 1e30
    if bf16:
        r_op = r_op.to(torch.bfloat16)
    pads = set(pad_cols.tolist())

    def clean(idx, score=None, finite=True):
        assert not (pads & set(idx.reshape(-1).tolist()))
        if score is not None:
            assert not torch.isnan(score).any()
            assert not finite or torch.isfinite(score[idx < n]).all()

    for precision in (("highest", "packed", "qsplit2") if bf16 else
                      ("highest", "packed", "bf16x3", "bf16x4", "default")):
        clean(*tiers.tier_candidates(q, (r_op,), n, 3, precision))
    qs = q[:4]
    clean(*smallm.smallm_candidates(qs, r_op, n, 5))
    bs, bi = torch.zeros(m, device=device), torch.zeros(m, dtype=torch.int32, device=device)
    clean(*fused.banded_candidates(q, r_op, n, 3, bs, bi))
    assert not torch.isnan(fused.minima_candidates(q, r_op, n, 2)).any()
    clean(*topk.sweep_candidates(q, r_op, n, 4, 16))
    bound = torch.full((4,), float(k), device=device)
    clean(*topk.smallm_topk_candidates(qs, r_op, n, 4, 16, bound))
    # Cell 0 (columns 0..63) is all PAD: no qualifier there under a finite
    # bound, while live cells do qualify.
    a, _ = seeded.extract_moments(q, r_op, n, torch.full((m,), 0.3 * k, device=device), 64, 8)
    assert (a[:, 0] == 0).all() and (a[:, 1:] != 0).any()


@pytest.mark.parametrize("metric", ["cosine", "ip"])
def test_mutable_metric_index_adds_cuda_points(device, metric):
    """Adds of CUDA points to a mutable cosine / ip index on the card are
    transformed there, and answer as the same adds given as NumPy."""
    import numpy as np

    from tpu_knn_torch import NNIndex

    rng = np.random.default_rng(13)
    pts = rng.random((6000, 16), np.float32) + 0.1
    q = rng.random((40, 16), np.float32) + 0.1
    a = NNIndex(pts[:4000], metric=metric, mutable=True, device=device)
    b = NNIndex(pts[:4000], metric=metric, mutable=True, device=device)
    add = pts[4000:] * 0.5
    assert (a.add(torch.from_numpy(add).to(device)) == b.add(add)).all()
    torch.testing.assert_close(a.ref_dev, b.ref_dev, rtol=2e-7, atol=2e-7)
    for m in (1, 4, 40):
        for kk in (None, 8):
            ga, gb = a.query(q[:m], neighbors=kk), b.query(q[:m], neighbors=kk)
            assert torch.equal(ga[0], gb[0])
            torch.testing.assert_close(ga[1], gb[1], rtol=1e-5, atol=1e-5)
    assert a.n_live == b.n_live == 6000


# ---- v10: the KD-tree traversal ----------------------------------------------


def _tree_case(device, k, m, n, seed, grid=False):
    """Host-built tree over seeded points with exact duplicates, points on
    split planes (a coarse grid) and queries equal to a point."""
    import numpy as np

    from tpu_knn_torch.kdtree.build import build_kdtree
    from tpu_knn_torch.kdtree.traversal import DeviceKDTree

    rng = np.random.default_rng(seed)
    if grid:
        r = rng.integers(0, 8, (n, k)).astype(np.float32) * 0.125
        q = rng.integers(0, 16, (m, k)).astype(np.float32) * 0.0625
    else:
        r = rng.random((n, k), np.float32)
        q = rng.random((m, k), np.float32)
    r[n // 2] = r[n - 1] = r[5]
    q[0] = r[5]
    if m > 1:
        q[1] = r[n // 3]
    return DeviceKDTree(build_kdtree(r), device), torch.from_numpy(q).to(device)


@pytest.mark.parametrize("k,m,n,grid", [(3, 1024, 1 << 16, False), (3, 500, 20_000, True),
                                        (1, 64, 5000, True), (8, 256, 1 << 14, False),
                                        (16, 64, 1 << 12, False), (5, 33, 7, False),
                                        (3, 1, 1 << 16, False), (3, 33, 20_000, False),
                                        (4, 1024, 1 << 14, True)])
def test_v10_kernel_is_its_plain_version_bit_for_bit(device, k, m, n, grid):
    """v10's kernel over the node records DeviceKDTree built once, at its
    own lanes a query and at every group it is built for (KERNEL_LANES), equals
    traverse_plain (indices and d2 bits) at m = 1, 33 and 1024, and the
    exact scan; a launch counts once."""
    from tpu_knn_torch.kdtree.traversal import (KERNEL_LANES, _launch, kdtree_traverse,
                                                traverse_plain)

    tree, q = _tree_case(device, k, m, n, seed=k + m, grid=grid)
    args = (q, tree.ref, tree.p, tree.dim, tree.split_val)
    before = kdtree_traverse.launches
    ki, kd = tree.query(q)
    torch.cuda.synchronize()
    assert kdtree_traverse.launches == before + 1
    pi, pd = traverse_plain(*args)
    assert torch.equal(ki, pi)
    assert torch.equal(kd.view(torch.int32), pd.view(torch.int32))
    for lanes in KERNEL_LANES:
        gi, gd = _launch(q, tree.records, lanes)
        assert torch.equal(gi, pi) and torch.equal(gd.view(torch.int32), pd.view(torch.int32))
    # The exact scan in the kernel's order: a multiply and an add per d.
    d2 = sum((q[:, None, d] - tree.ref[None, :, d]) ** 2 for d in range(k))
    want = torch.where(d2 == d2.min(dim=1, keepdim=True).values,
                       torch.arange(n, device=device), n).min(dim=1).values
    assert torch.equal(ki.long(), want)


def test_v10_wrapper_raises_instead_of_falling_back(device):
    from tpu_knn_torch.kdtree.traversal import kdtree_traverse

    tree, q = _tree_case(device, 3, 8, 1000, seed=1)
    with pytest.raises(ValueError, match="must be a contiguous"):
        kdtree_traverse(q.cpu(), tree.ref, tree.p, tree.dim, tree.split_val)
    wide, qw = _tree_case(device, 17, 8, 1000, seed=2)
    with pytest.raises(ValueError, match="k <= 16"):
        kdtree_traverse(qw, wide.ref, wide.p, wide.dim, wide.split_val)


@pytest.mark.parametrize("kwargs", [{}, {"store": "bf16"}, {"store": "int8"},
                                    {"precision": "bf16x3_presplit"},
                                    {"store": "bf16", "precision": "bf16x3_presplit"},
                                    {"metric": "ip"}, {"mutable": True},
                                    {"strategy": "kdtree"}])
def test_save_load_round_trip_on_the_card(device, kwargs, tmp_path):
    """A loaded index answers bit for bit as the index that was saved
    (indices and d2), 1-NN at m = 4 and 1024 and top-K where served."""
    import numpy as np

    from tpu_knn_torch import NNIndex

    rng = np.random.default_rng(4)
    r = rng.random((1 << 16, 16), np.float32)
    q = rng.random((1024, 16), np.float32)
    ix = NNIndex(r, device=device, **kwargs)
    if ix.mutable:
        ix.remove(np.arange(0, 1 << 16, 7))
        ix.add(q[:100] * 0.5)
    ix.save(str(tmp_path / "ix"))
    lx = NNIndex.load(str(tmp_path / "ix.npz"), device=device)
    topk = ix.precision != "bf16x3_presplit"
    for m in (4, 1024):
        for kk in (None, 8) if topk else (None,):
            got, want = lx.query(q[:m], neighbors=kk), ix.query(q[:m], neighbors=kk)
            assert got[0].device == want[0].device == torch.device(device)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))


# ---- the top-K kernels' tier instances (B4, B5, B3, B7 on the tensor cores) --

#: (precision, operand kind, k, m, n): each resolvable term list over f32
#: and bf16 operands, at the instances' edges (64-row tiles: m one below and
#: one above; n ragged against 128 and 256; k16 = 16 one-chunk tiles, 48
#: (16-row chunks), 768 (the q parts in the ring)).
TOPK_TIER_CASES = [
    ("packed", "f32", 16, 65, 20_077), ("packed", "f32", 3, 63, 5003),
    ("packed", "f32", 32, 64, 3001), ("packed", "bf16", 16, 65, 20_077),
    ("bf16x3", "f32", 40, 65, 5003), ("bf16x4", "f32", 24, 33, 3001),
    ("qsplit2", "bf16", 128, 70, 9000), ("default", "f32", 16, 40, 3000),
    ("bf16x3", "f32", 768, 65, 1001), ("qsplit2", "bf16", 768, 63, 1003),
]


def _tier_inputs(device, precision, kind, k, m, n):
    q, r, r_op = _dup_inputs(device, m, k, n, seed=k * m + n)
    if kind == "bf16":
        r_op = r_op.to(torch.bfloat16)
        r = r.to(torch.bfloat16).float()
    return q, r, r_op


@pytest.mark.parametrize("precision,kind,k,m,n", TOPK_TIER_CASES)
def test_b4_and_b5_tier_instances_match_plain_and_each_other(device, precision, kind, k, m, n):
    """B4's and B5's tier instances against their plain versions (slot
    agreement, the score error against f64 within the tier's gate), each
    counted under its row in tiers.TIER_LAUNCHES; B4's K passes pick
    exactly B5's lexicographic K smallest, bit for bit (one mainloop); the
    duplicates astride lanes 127 | 128 come out lowest column first."""
    q, r, r_op = _tier_inputs(device, precision, kind, k, m, n)
    kk = 8
    p4, p5 = fused.banded_parts(precision, m, k, n), topk.sweep_parts(m, k, n, precision)
    lo_s = torch.full((m,), -torch.inf, device=device)
    lo_i = torch.full((m,), -1, dtype=torch.int32, device=device)
    row4 = tiers.topk_tier_row("B4", r_op, precision, k)
    before = tiers.TIER_LAUNCHES[row4]
    ki, ks = fused.banded_candidates(q, r_op, n, p4, lo_s, lo_i, precision=precision)
    assert tiers.TIER_LAUNCHES[row4] == before + 1
    pi, ps = fused.banded_candidates_plain(q, r_op, n, p4, lo_s, lo_i, precision)
    assert (ki == pi).float().mean().item() >= 0.999
    gate = tiers.tier_error_gate(precision, k, tiers.score_errors(q, r, pi, ps)[0])
    assert tiers.score_errors(q, r, ki, ks)[0] <= gate
    ci, cs = _twice(topk.sweep_candidates, q, r_op, n, p5, kk, precision)
    _check_lists(ci, cs, n, p5, kk)
    li, ls = topk.sweep_candidates_plain(q, r_op, n, p5, kk, precision)
    assert (ci == li).float().mean().item() >= 0.999
    picks = []
    b_s, b_i = lo_s, lo_i
    for _ in range(kk):
        b_i, b_s = topk._lex_min(*fused.banded_candidates(q, r_op, n, p4, b_s, b_i,
                                                          precision=precision))
        picks.append((b_i, b_s))
    l_s, l_i = topk._lex_smallest(cs, ci, kk)
    assert torch.equal(torch.stack([p[0] for p in picks], 1), l_i)
    assert torch.equal(torch.stack([p[1] for p in picks], 1), l_s)
    if precision != "default":
        got = topk._finalize_topk(q, r, ci, cs, kk, n)[0]
        assert got[0, :2].tolist() == [127, 128]


@pytest.mark.parametrize("precision,kind,k,m,n", TOPK_TIER_CASES)
def test_b3_and_b7_tier_instances_match_plain_and_each_other(device, precision, kind, k, m, n):
    """B3's tier instance (depth 1 over a prefix, depth 2, banded) and
    B7's (cells of 64, 128 and 256 in both field modes, with a band and
    the remainder minima) against their plain versions, the bound in a
    gap of the scores so that B7's words must be identical (but at
    "default", whose bf16 error no gap of these data clears); B7's
    remainder above a bound equals B3 banded at it, bit for bit."""
    q, r, r_op = _tier_inputs(device, precision, kind, k, m, n)
    s = fused.scores(q, r_op, n, precision)
    srt = torch.topk(s, 201, dim=1, largest=False).values
    scale = s.abs().max().item()
    tol = 2 * tiers.tier_error_gate(precision, k, 0.0) * scale
    exact_words = precision != "default"

    def in_gap(lo_rank, hi_rank):
        # The midpoint of the widest gap of ranks lo_rank..hi_rank: the two
        # arithmetics put the same columns on each side of it.
        gaps = srt[:, lo_rank + 1:hi_rank + 1] - srt[:, lo_rank:hi_rank]
        j = gaps.argmax(dim=1, keepdim=True) + lo_rank
        assert (gaps.max(dim=1).values > 2 * tol).all() or not exact_words
        return ((srt.gather(1, j) + srt.gather(1, j + 1)) / 2).squeeze(1).contiguous()

    bound, lo = in_gap(20, 200), in_gap(4, 19)
    bands = ((1, lo, None),) if exact_words else ()
    for depth, lo_d, n_limit in ((1, None, n // 2), (2, None, None), *bands):
        got = fused.minima_candidates(q, r_op, n, depth=depth, lo=lo_d, n_limit=n_limit,
                                      precision=precision)
        want = fused.minima_candidates_plain(q, r_op, n, depth, lo_d, n_limit, precision)
        fin = torch.isfinite(want)
        assert torch.equal(fin, torch.isfinite(got))
        assert ((got - want)[fin].abs() <= tol).all()
    n_ops = -(-n // 256) * 256
    r_cells = fused.prep_soa(r.to(r_op.dtype), n_ops)
    for cell, nf in ((64, 4), (128, 8), (256, 4), (256, 8)):
        for band in (False, True):
            lo_b = lo if band else None
            got = seeded.extract_moments(q, r_cells, n, bound, cell, nf, lo=lo_b,
                                         emit_rem=band, precision=precision)
            want = seeded.extract_moments_plain(q, r_cells, n, bound, cell, nf, lo_b, band,
                                                precision)
            for g, w in zip(got[:1 + (nf == 8)], want):
                assert torch.equal(g, w) or not exact_words
            if band:
                fin = torch.isfinite(want[-1])
                assert torch.equal(fin, torch.isfinite(got[-1]))
                assert ((got[-1] - want[-1])[fin].abs() <= tol).all()
    rem = seeded.extract_moments(q, r_cells, n, bound, 128, 8,
                                 lo=torch.full((m,), -torch.inf, device=device), emit_rem=True,
                                 precision=precision)[-1]
    assert torch.equal(rem, fused.minima_candidates(q, r_cells, n, lo=bound, precision=precision))


#: (precision, operand kind, k, n): the tiers B4's and B7's instances run
#: on 128-row blocks (packed3 and packed2, whose terms the tensor core sums,
#: bf16x3 and qsplit2), over f32 and bf16 operands, n ragged against 128
#: and 256 columns.
BLOCK_TIER_CASES = [("packed", "f32", 16, 5003), ("packed", "bf16", 16, 3001),
                    ("packed", "f32", 32, 3001), ("packed", "bf16", 30, 2999),
                    ("bf16x3", "f32", 40, 2177), ("qsplit2", "bf16", 128, 1153)]


@pytest.mark.parametrize("m", [1, 63, 65, 127, 129, 1023])
@pytest.mark.parametrize("precision,kind,k,n", BLOCK_TIER_CASES)
def test_b4_and_b7_tier_instances_across_the_block_rows(device, precision, kind, k, n, m):
    """B4's and B7's tier instances against their plain versions at m on
    each side of a 64- and a 128-row block: B4's candidates agree slot by
    slot and score within the tier's gate of f64; B7's words, with and
    without a band, at a bound in a gap of the scores, are the plain
    version's exactly, and its remainder above the bound is B3 banded at
    it, bit for bit (one mainloop)."""
    q, r, r_op = _tier_inputs(device, precision, kind, k, m, n)
    p4 = fused.banded_parts(precision, m, k, n)
    lo_s = torch.full((m,), -torch.inf, device=device)
    lo_i = torch.full((m,), -1, dtype=torch.int32, device=device)
    ki, ks = fused.banded_candidates(q, r_op, n, p4, lo_s, lo_i, precision=precision)
    pi, ps = fused.banded_candidates_plain(q, r_op, n, p4, lo_s, lo_i, precision)
    assert (ki == pi).float().mean().item() >= 0.999
    gate = tiers.tier_error_gate(precision, k, tiers.score_errors(q, r, pi, ps)[0])
    assert tiers.score_errors(q, r, ki, ks)[0] <= gate
    # The second pass, above each row's first pick.
    b_i, b_s = topk._lex_min(ki, ks)
    ki2, ks2 = fused.banded_candidates(q, r_op, n, p4, b_s, b_i, precision=precision)
    assert ((ks2 > b_s[:, None]) | ((ks2 == b_s[:, None]) & (ki2 > b_i[:, None]))).all()
    assert tiers.score_errors(q, r, ki2, ks2)[0] <= gate
    s = fused.scores(q, r_op, n, precision)
    srt = torch.topk(s, 201, dim=1, largest=False).values
    tol = 2 * tiers.tier_error_gate(precision, k, 0.0) * s.abs().max().item()
    gaps = srt[:, 21:] - srt[:, 20:-1]
    j = gaps.argmax(dim=1, keepdim=True) + 20
    # The rows whose widest gap the two arithmetics cannot cross: their
    # words must be identical (nearly every row at these n).
    wide = (gaps.max(dim=1).values > 2 * tol)[:, None]
    assert wide.float().mean().item() >= 0.9
    bound = ((srt.gather(1, j) + srt.gather(1, j + 1)) / 2).squeeze(1).contiguous()
    n_ops = -(-n // 256) * 256
    r_cells = fused.prep_soa(r.to(r_op.dtype), n_ops)
    for cell, nf in ((128, 8), (256, 4)):
        for band in (False, True):
            lo_b = torch.full((m,), -torch.inf, device=device) if band else None
            got = seeded.extract_moments(q, r_cells, n, bound, cell, nf, lo=lo_b, emit_rem=band,
                                         precision=precision)
            want = seeded.extract_moments_plain(q, r_cells, n, bound, cell, nf, lo_b, band,
                                                precision)
            for g, w in zip(got[:1 + (nf == 8)], want):
                assert torch.equal(torch.where(wide, g, 0), torch.where(wide, w, 0))
            if band:
                assert torch.equal(got[-1], fused.minima_candidates(q, r_cells, n, lo=bound,
                                                                    precision=precision))


#: (precision, operand kind, k, n) of B3's and B5's block-row cases: every
#: term list the instances take over each operand kind (packed3, packed2,
#: bf16x3, qsplit2), n ragged against 128 and 512 columns and, at 100,
#: below one column tile of either layout.
B3_B5_BLOCK_CASES = [("packed", "f32", 16, 100), ("packed", "bf16", 16, 5003),
                     ("packed", "f32", 32, 3001), ("packed", "bf16", 30, 777),
                     ("bf16x3", "f32", 40, 2177), ("qsplit2", "f32", 64, 1500),
                     ("qsplit2", "bf16", 128, 1153)]


@pytest.mark.parametrize("m", [1, 8, 32, 63, 65, 127, 129, 1023])
@pytest.mark.parametrize("precision,kind,k,n", B3_B5_BLOCK_CASES)
def test_b3_and_b5_tier_instances_across_the_block_rows(device, precision, kind, k, n, m):
    """B3's tier instances (depth 1 with and without lo, depth 2) and B5's
    (K = 1, 8, 32, at each block height: m <= 32 takes the 32-row blocks)
    equal their plain versions bit for bit at m on each side of a 32-, 64-
    and 128-row block. The inputs are small integers, so every tier's
    products and sums are exact and the kernel's scores are the plain
    version's: a minimum, a list and its ties (lowest column first) must
    then be identical, whatever P."""
    gen = torch.Generator(device="cpu").manual_seed(31 * k + m + n)
    q = torch.randint(0, 8, (m, k), generator=gen).float().to(device)
    r = torch.randint(0, 8, (n, k), generator=gen).float().to(device)
    r_op = prep_soa(r, -(-n // 128) * 128)
    if kind == "bf16":
        r_op = r_op.to(torch.bfloat16)
    s = fused.scores(q, r_op, n, precision)
    lo = s.median(dim=1).values - 0.5  # a band through the scores
    for depth, band in ((1, None), (1, lo), (2, None)):
        got = fused.minima_candidates(q, r_op, n, depth=depth, lo=band, precision=precision)
        want = fused.minima_candidates_plain(q, r_op, n, depth, band, precision=precision)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (depth, band is None)
    parts = topk.sweep_parts(m, k, n, precision)
    for kk in (1, 8, 32):
        gi, gs = topk.sweep_candidates(q, r_op, n, parts, kk, precision)
        wi, ws = topk.sweep_candidates_plain(q, r_op, n, parts, kk, precision)
        assert torch.equal(gi, wi) and torch.equal(gs.view(torch.int32), ws.view(torch.int32)), kk


def test_tier_instances_raise_on_the_presplit_tier_and_a_depth_2_band(device):
    q, r, r_op = _tier_inputs(device, "packed", "f32", 16, 8, 3000)
    b = torch.zeros(8, device=device)
    with pytest.raises(ValueError, match="presplit"):
        fused.banded_candidates(q, r_op, 3000, 2, b, b.int(), precision="bf16x3_presplit")
    with pytest.raises(ValueError, match="depth 1"):
        fused.minima_candidates(q, r_op, 3000, depth=2, lo=b, precision="packed")


# ---- the 1-NN ladder at a tier: v3's, v6's and B10's tensor-core instances

# (precision, k, m, n, P, misaligned): every term list the rungs take
# (packed's 9, 8 and 4 terms, bf16x3 with 16- and 32-row chunks, its q
# parts resident and in the ring, bf16x4, default), m past a 64-row block
# and m = 1, n ragged against 128 and a column tile; v3 over a (n, k) array
# at k % 4 != 0 (k = 3, 5, 6: a group's contiguous span of points) and over
# one whose base is not 16-byte aligned (its 4-byte copies), and at k = 12,
# where its AoS term list (9 terms) is not B1's (8).
LADDER_TIER_CASES = [
    ("packed", 3, 40, 1000, 1, False), ("packed", 12, 65, 3001, None, False),
    ("packed", 16, 100, 70_000, 7, False), ("packed", 16, 65, 5003, 3, True),
    ("packed", 24, 9, 5000, 4, False), ("packed", 32, 1, 20_077, None, False),
    ("bf16x3", 40, 33, 5000, 3, False), ("bf16x3", 128, 70, 20_000, None, False),
    ("bf16x3", 768, 64, 3000, 2, False), ("bf16x3_presplit", 40, 20, 3000, 2, False),
    ("bf16x4", 16, 20, 3000, 2, False), ("bf16x4", 40, 9, 3001, 1, True),
    ("default", 16, 50, 5000, 2, False), ("bf16_raw", 40, 10, 3000, 1, False),
    ("packed", 3, 33, 5003, 2, True), ("packed", 5, 20, 5003, 2, False),
    ("packed", 6, 40, 3001, 2, False),
]


@pytest.mark.parametrize("precision,k,m,n,parts,misaligned", LADDER_TIER_CASES)
def test_ladder_tier_instances_are_b1s_tier(device, precision, k, m, n, parts, misaligned):
    """B10's tier instance gives B1's tier indices bit for bit at the same
    P (twice: a wrong barrier phase shows as rare wrong candidates), v6's
    B1's (idx, score) where its guard admits the shape, and v3's B1's
    where the term lists agree; v3 also against its plain version (slot
    agreement, the score error within the tier's gate, the same refined
    1-NN, the planted duplicate resolving to the lower column). Each
    launch counts once in its row of tiers.TIER_LAUNCHES."""
    q, r, r_op = _inputs(device, m, k, n, seed=11 * k + m)
    if misaligned:
        r = _misaligned(r, 1)
    parts = parts or tiers.tensor_parts(m, n)
    want = tiers.tensor_candidates(q, r_op, n, parts, precision)

    def launched(rung, fn):
        row = tiers.ladder_tier_row(rung, precision, k)
        before = tiers.TIER_LAUNCHES[row]
        out = fn()
        torch.cuda.synchronize()
        assert tiers.TIER_LAUNCHES[row] == before + 1
        return out

    for _ in range(2):
        got = launched("v5", lambda: dma_pipeline.dma_candidates(q, r_op, n, parts, precision))
        assert got.shape == (m, parts * 128) and torch.equal(got, want[0])
    if fused.const_query_fits(m, k):
        got = launched("v6", lambda: fused.const_query_candidates(q, r_op, n, parts, precision))
        assert _bits_equal(got, want)
    ki, ks = launched("v3", lambda: fused.aos_candidates(q, r, n, parts, precision))
    if tiers.term_list(precision, k, aos=True) == tiers.term_list(precision, k):
        assert _bits_equal((ki, ks), want)
    pi, ps = fused.aos_candidates_plain(q, r, n, parts, precision)
    assert (ki == pi).float().mean().item() >= 0.999
    plain_err = tiers.score_errors(q, r, pi, ps)[0]
    assert tiers.score_errors(q, r, ki, ks)[0] <= tiers.tier_error_gate(precision, k, plain_err)
    if precision not in ("default", "bf16_raw"):
        cutoff = select_cutoff(precision, k)
        got = _refine(q, r, (ki, ks), n, cutoff=cutoff)[0]
        assert torch.equal(got, _refine(q, r, (pi, ps), n, cutoff=cutoff)[0])
        assert int(got[0]) == n // 2


@pytest.mark.parametrize("precision,k,m", [
    ("packed", 16, 1), ("packed", 16, 32), ("packed", 16, 33), ("packed", 16, 129),
    ("packed", 3, 1), ("packed", 12, 33), ("bf16x3", 768, 32), ("bf16x3", 40, 129),
])
def test_ladder_tier_block_heights_are_b1s_tier(device, precision, k, m):
    """v3's and B10's instances at each block height (32 rows, two an SM,
    at m <= 32; 128 rows above, the split a step ahead) and at their own P
    (fused.ladder_parts): B10's indices are B1's tier indices at that P bit
    for bit, and v3's (idx, score) B1's where the term lists agree, else
    its plain version's refined 1-NN; ‖r‖² is chained in the block, B1's
    norm pass's bits."""
    n = 40_003
    q, r, r_op = _inputs(device, m, k, n, seed=7 * k + m)
    parts = fused.ladder_parts("v3", precision, m, k, n)
    assert parts == fused.ladder_parts("v5", precision, m, k, n) == tiers.ladder_tier_parts(m, n)
    want = tiers.tensor_candidates(q, r_op, n, parts, precision)
    got = dma_pipeline.dma_candidates(q, r_op, n, parts, precision)
    ki, ks = fused.aos_candidates(q, r, n, parts, precision)
    torch.cuda.synchronize()
    assert torch.equal(got, want[0])
    if tiers.term_list(precision, k, aos=True) == tiers.term_list(precision, k):
        assert _bits_equal((ki, ks), want)
    cutoff = select_cutoff(precision, k)
    pi, ps = fused.aos_candidates_plain(q, r, n, parts, precision)
    assert torch.equal(_refine(q, r, (ki, ks), n, cutoff=cutoff)[0],
                       _refine(q, r, (pi, ps), n, cutoff=cutoff)[0])


@pytest.mark.parametrize("precision,k,m,n", [
    ("bf16x3", 768, 16, 5000), ("bf16x3", 256, 64, 20_077), ("bf16x3", 128, 100, 5003),
    ("bf16x4", 7000, 2, 300), ("default", 16384, 1, 2000), ("bf16x3", 80, 200, 3000),
    ("bf16x3", 768, 1, 20_077), ("bf16x3", 780, 21, 5003), ("bf16x3", 512, 32, 5000),
    ("bf16x3", 496, 33, 5000), ("bf16x3", 321, 51, 3001), ("bf16x3", 16384, 1, 1000),
    ("default", 4000, 4, 3000), ("bf16x4", 1024, 16, 3000),
])
def test_v6_tier_instance_keeps_the_live_rows_resident(device, precision, k, m, n):
    """Where a 64-row block's q parts exceed the resident budget (k > 80),
    v6's instance keeps the live rows' parts in its own plan
    (tiers.tensor_live_epilogue: 32-row blocks two an SM at m <= 32 where
    their parts fit 15 KB, else 64-row blocks one an SM with the split a
    step ahead) with ‖r‖² chained in the block, and still gives B1's tier
    candidates bit for bit at its own P, at the guard's extremes (k m =
    16384, k = 16384 at m = 1, the most live bytes at (321, 51)) and over
    two row tiles (m = 100: 64 + 36 live rows); at k = 80 the parts fit and
    v6 is B1's own launch."""
    assert fused.const_query_fits(m, k)
    terms = tiers.ladder_terms(precision, k)
    k16 = -(-k // 16) * 16
    assert tiers.tensor_q_resident(terms, k16) == (k <= 80)
    assert tiers.tensor_live_q_bytes(terms, m, k16) <= tiers.TENSOR_Q_LIVE_BYTES
    q, r, r_op = _inputs(device, m, k, n, seed=k + m)
    parts = tiers.resident_tier_parts(precision, m, k, n)
    want = tiers.tensor_candidates(q, r_op, n, parts, precision)
    got = fused.const_query_candidates(q, r_op, n, parts, precision)
    torch.cuda.synchronize()
    assert _bits_equal(got, want)
    cutoff = select_cutoff(precision, k)
    if precision != "default":
        assert int(_refine(q, r, got, n, cutoff=cutoff)[0][0]) == n // 2


def test_ladder_tier_wrappers_raise(device):
    """qsplit2 needs a bf16-exact operand, which the rungs' f32 points are
    not; v6 keeps the reference's guard; B10's tensor map needs a 128-float
    row stride; nothing falls back."""
    q, r, r_op = _inputs(device, 8, 16, 1000, seed=5)
    with pytest.raises(ValueError, match="qsplit2"):
        fused.aos_candidates(q, r, 1000, 2, "qsplit2")
    with pytest.raises(ValueError, match="qsplit2"):
        dma_pipeline.dma_candidates(q, r_op, 1000, 2, "qsplit2")
    with pytest.raises(ValueError, match="guard"):
        fused.const_query_candidates(torch.rand((2000, 16), device=device), r_op, 1000, 2,
                                     "packed")
    with pytest.raises(ValueError, match="multiple of 128"):
        dma_pipeline.dma_candidates(q, prep_soa(r, 1000), 1000, 2, "packed")


@pytest.mark.parametrize("k,m,n,tile_n", [(16, 1, 70_001, 1024), (3, 4, 5000, 128),
                                          (32, 2, 1 << 16, 512)])
def test_smallm_knn_tile_n_is_b2s_pipeline(device, k, m, n, tile_n):
    """smallm_knn(tile_n=) runs B2 over the tile_n-padded SoA operand and
    the exact refine: the AoS scan's answers, one B2 launch."""
    q, r, _ = _inputs(device, m, k, n, seed=n + k)
    before = smallm.smallm_candidates.launches
    got = smallm.smallm_knn(q, r, tile_n=tile_n)
    torch.cuda.synchronize()
    assert smallm.smallm_candidates.launches == before + 1
    want = smallm.smallm_knn(q, r)
    assert torch.equal(got[0], want[0])
    assert torch.allclose(got[1], want[1], rtol=1e-6, atol=0.0)
    assert int(got[0][0]) == n // 2


# ---- the sharded tier: logical shards on one card, distinct cards ------------


def _exact_topk(q, r, kk):
    d2 = ((q[:, None, :] - r[None, :, :]) ** 2).sum(-1)
    col = torch.arange(r.shape[0], device=r.device).expand_as(d2)
    return topk._lex_smallest(d2, col.to(torch.int32), kk)[1]


@pytest.mark.parametrize("shape", [(None, 1, 4), (None, 2, 2), (2, 1, 2)])
def test_sharded_logical_mesh_on_one_card(device, shape):
    """Logical shards on cuda:0: sharded_knn (pmin and ring), sharded top-K
    and a prepared sharded index answer as the unsharded paths, and the
    tier kernel runs once a shard and dp block."""
    from tpu_knn_torch.distributed.sharded import (
        _build_sharded, default_mesh, multislice_mesh, sharded_knn, sharded_topk_knn,
    )
    from tpu_knn_torch.engine.index import NNIndex

    dcn, dp, sp = shape
    mesh = (default_mesh(dp=dp, sp=sp, devices=device) if dcn is None
            else multislice_mesh(dcn, dp=dp, sp=sp, devices=device))
    n = 70_001
    q, r, _ = _inputs(device, 40, 16, n, seed=77)
    want = fused.fused_knn(q, r)
    tiers.TIER_LAUNCHES.clear()
    for method in ("pmin", "ring"):
        got = sharded_knn(q, r, mesh=mesh, method=method)
        assert got[0].device == device
        assert torch.equal(got[0], want[0]) and torch.allclose(got[1], want[1], rtol=1e-6)
    # One launch a dp block and shard holding a point (none for an empty one).
    n_local = _build_sharded(40, n, 16, mesh).n_local
    live = sum(s * n_local < n for s in range((dcn or 1) * sp))
    assert tiers.TIER_LAUNCHES["packed3"] == 2 * dp * live
    ti, _ = sharded_topk_knn(q, r, 8, mesh=mesh)
    assert torch.equal(ti, _exact_topk(q, r, 8))
    ix = NNIndex(r, strategy="sharded", mesh=mesh)
    assert torch.equal(ix.query(q)[0], want[0])
    assert torch.equal(ix.query(q, neighbors=8)[0], ti)


def test_sharded_mesh_of_distinct_cards():
    """One shard a card: every shard's kernels launch under its own card
    (a launch for an operand off the current card raises), and the
    answers are the one-card answers."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from tpu_knn_torch.distributed.sharded import default_mesh, sharded_knn, sharded_topk_knn
    from tpu_knn_torch.utils.platform import launch_stream

    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    q, r, _ = _inputs(cards[0], 40, 16, 70_001, seed=78)
    with torch.cuda.device(cards[0]):
        with pytest.raises(RuntimeError, match="current device"):
            launch_stream(cards[1])
    mesh = default_mesh(dp=1, sp=len(cards))
    assert mesh.distinct_devices == cards
    want = fused.fused_knn(q, r)
    got = sharded_knn(q, r, mesh=mesh)
    assert torch.equal(got[0], want[0])
    assert torch.equal(sharded_topk_knn(q, r, 8, mesh=mesh)[0], _exact_topk(q, r, 8))
