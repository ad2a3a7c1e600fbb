"""Kernels B1, B2, B4, B5 and B6 against their plain torch versions on an
sm_90 card.

Skipped without a card. This file imports no jax, so on a machine with the
card but without jax it runs apart from the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import pytest
import torch

from tpu_knn_torch.kernels import fused, smallm, topk
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
    (768, 40, 5000, 5),   # 32-row tile above 48 KB of shared memory
    (7000, 3, 300, 2),    # 1-row tile (tuning.cuda_tile_m)
])
def test_b1_matches_plain(device, k, m, n, parts):
    q, r, r_op = _inputs(device, m, k, n, seed=k + m)
    _check(fused.fused_candidates, fused.fused_candidates_plain, q, r, r_op,
           n, parts, select_cutoff("highest", k))


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


@pytest.mark.parametrize("k,m,n,kk,parts", [
    (16, 8, 70_000, 32, 5), (5, 24, 3000, 8, 3), (3, 3, 1000, 1, 1),
    (16, 13, 20_000, 16, 9), (40, 6, 5000, 4, 2),
])
def test_b5_matches_plain_and_the_passes_engine(device, k, m, n, kk, parts):
    q, r, r_op = _dup_inputs(device, m, k, n, seed=k * kk + m)
    before = topk.sweep_candidates.launches
    got = _topk_from(topk.sweep_candidates(q, r_op, n, parts, kk), q, r, n, kk)
    torch.cuda.synchronize()
    assert topk.sweep_candidates.launches == before + 1
    want = _topk_from(topk.sweep_candidates_plain(q, r_op, n, parts, kk), q, r, n, kk)
    assert torch.equal(got[0], want[0])
    passes = topk._build_topk(m, n, k, kk, "passes")(q, (r_op,), r)
    assert torch.equal(got[0], passes[0]) and torch.equal(got[1], passes[1])
    if kk >= 2:
        assert got[0][0, :2].tolist() == [127, 128]


@pytest.mark.parametrize("k,m,n,kk,parts", [
    (16, 4, 70_000, 16, 9), (8, 1, 3000, 32, 3), (32, 4, 5000, 32, 2),
    (3, 2, 777, 1, 1), (16, 3, 20_000, 8, 40),
])
def test_b6_matches_plain(device, k, m, n, kk, parts):
    q, r, r_op = _dup_inputs(device, m, k, n, seed=k + kk + m)

    def bound_of(b2):   # each version is seeded from its own B2 pass
        _, cs1 = b2(q, r_op, n, smallm.default_parts(n))
        return torch.topk(cs1, kk, dim=-1, largest=False).values[:, -1].contiguous()

    bound = bound_of(smallm.smallm_candidates)
    before = topk.smallm_topk_candidates.launches
    ci, cs = topk.smallm_topk_candidates(q, r_op, n, parts, kk, bound)
    torch.cuda.synchronize()
    assert topk.smallm_topk_candidates.launches == before + 1
    real = ci < n
    assert ((cs <= bound[:, None]) | ~real).all()
    assert (cs[~real] == bound[:, None].expand_as(cs)[~real]).all()
    got = topk._finalize_topk(q, r, ci, cs, kk, n)
    want = _topk_from(topk.smallm_topk_candidates_plain(
        q, r_op, n, parts, kk, bound_of(smallm.smallm_candidates_plain)), q, r, n, kk)
    assert torch.equal(got[0], want[0])
    if kk >= 2:
        assert got[0][0, :2].tolist() == [127, 128]
