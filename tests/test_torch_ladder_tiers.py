"""The 1-NN ladder's rungs at tpu_knn's score tier, held against tpu_knn on
the same numpy inputs (Pallas in interpret mode, as its own tests run it):
v3's plain tier candidates over the (n, k) array (tiers.aos_tier_candidates_plain,
the AoS term list) against `_build_fused_candidates(..., soa=False,
precision=)`; fused_knn(soa=False), dma_knn and const_query_knn at
precision=None and at explicit tiers against tpu_knn's v3, v5 and v6;
smallm_knn(tile_n=) against tpu_knn's B2 pipeline; and the one kept
divergence, dma_knn's certification of its tier.

Exact reranks on both sides make the indices identical; d2 may differ only
by f32 summation order. Candidate scores lie within the tier's error gate
(tiers.tier_error_gate) of an f64 recomputation, and a lane whose index
differs from tpu_knn's holds a near-tie within that gate."""

import numpy as np
import pytest
import torch

from tpu_knn.kernels import dma_pipeline as jx_dma
from tpu_knn.kernels import fused as jx_fused
from tpu_knn.kernels import smallm as jx_smallm
from tpu_knn.kernels.tuning import pick_tiles
from tpu_knn.oracle import oracle_knn
from tpu_knn_torch.kernels import dma_pipeline as pt_dma
from tpu_knn_torch.kernels import fused as pt_fused
from tpu_knn_torch.kernels import smallm as pt_smallm
from tpu_knn_torch.kernels import tiers


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _d2_64(q, r, idx):
    """Exact f64 squared distances of each query to the points idx (m, C)."""
    valid = idx < r.shape[0]
    pts = r[np.where(valid, idx, 0)].astype(np.float64)
    d = ((pts - q[:, None, :].astype(np.float64)) ** 2).sum(-1)
    return np.where(valid, d, np.inf)


# ---- v3's plain tier candidates against tpu_knn's AoS kernel ----------------

#: (precision, k): packed at k = 3 and 16, and at k = 12, where tpu_knn's
#: unpadded AoS block takes all 9 terms (the SoA path 8); bf16x3 at k = 40,
#: bf16x4 at k = 24.
AOS_CASES = [("packed", 3), ("packed", 12), ("packed", 16), ("bf16x3", 40), ("bf16x4", 24)]


@pytest.mark.parametrize("precision,k", AOS_CASES)
def test_aos_plain_candidates_match_tpu_knn(precision, k):
    m, n = 16, 2001
    rng = np.random.default_rng(5 * k + len(precision))
    q = rng.random((m, k), np.float32)
    r = rng.random((n, k), np.float32)
    r[n // 2] = r[n // 3] = q[0]                      # an exact duplicate pair
    cand = jx_fused._build_fused_candidates(m, n, k, 8, 1024, soa=False, precision=precision)
    ji, js = (np.asarray(a) for a in cand(q, r))
    pi, ps = tiers.aos_tier_candidates_plain(_t(q), _t(r), n, 1, precision)
    pi, ps = pi.numpy(), ps.numpy()
    if precision == "packed" and k == 12:
        assert len(tiers.term_list(precision, k, aos=True)) == 9
        assert len(tiers.term_list(precision, k)) == 8
    assert (pi == ji).mean() >= 0.99
    ji, js = np.array(ji), np.array(js)
    jx_err = tiers.score_errors(_t(q), _t(r), torch.from_numpy(ji), torch.from_numpy(js))[0]
    pt_err, _, pt_abs = tiers.score_errors(_t(q), _t(r), torch.from_numpy(pi), torch.from_numpy(ps))
    assert pt_err <= tiers.tier_error_gate(precision, k, jx_err)
    # A lane that picked another point than tpu_knn's holds a near-tie.
    rows, lanes = np.nonzero(pi != ji)
    gap = np.abs(_d2_64(q, r, pi)[rows, lanes] - _d2_64(q, r, ji)[rows, lanes])
    scale = np.abs(ps[np.isfinite(ps)]).max()
    assert (gap <= 2 * tiers.tier_error_gate(precision, k, jx_err) * scale + 2 * pt_abs).all()
    cutoff = pt_fused.select_cutoff(precision, k)
    wi, wd = (np.asarray(a) for a in jx_fused._refine(q, r, (ji, js), n, cutoff=cutoff))
    gi, gd = pt_fused._refine(_t(q), _t(r), (torch.from_numpy(pi), torch.from_numpy(ps)), n,
                              cutoff=cutoff)
    np.testing.assert_array_equal(gi.numpy(), wi)
    np.testing.assert_allclose(gd.numpy(), wd, rtol=1e-6)
    assert int(gi[0]) == n // 3


# ---- v3, v5 and v6 end to end against tpu_knn ---------------------------------


def _planted(m, n, k, seed):
    """Exact duplicates of query i's point at two adjacent columns astride
    a lane boundary (127 | 128), tpu_knn's tile boundaries (v3/v6's and
    v5's n tiles) and the port's tier partition boundaries (B1's tier
    geometry, which v3 and B10 take, and v6's), so the lowest-index tie
    rule decides every planted row; points 0.5 away from the queries
    otherwise."""
    rng = np.random.default_rng(seed)
    q = rng.random((m, k), np.float32)
    r = rng.random((n, k), np.float32) + 0.5
    cols = [127, pick_tiles(k, m, n)[1] - 1, jx_dma._dma_tiles(k, m, n)[1] - 1]
    for parts in (tiers.tensor_parts(m, n),
                  tiers.resident_tier_parts(jx_fused.auto_precision(k, n), m, k, n)):
        gpp = -(-(-(-n // 128)) // parts)
        cols += [p * gpp * 128 - 1 for p in range(1, min(parts, 4))]
    cols = sorted({c for c in cols if 0 < c < n - 1})[:m]
    for i, c in enumerate(cols):
        r[c] = r[c + 1] = q[i]
    return q, r, cols


def _jx(rung, q, r, precision):
    if rung == "v3":
        return jx_fused.fused_knn(q, r, soa=False, precision=precision)
    if rung == "v5":
        return jx_dma.dma_knn(q, r, precision=precision)
    m = q.shape[0]
    return jx_fused.fused_knn(q, r, soa=True, tile_m=-(-m // 8) * 8, precision=precision)


def _pt(rung, q, r, precision):
    if rung == "v3":
        return pt_fused.fused_knn(q, r, soa=False, precision=precision, device="cpu")
    if rung == "v5":
        return pt_dma.dma_knn(q, r, precision=precision, allow_approximate=True, device="cpu")
    return pt_fused.const_query_knn(q, r, precision=precision, device="cpu")


#: (rung, precision, m, n, k): each rung at precision=None (packed3 at k =
#: 3, 12 and 16, bf16x3 at k = 40) and at explicit tiers; bf16x3_presplit
#: (bf16x3's terms over the f32 points in the port; tpu_knn's v6 runs its
#: presplit kernel, the same terms beside another ‖r‖² rounding).
ENTRY_CASES = [
    ("v3", None, 12, 6000, 3), ("v3", None, 9, 4099, 12), ("v3", None, 16, 5000, 40),
    ("v3", "bf16x4", 7, 3001, 16), ("v3", "bf16x3_presplit", 5, 3000, 24),
    ("v5", None, 12, 6000, 3), ("v5", None, 3, 9000, 16), ("v5", None, 16, 5000, 40),
    ("v5", "bf16x4", 7, 3001, 24), ("v5", "bf16_raw", 6, 2999, 16),
    ("v6", None, 40, 5000, 3), ("v6", None, 12, 6000, 16), ("v6", None, 9, 4099, 40),
    ("v6", "bf16x4", 7, 3001, 16), ("v6", "bf16x3_presplit", 5, 3000, 40),
]


@pytest.mark.parametrize("rung,precision,m,n,k", ENTRY_CASES)
def test_ladder_rungs_match_tpu_knn_at_their_tier(rung, precision, m, n, k):
    q, r, cols = _planted(m, n, k, seed=7 * n + k + m)
    wi, wd = (np.asarray(a) for a in _jx(rung, q, r, precision))
    gi, gd = _pt(rung, q, r, precision)
    np.testing.assert_array_equal(gi.numpy(), wi)
    np.testing.assert_allclose(gd.numpy(), wd, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(gi.numpy()[:len(cols)], cols)
    np.testing.assert_array_equal(gi.numpy(), oracle_knn(q, r))


# ---- smallm_knn(tile_n=) -----------------------------------------------------


@pytest.mark.parametrize("m,k,n,tile_n", [(3, 16, 5000, 1024), (1, 5, 3001, 256),
                                          (4, 32, 2050, 128)])
def test_smallm_tile_n_pipeline_matches_tpu_knn(m, k, n, tile_n):
    """tpu_knn's per-call B2 pipeline (SoA prep at round_up(n, tile_n), the
    candidates, the exact refine) and the port's give the same answers,
    duplicates at a lane and a tile boundary resolving to the lower
    index."""
    rng = np.random.default_rng(m + k + n)
    q = rng.random((m, k), np.float32)
    r = rng.random((n, k), np.float32) + 0.5
    for i, c in enumerate((127, tile_n - 1, n - 3)[:m]):
        r[c] = r[c + 1] = q[i]
    wi, wd = (np.asarray(a) for a in jx_smallm.smallm_knn(q, r, tile_n=tile_n))
    gi, gd = pt_smallm.smallm_knn(q, r, tile_n=tile_n, device="cpu")
    np.testing.assert_array_equal(gi.numpy(), wi)
    np.testing.assert_allclose(gd.numpy(), wd, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(gi.numpy(), oracle_knn(q, r))


@pytest.mark.parametrize("m,k,tile_n,match", [
    (2, 8, 100, "positive multiple of 128"), (2, 8, 0, "positive multiple of 128"),
    (5, 8, 256, "1 <= m <= 4"), (2, 33, 256, "1 <= k <= 32"),
])
def test_smallm_tile_n_raises_tpu_knns_errors(m, k, tile_n, match):
    q, r = np.zeros((m, k), np.float32), np.ones((300, k), np.float32)
    with pytest.raises(ValueError, match=match):
        jx_smallm.smallm_knn(q, r, tile_n=tile_n)
    with pytest.raises(ValueError, match=match):
        pt_smallm.smallm_knn(q, r, tile_n=tile_n, device="cpu")


# ---- the kept divergence: dma_knn certifies its tier --------------------------


def test_dma_knn_certifies_its_tier_where_tpu_knn_does_not():
    """tpu_knn's dma_knn takes any tier name: "qsplit2" over per-call f32
    points (unsound: the operand loses 2^-8 of r in the downcast) and
    "bf16_raw" without an opt-in. The port's runs fused_knn's
    certification (ROADMAP C): qsplit2 raises, bf16_raw needs
    allow_approximate=True, an unknown name raises."""
    rng = np.random.default_rng(17)
    q, r = rng.random((6, 16), np.float32), rng.random((2000, 16), np.float32)
    assert np.asarray(jx_dma.dma_knn(q, r, precision="qsplit2")[0]).shape == (6,)
    assert np.asarray(jx_dma.dma_knn(q, r, precision="bf16_raw")[0]).shape == (6,)
    with pytest.raises(ValueError, match="qsplit2"):
        pt_dma.dma_knn(q, r, precision="qsplit2", device="cpu")
    with pytest.raises(ValueError, match="selection-approximate"):
        pt_dma.dma_knn(q, r, precision="bf16_raw", device="cpu")
    with pytest.raises(ValueError, match="unknown precision"):
        pt_dma.dma_knn(q, r, precision="tf32", device="cpu")
    idx, _ = pt_dma.dma_knn(q, r, precision="bf16_raw", allow_approximate=True, device="cpu")
    assert idx.shape == (6,)
