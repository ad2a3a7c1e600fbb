"""The top-K engines at tpu_knn's score tier (kernels/tiers.py's top-K
instances, the precision= of B4, B5, B3 and B7's wrappers and of every
top-K entry point), held against tpu_knn on the same numpy inputs (Pallas
in interpret mode, as tests/test_torch_seeded.py runs it).

Two halves:
- each plain instance against its tpu_knn kernel (`_build_*`) at the same tier
  (`_build_banded_candidates`, `_build_sweep_candidates`,
  `_build_minima_candidates`, `_build_extract_candidates`): index agreement
  of at least 0.99 and scores within twice the tier's bound
  (tiers.tier_error_bound, relative to the largest |score|), as
  tests/test_torch_precision.py holds B1's tiers; B7's packed words
  identical where the bound (and the band's lo) lies in a gap of the
  scores wider than that;
- every top-K entry point end to end, at the tier each package resolves:
  the same indices as tpu_knn (but at d2 near-ties, which two f32
  summation orders may break apart) and 0 errors under the harness
  checker's rule (tpu_knn_torch.harness.checker) against a numpy oracle,
  rank by rank, on data with planted exact duplicates and winners at tile
  edges.

tpu_knn's calls take a second or more each in interpret mode, so the
engine calls are shared through module-scoped fixtures."""

import ml_dtypes
import numpy as np
import pytest
import torch

import tpu_knn_torch
from tpu_knn.api import knn_graph as jx_knn_graph
from tpu_knn.engine.index import NNIndex as JaxIndex
from tpu_knn.kernels import fused as jx_fused
from tpu_knn.kernels import topk as jx_topk
from tpu_knn_torch.harness.checker import check_results
from tpu_knn_torch.kernels import fused as pt_fused
from tpu_knn_torch.kernels import seeded as pt_seeded
from tpu_knn_torch.kernels import tiers
from tpu_knn_torch.kernels import topk as pt_topk
from tpu_knn_torch.kernels.fused import prep_soa

I32_MAX = 2**31 - 1


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _np(pair):
    return tuple(np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a) for a in pair)


def _d2(q, r):
    return ((q[:, None, :].astype(np.float64) - r[None, :, :]) ** 2).sum(-1)


def _oracle_topk(q, r, kk):
    d = _d2(q, r)
    return np.lexsort((np.tile(np.arange(r.shape[0]), (q.shape[0], 1)), d))[:, :kk]


# ---- each plain instance against its tpu_knn kernel ----------------------------

#: (precision, k, K): packed (packed3 at k = 3 and 16, packed2 at 32),
#: bf16x3 at embedding-like widths, bf16x4, and qsplit2 over a bf16-exact
#: operand (the quantized stores' tier), B5 at min(K, 32).
KERNEL_CASES = [("packed", 3, 8), ("packed", 16, 16), ("packed", 32, 32),
                 ("bf16x3", 40, 40), ("bf16x3", 128, 128), ("bf16x4", 24, 24),
                 ("qsplit2", 128, 128)]
M, N, N_OPS, TILE_N = 8, 2000, 2048, 1024


def _case_inputs(precision, k):
    """Queries and points (qsplit2: points rounded to bf16), the port's
    operand (a bf16 store's for qsplit2) and the port's plain scores at
    the tier. Query 0 has an exact duplicate pair at columns 129 and 1025
    (the same lane, two column tiles apart) and 4 copies of query 1 share
    one 64-column cell (B7's overflow flag)."""
    rng = np.random.default_rng(31 * k + len(precision))
    q = rng.random((M, k), np.float32)
    r = rng.random((N, k), np.float32)
    r[[129, 1025]] = q[0]
    r[[40, 41, 60, 62]] = q[1]
    if precision == "qsplit2":
        r = r.astype(ml_dtypes.bfloat16).astype(np.float32)
        r_op = prep_soa(torch.from_numpy(r).to(torch.bfloat16), N_OPS)
    else:
        r_op = prep_soa(_t(r), N_OPS)
    s = pt_fused.scores(_t(q), r_op, N, precision).numpy()
    return q, r, r_op, s


def _within_bound(got, want, precision, k, scale):
    bound = 2 * tiers.tier_error_bound(precision, k) * scale
    return np.max(np.abs(got - want), initial=0.0) <= bound


def _bound_in_gap(s, lo_rank, hi_rank, precision, k):
    """Per row, the midpoint of the widest gap between consecutive sorted
    scores of ranks lo_rank..hi_rank, asserted wider than four times the
    tier's bound, so both arithmetics put the same columns on each side."""
    srt = np.sort(s, axis=1)[:, :hi_rank + 1]
    gaps = srt[:, lo_rank + 1:] - srt[:, lo_rank:-1]
    j = np.argmax(gaps, axis=1) + lo_rank
    rows = np.arange(s.shape[0])
    margin = 4 * tiers.tier_error_bound(precision, k) * np.abs(s).max()
    assert (gaps.max(axis=1) > margin).all(), (precision, k, gaps.max(axis=1).min(), margin)
    return ((srt[rows, j] + srt[rows, j + 1]) / 2).astype(np.float32)


@pytest.mark.parametrize("precision,k,kk", KERNEL_CASES)
def test_b4_plain_matches_tpu_knn_at_the_tier(precision, k, kk):
    q, r, r_op, s = _case_inputs(precision, k)
    srt = np.sort(s, axis=1)
    b_s = ((srt[:, 3] + srt[:, 4]) / 2).astype(np.float32)
    b_i = np.full((M,), 7, np.int32)
    # Row 0: the band at the port's own (score, column) of the duplicate at
    # 129, so that its twin at 1025 (the same lane) is the lane's answer.
    b_s[0], b_i[0] = s[0, 129], 129
    cand = jx_fused._build_banded_candidates(M, N, k, 8, TILE_N, precision)
    ji, js = _np(cand(q, cand.prep_soa(r), b_s[:, None], b_i[:, None]))
    pi, ps = _np(pt_fused.banded_candidates(_t(q), r_op, N, 1, _t(b_s), torch.from_numpy(b_i),
                                            precision=precision))
    fin = np.isfinite(js)
    agree = fin & (pi == ji)
    assert agree.sum() >= 0.99 * fin.sum()
    assert _within_bound(ps[agree], js[agree], precision, k, np.abs(js[fin]).max())
    assert pi[0, 1] == 1025


@pytest.mark.parametrize("precision,k,kk", KERNEL_CASES)
def test_b5_plain_matches_tpu_knn_at_the_tier(precision, k, kk):
    """tpu_knn's per-lane K-lists reduced to the port's per-partition lists
    (list_of, P = 3): index agreement and scores within the tier's bound,
    and the sweep's lists agree with B4's passes at the same tier."""
    q, r, r_op, s = _case_inputs(precision, k)
    kk, parts = min(kk, pt_topk.SWEEP_MAX_NEIGHBORS), 3
    cand = jx_topk._build_sweep_candidates(M, N, k, kk, 8, TILE_N, precision)
    ji, js = _np(cand(q, cand.prep_soa(r)))
    wi = np.full((M, parts * kk), I32_MAX, np.int32)
    ws = np.full((M, parts * kk), np.inf, np.float32)
    for i in range(M):
        real = (ji[i] < N) & np.isfinite(js[i])
        cols, vals = ji[i][real], js[i][real]
        lists = pt_topk.list_of(cols, N, parts)
        for p in range(parts):
            c, v = cols[lists == p], vals[lists == p]
            order = np.lexsort((c, v))[:kk]
            wi[i, p * kk:p * kk + len(order)] = c[order]
            ws[i, p * kk:p * kk + len(order)] = v[order]
    pi, ps = _np(pt_topk.sweep_candidates(_t(q), r_op, N, parts, kk, precision=precision))
    fin = np.isfinite(ws)
    agree = fin & (pi == wi)
    assert agree.sum() >= 0.99 * fin.sum()
    assert _within_bound(ps[agree], ws[agree], precision, k, np.abs(ws[fin]).max())
    assert np.array_equal(np.isfinite(ps), fin)
    # B4 and B5 score alike at the tier: each list's levels are the
    # lexicographic order of B4's passes over the same scores.
    assert (np.sort(ps, axis=1)[:, :kk] == np.sort(s, axis=1)[:, :kk]).all()


@pytest.mark.parametrize("precision,k,kk", KERNEL_CASES)
def test_b3_plain_matches_tpu_knn_at_the_tier(precision, k, kk):
    """Depth 1 (depth 2 where K > 64) over a prefix, and a banded pass:
    the per-lane minima within the tier's bound of tpu_knn's."""
    q, r, r_op, s = _case_inputs(precision, k)
    lo = _bound_in_gap(s, 3, 30, precision, k)
    # tpu_knn's banded pass is depth 1 only.
    for banded, n_limit, depth in ((False, 1024, 2 if kk > 64 else 1), (True, None, 1)):
        mins = jx_fused._build_minima_candidates(M, N, k, 8, TILE_N, precision, n_ops=N_OPS,
                                                 banded=banded, depth=depth, n_limit=n_limit)
        r_j = np.zeros((-(-k // 8) * 8, N_OPS), np.float32)
        r_j[:k, :N] = r.T
        want = np.asarray(mins(q, (r_j,), *((lo[:, None],) if banded else ())))
        got = pt_fused.minima_candidates(_t(q), r_op, N, depth=depth,
                                         lo=_t(lo) if banded else None, n_limit=n_limit,
                                         precision=precision).numpy()
        assert got.shape == want.shape == (M, 128 * depth)
        fin = np.isfinite(want)
        assert np.array_equal(np.isfinite(got), fin)
        assert _within_bound(got[fin], want[fin], precision, k, np.abs(want[fin]).max())


@pytest.mark.parametrize("precision,k,kk", KERNEL_CASES)
def test_b7_plain_words_equal_tpu_knn_at_the_tier(precision, k, kk):
    """The bound (and, banded, the lo) in a gap of the scores wider than
    the tier's error: the packed words (and p3) identical, the remainder
    minima within the tier's bound; and B7's and B3's plain versions score
    alike (B7's remainder minima above the bound are B3's minima banded at
    it, bit for bit)."""
    q, r, r_op, s = _case_inputs(precision, k)
    bound = _bound_in_gap(s, 40, 160, precision, k)
    banded = kk > 64
    lo = _bound_in_gap(s, 4, 30, precision, k) if banded else None
    mom = jx_topk._build_extract_candidates(M, N, k, 8, TILE_N, precision, n_ops=N_OPS, kk=kk,
                                            banded=banded, emit_rem=banded)
    want = [np.asarray(a) for a in mom(q, mom.prep_soa(r), bound[:, None],
                                       *((lo[:, None],) if banded else ()))]
    got = [a.numpy() for a in pt_seeded.extract_moments(
        _t(q), r_op, N, _t(bound), mom.cell, mom.n_fields, lo=_t(lo) if banded else None,
        emit_rem=banded, precision=precision)]
    assert len(got) == len(want)
    for g, w in zip(got[:len(got) - banded], want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    if banded:
        fin = np.isfinite(want[-1])
        assert np.array_equal(np.isfinite(got[-1]), fin)
        assert _within_bound(got[-1][fin], want[-1][fin], precision, k,
                             np.abs(want[-1][fin]).max())
    assert (got[0] != 0).any()
    rem = pt_seeded.extract_moments(_t(q), r_op, N, _t(bound), mom.cell, mom.n_fields,
                                    lo=torch.full((M,), -torch.inf), emit_rem=True,
                                    precision=precision)[-1]
    assert torch.equal(rem, pt_fused.minima_candidates(_t(q), r_op, N, lo=_t(bound),
                                                       precision=precision))


# ---- the routing of the tier --------------------------------------------------


def test_topk_entry_points_resolve_tpu_knns_tier(monkeypatch):
    """topk_knn (and so within_radius and knn_graph) hands
    auto_precision(k, n) to its engines; an index its own precision."""
    seen = []
    real = pt_topk._build_topk_percall

    def spy(m, n, k, kk, method="auto", precision="highest"):
        seen.append(precision)
        return real(m, n, k, kk, method, precision)

    monkeypatch.setattr(pt_topk, "_build_topk_percall", spy)
    rng = np.random.default_rng(4)
    for k in (3, 16, 40):
        q, r = rng.random((6, k), np.float32), rng.random((700, k), np.float32)
        pt_topk.topk_knn(q, r, 3, method="passes", device="cpu")
        assert seen[-1] == jx_fused.auto_precision(k, 700)
        pt_topk.within_radius(q, r, 0.5, 4, method="passes", device="cpu")
        assert seen[-1] == jx_fused.auto_precision(k, 700)
        tpu_knn_torch.knn_graph(r[:300], 3, device="cpu")
        assert seen[-1] == jx_fused.auto_precision(k, 300)


# ---- the entry points end to end --------------------------------------------


def _planted(m, k, n, seed):
    """Uniform data with query 0 copied to columns 127, 128 and n - 1 (a
    group edge and the last column: the lowest index wins the tie) and
    query 1 to columns 1023 and 1024 (a column tile's last and the next
    one's first)."""
    rng = np.random.default_rng(seed)
    q = rng.random((m, k), np.float32)
    r = rng.random((n, k), np.float32)
    r[[127, 128, n - 1]] = q[0]
    r[[1023, 1024]] = q[1]
    return q, r


def _check(got, want, q, r, kk):
    """The same indices as tpu_knn but where two ranks' d2 agree to f32
    rounding, d2 within 1e-6 relative, and 0 errors under the harness
    checker's rule against the numpy oracle at every rank."""
    gi, gd = (np.asarray(a) for a in _np(got))
    wi, wd = (np.asarray(a) for a in _np(want))
    assert gi.shape == wi.shape
    np.testing.assert_allclose(gd, wd, rtol=1e-6, atol=1e-7)
    fin = np.isfinite(wd)
    assert np.array_equal(np.isfinite(gd), fin)
    bad = gi != wi
    assert fin[bad].all()
    assert np.all(np.abs(gd[bad] - wd[bad]) <= 1e-6 * np.abs(wd[fin]).max() + 1e-7)
    oracle = _oracle_topk(q, r, kk)
    live = gi >= 0
    for j in range(kk):
        rows = live[:, j]
        errors, _ = check_results(oracle[rows, j], gi[rows, j], q, r)
        assert errors == 0, (j, errors)


#: Per-call cases: (k, m, n, K, method); k = 16 resolves "packed", k = 40
#: "bf16x3".
PERCALL = [(16, 8, 2000, 8, "sweep"), (16, 8, 2000, 8, "passes"), (16, 24, 2000, 16, "seeded"),
           (16, 3, 2000, 8, "aos"), (40, 8, 2000, 8, "sweep"), (40, 6, 2000, 5, "passes"),
           (40, 40, 4096, 12, "auto")]


@pytest.fixture(scope="module")
def percall():
    out = {}
    for i, (k, m, n, kk, method) in enumerate(PERCALL):
        q, r = _planted(m, k, n, 50 + i)
        out[i] = (q, r, kk, _np(jx_topk.topk_knn(q, r, kk, method=method)))
    return out


@pytest.mark.parametrize("case", range(len(PERCALL)))
def test_topk_knn_matches_tpu_knn_at_its_tier(percall, case):
    q, r, kk, want = percall[case]
    method = PERCALL[case][4]
    before = dict(tiers.TIER_LAUNCHES)
    got = pt_topk.topk_knn(q, r, kk, method=method, device="cpu")
    assert dict(tiers.TIER_LAUNCHES) == before        # the CPU runs the plain versions
    _check(got, want, q, r, kk)
    assert int(got[0][0, 0]) == 127 and int(got[0][1, 0]) == 1023


def test_knn_graph_and_within_radius_match_tpu_knn():
    q, r = _planted(6, 16, 1500, 60)
    gi = _np(tpu_knn_torch.knn_graph(r, 8, device="cpu"))[0]
    np.testing.assert_array_equal(gi, np.asarray(jx_knn_graph(r, 8)[0]))
    d = _d2(r, r)
    np.fill_diagonal(d, np.inf)                           # each point's K OTHER points
    oracle = np.lexsort((np.tile(np.arange(r.shape[0]), (r.shape[0], 1)), d))[:, :8]
    for j in range(8):
        assert check_results(oracle[:, j], gi[:, j], r, r)[0] == 0
    assert gi[127, 0] == 128 and gi[128, 0] == 127        # duplicates, self excluded
    gi, gd, gc = pt_topk.within_radius(q, r, 0.9, 12, device="cpu")
    wi, wd, wc = (np.asarray(a) for a in jx_topk.within_radius(q, r, 0.9, 12))
    np.testing.assert_array_equal(gc.numpy(), wc)
    _check((gi, gd), (wi, wd), q, r, 12)


@pytest.fixture(scope="module")
def indexes():
    """(name -> (port index, tpu_knn index, queries, points, K)): a fused
    index at k = 16 (packed; K = 16 takes the sweep) and k = 40 (bf16x3;
    K = 40 the seeded engine), a bf16 store at k = 128 (qsplit2), an int8
    store (packed over the grid's bf16 operand), a mutable index after
    remove, a filtered view."""
    out = {}
    q, r = _planted(8, 16, 2000, 70)
    out["fused k=16"] = (tpu_knn_torch.NNIndex(r, device="cpu"), JaxIndex(r), q, r, 16)
    q, r = _planted(8, 40, 2000, 71)
    out["fused k=40"] = (tpu_knn_torch.NNIndex(r, device="cpu"), JaxIndex(r), q, r, 40)
    q, r = _planted(8, 128, 2048, 72)
    r = r.astype(ml_dtypes.bfloat16).astype(np.float32)
    out["bf16 k=128"] = (tpu_knn_torch.NNIndex(r, store="bf16", device="cpu"),
                         JaxIndex(r, store="bf16"), q, r, 16)
    q, r = _planted(8, 16, 2000, 73)
    out["int8"] = (tpu_knn_torch.NNIndex(r, store="int8", device="cpu"),
                   JaxIndex(r, store="int8"), q, r, 8)
    q, r = _planted(8, 16, 2000, 74)
    ix = tpu_knn_torch.NNIndex(r[:1500], mutable=True, device="cpu")
    jx = JaxIndex(r[:1500], mutable=True)
    ids = ix.add(r[1500:])
    np.testing.assert_array_equal(np.asarray(ids), np.asarray(jx.add(r[1500:])))
    gone = np.arange(200, 260)
    ix.remove(gone)
    jx.remove(gone)
    out["mutable"] = (ix, jx, q, r, 8)
    q, r = _planted(8, 16, 2000, 75)
    keep = np.arange(2000) % 3 != 1
    keep[[127, 128, 1999, 1023, 1024]] = True
    out["view"] = (tpu_knn_torch.NNIndex(r, device="cpu").filtered_view(keep),
                   JaxIndex(r).filtered_view(keep), q, r, 8)
    return out


@pytest.mark.parametrize("name", ["fused k=16", "fused k=40", "bf16 k=128", "int8", "mutable",
                                  "view"])
def test_index_topk_and_radius_match_tpu_knn(indexes, name):
    ix, jx, q, r, kk = indexes[name]
    assert ix.precision == jx.precision
    got, want = ix.query(q, neighbors=kk), jx.query(q, neighbors=kk)
    gi, gd = _np(got)
    wi, wd = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-6)
    live = np.ones(r.shape[0], bool)
    if name == "mutable":
        live[200:260] = False
    if name == "view":
        live[np.arange(r.shape[0]) % 3 == 1] = False
        live[[127, 128, 1999, 1023, 1024]] = True
    assert live[gi].all()
    if name in ("fused k=16", "fused k=40"):
        _check(got, want, q, r, kk)
    assert gi[0, 0] == 127 and gi[1, 0] == 1023
    g = ix.query_radius(q, 0.5, max_results=8)
    w = jx.query_radius(q, 0.5, max_results=8)
    np.testing.assert_array_equal(np.asarray(g[0]), np.asarray(w[0]))
    np.testing.assert_array_equal(np.asarray(g[2]), np.asarray(w[2]))
