"""The seeded top-K engine of tpu_knn_torch (kernels/seeded.py, B3's
wrapper in kernels/fused.py, knn_graph in api.py), held against tpu_knn on
the same numpy inputs (Pallas in interpret mode, as tests/test_topk.py
runs it on the CPU) and against a numpy lexicographic oracle.

tpu_knn's seeded calls take seconds each in interpret mode, so each is
made once, in a module-scoped fixture, and shared by the cases."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_knn
import tpu_knn_torch
from tpu_knn.engine.index import NNIndex as JaxIndex
from tpu_knn.kernels import fused as jx_fused
from tpu_knn.kernels import topk as jx_topk
from tpu_knn_torch.kernels import fused as pt_fused
from tpu_knn_torch.kernels import seeded as pt_seeded
from tpu_knn_torch.kernels import topk as pt_topk
from tpu_knn_torch.kernels.fused import prep_soa


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _d2(q, r):
    return ((q[:, None, :] - r[None, :, :]) ** 2).sum(-1)


def oracle_topk(q, r, kk):
    D = _d2(q, r)
    return np.lexsort((np.tile(np.arange(r.shape[0]), (q.shape[0], 1)), D))[:, :kk]


def _np(pair):
    return tuple(np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
                 for a in pair)


def _tiers(fn):
    """Run fn() and return (its result, the seeded tiers it moved)."""
    before = dict(pt_seeded.TIERS)
    out = fn()
    return out, {k: v - before[k] for k, v in pt_seeded.TIERS.items() if v != before[k]}


def _assert_topk(got, want, rtol=1e-6, atol=1e-7):
    """Indices identical except at ranks whose d2 agree to f32 rounding (a
    tie that two summation orders of the same d2 break apart: XLA's and
    torch's sums differ in the last bit); d2 within rtol 1e-6, atol 1e-7."""
    gi, gd = got
    wi, wd = want
    np.testing.assert_allclose(gd, wd, rtol=rtol, atol=atol)
    bad = gi != wi
    assert np.all(np.abs(gd - wd)[bad] <= rtol * np.abs(wd).max() + atol), (
        f"{int(bad.sum())} ranks differ beyond a near-tie")


# ---- the engine's forms against tpu_knn and the oracle --------------------

#: (m, k, n, K) per form: quad cells (K <= 16, half and none prefix bound),
#: cubic 256-lane (K = 32), 128-lane with the 4-part split (K = 48/64), the
#: single band with the depth-2 bound (K = 96/128) and score-band rounds
#: (K = 300). Ragged n at 70000 and 40000.
FORMS = {
    "quad K=8 prefix": (40, 7, 70_000, 8),
    "quad K=16": (40, 7, 40_000, 16),
    "cubic K=32": (16, 8, 1 << 16, 32),
    "128-lane K=48": (16, 8, 1 << 15, 48),
    "128-lane K=64": (16, 8, 1 << 15, 64),
    "single band K=96": (16, 8, 1 << 16, 96),
    "single band K=128": (16, 8, 1 << 16, 128),
    "rounds K=300": (8, 8, 1 << 16, 300),
}


@pytest.fixture(scope="module")
def forms():
    out = {}
    for i, (name, (m, k, n, kk)) in enumerate(FORMS.items()):
        rng = np.random.default_rng(100 + i)
        q = rng.random((m, k), np.float32)
        r = rng.random((n, k), np.float32)
        r[n // 3] = q[1]                                   # d = 0 hit
        out[name] = (q, r, kk, _np(jx_topk.topk_knn(q, r, kk, method="seeded")))
    return out


@pytest.mark.parametrize("name", list(FORMS))
def test_seeded_forms_match_tpu_knn_and_oracle(forms, name):
    q, r, kk, want = forms[name]
    (gi, gd), tiers = _tiers(lambda: _np(pt_topk.topk_knn(q, r, kk, method="seeded",
                                                         device="cpu")))
    assert gi.dtype == np.int32 and gi.shape == (q.shape[0], kk)
    assert tiers.get("fast", 0) == 1 and "fallback" not in tiers, tiers
    _assert_topk((gi, gd), want)
    oi = oracle_topk(q, r, kk)
    _assert_topk((gi, gd), (oi, np.take_along_axis(_d2(q, r), oi, axis=1)))
    assert gi[1, 0] == r.shape[0] // 3


@pytest.mark.parametrize("name", ["quad K=8 prefix", "128-lane K=64", "single band K=96"])
def test_auto_routes_the_batch_regime_to_seeded(forms, name):
    q, r, kk, want = forms[name]
    assert pt_topk._auto_method(q.shape[0], kk) == "seeded"
    _assert_topk(_np(pt_topk.topk_knn(q, r, kk, device="cpu")), want)


def test_prepadded_operand_wider_than_n():
    """A prepadded operand with whole padding tiles (tpu_knn's regression
    for phantom columns): no phantom cell qualifies, the engine certifies
    and matches tpu_knn's on the same operand width."""
    rng = np.random.default_rng(30)
    m, n, k, n_ops = 16, 1024, 8, 1536
    q = rng.normal(0, 1, (m, k)).astype(np.float32)
    r = rng.normal(0, 1, (n, k)).astype(np.float32)
    r_op = jnp.pad(jnp.asarray(r), ((0, n_ops - n), (0, 0))).T
    want = _np(jx_topk._build_topk(m, n, k, 4, n_ops, "packed", "seeded")(
        jnp.asarray(q), (r_op,), jnp.asarray(r)))
    run = pt_topk._build_topk(m, n, k, 4, n_ops, "seeded")
    got, tiers = _tiers(lambda: _np(run(_t(q), (prep_soa(_t(r), n_ops),), _t(r))))
    assert tiers == {"fast": 1}
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0], oracle_topk(q, r, 4))
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-7)
    cell, nf = pt_seeded._extract_mode(pt_seeded._extract_tile_n(n_ops, 8192, k), 4)
    a = pt_seeded.extract_moments(_t(q), prep_soa(_t(r), n_ops), n,
                                  torch.full((m,), 5.0), cell, nf)[0]
    assert int((a[:, -(-n // cell):] != 0).sum()) == 0


# ---- each tier, forced by planted data ------------------------------------


def _planted(kind):
    rng = np.random.default_rng(25)
    if kind == "escalated":
        # 40 near points of query 0 in one lane, one per 256-lane cell:
        # the lane-minima bound admits more cells than the fast cap (48)
        # but fewer than the full 2K+16 = 80.
        k, n, m, kk = 8, 1 << 16, 16, 32
        r = (rng.random((n, k)) * 10 + 5).astype(np.float32)
        q = rng.random((m, k)).astype(np.float32)
        for j in range(40):
            r[j * 256 + 7] = q[0] + np.float32(1e-4 * (j + 1))
        return q, r, kk
    # Three exact copies of query 0 in one 64-column cell (the quadratic
    # solver takes 2): that cell is expanded whole into the rerank; a
    # second such cell in the same row sends the batch to the fallback.
    q = rng.random((40, 5), np.float32)
    r = rng.random((9000, 5), np.float32) + 2.0
    r[[5, 17, 29]] = q[0]
    if kind == "fallback":
        r[[200, 210, 220]] = q[0]
    return q, r, 8


TIER_CASES = {"expanded": {"fast": 1, "expanded": 1}, "fallback": {"fallback": 1},
              "escalated": {"escalated": 1}}


@pytest.fixture(scope="module")
def tier_answers():
    out = {}
    for kind in TIER_CASES:
        q, r, kk = _planted(kind)
        out[kind] = (q, r, kk, _np(jx_topk.topk_knn(q, r, kk, method="seeded")))
    return out


@pytest.mark.parametrize("kind", list(TIER_CASES))
def test_planted_tier(tier_answers, kind):
    q, r, kk, want = tier_answers[kind]
    got, tiers = _tiers(lambda: _np(pt_topk.topk_knn(q, r, kk, method="seeded",
                                                     device="cpu")))
    assert tiers == TIER_CASES[kind]
    _assert_topk(got, want)
    oi = oracle_topk(q, r, kk)
    _assert_topk(got, (oi, np.take_along_axis(_d2(q, r), oi, axis=1)))
    if kind == "escalated":
        np.testing.assert_array_equal(got[0][0], [j * 256 + 7 for j in range(kk)])
    else:
        np.testing.assert_array_equal(got[0][0, :3], [5, 17, 29])
        assert np.all(got[1][0, :3] == 0.0)


def test_rounds_escalate_per_round_and_stay_exact():
    """K=100 at a small n runs score-band rounds; 60 near points of query 0
    one per 128-lane cell in one lane overflow the first round's fast
    4-part cap, so that round takes the one-part tier."""
    rng = np.random.default_rng(41)
    k, n, m, kk = 6, 1 << 15, 8, 100
    q = rng.random((m, k)).astype(np.float32)
    r = (rng.random((n, k)) * 10 + 5).astype(np.float32)
    for j in range(60):
        r[j * 128 + 3] = q[0] + np.float32(1e-4 * (j + 1))
    assert pt_seeded.uses_rounds(kk, n)
    got, tiers = _tiers(lambda: _np(pt_topk.topk_knn(q, r, kk, method="seeded",
                                                     device="cpu")))
    assert tiers.get("round_escalated", 0) >= 1
    oi = oracle_topk(q, r, kk)
    _assert_topk(got, (oi, np.take_along_axis(_d2(q, r), oi, axis=1)))
    np.testing.assert_array_equal(got[0][0, :60], [j * 128 + 3 for j in range(60)])


def test_row_chunking_beyond_2048():
    """m > 2048 splits into 1024-row chunks, the ragged tail edge-padded."""
    rng = np.random.default_rng(24)
    m = 2056
    q = rng.random((m, 3)).astype(np.float32)
    r = rng.random((1500, 3)).astype(np.float32)
    r[700] = q[2055]                     # d = 0 in the ragged last chunk
    got, tiers = _tiers(lambda: _np(pt_topk.topk_knn(q, r, 4, method="seeded",
                                                     device="cpu")))
    assert sum(tiers.get(t, 0) for t in ("fast", "escalated", "fallback")) == 3
    want = _np(jx_topk.topk_knn(q, r, 4, method="seeded"))
    _assert_topk(got, want)
    oi = oracle_topk(q, r, 4)
    _assert_topk(got, (oi, np.take_along_axis(_d2(q, r), oi, axis=1)))
    assert got[0][2055, 0] == 700


# ---- the prepared index, knn_graph, radius escalation -------------------


@pytest.fixture(scope="module")
def index_pair():
    rng = np.random.default_rng(4)
    ref = rng.random((8000, 7), np.float32)
    ref[5000] = ref[17]
    jx = JaxIndex(ref, strategy="fused")
    state = {"ref": np.asarray(jx.ref_dev), "r_op": np.asarray(jx.r_ops[0])}
    q = rng.random((40, 7), np.float32)
    q[0] = ref[17]
    return ref, q, _np(jx.query(q, neighbors=8)), {
        "built": tpu_knn_torch.NNIndex(ref, device="cpu"),
        "from_state": tpu_knn_torch.NNIndex.from_state(state, device="cpu")}


@pytest.mark.parametrize("kind", ["built", "from_state"])
def test_index_batch_regime_matches_tpu_knn(index_pair, kind):
    ref, q, want, ours = index_pair
    (gi, gd), tiers = _tiers(lambda: _np(ours[kind].query(q, neighbors=8)))
    assert sum(tiers.values()) >= 1 and gi.shape == (40, 8)
    np.testing.assert_array_equal(gi, want[0])
    np.testing.assert_array_equal(gi, oracle_topk(q, ref, 8))
    np.testing.assert_allclose(gd, want[1], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(gi[0, :2], [17, 5000])


def _gold_graph(points, kk):
    n = points.shape[0]
    d = _d2(points, points).astype(np.float32)
    d[np.arange(n), np.arange(n)] = np.inf
    order = np.argsort(d, 1, kind="stable")[:, :kk]
    return order, np.take_along_axis(d, order, 1)


@pytest.mark.parametrize("n,k,kk,dups", [(2048, 6, 8, 0), (300, 4, 3, 5)])
def test_knn_graph_matches_tpu_knn(n, k, kk, dups):
    """The batch regime (seeded), and K + 2 exact duplicates of one point,
    whose last copy finds its own index outside its top-(K+1)."""
    rng = np.random.default_rng(n + kk)
    pts = rng.random((n, k), np.float32)
    copies = [10 + 40 * j for j in range(dups)]
    for i in copies[1:]:
        pts[i] = pts[copies[0]]
    gi, gd = _np(tpu_knn_torch.knn_graph(pts, kk, device="cpu"))
    ji, jd = _np(tpu_knn.knn_graph(pts, kk))
    np.testing.assert_array_equal(gi, ji)
    np.testing.assert_allclose(gd, jd, rtol=1e-6, atol=1e-7)
    wi, wd = _gold_graph(pts, kk)
    np.testing.assert_array_equal(gi, wi)
    assert not (gi == np.arange(n)[:, None]).any()
    for i in copies:
        assert list(gi[i]) == [j for j in copies if j != i][:kk]
        assert np.all(gd[i] == 0.0)


def test_knn_graph_validation_and_device():
    pts = np.random.default_rng(1).random((8, 3)).astype(np.float32)
    for bad in (8, 0):
        with pytest.raises(ValueError, match="OTHER"):
            tpu_knn_torch.knn_graph(pts, bad, device="cpu")
    from tpu_knn_torch.distributed.sharded import default_mesh

    mesh = default_mesh(dp=2, sp=2, devices="cpu")
    with pytest.raises(ValueError, match="OTHER"):
        tpu_knn_torch.knn_graph(pts, 8, mesh=mesh)
    for a, b in zip(tpu_knn_torch.knn_graph(pts, 3, mesh=mesh),   # a NumPy set: the mesh's
                    tpu_knn_torch.knn_graph(pts, 3, device="cpu")):
        assert a.device.type == "cpu" and torch.equal(a, b)
    gi, gd = tpu_knn_torch.knn_graph(torch.from_numpy(pts), 7)   # a tensor stays put
    assert gi.shape == (8, 7) and gi.device.type == "cpu" and gi.dtype == torch.int32


def test_within_radius_complete_escalates_past_32_at_m8():
    """50 points within the radius of query 0: cap 32 (the sweep) is
    full, so the cap doubles to 64, which auto resolves to the seeded
    engine at m = 8."""
    rng = np.random.default_rng(92)
    m = 8
    r = rng.random((1200, 3), np.float32) * 10.0
    q = rng.random((m, 3), np.float32)
    r[100:150] = q[0] + rng.normal(0, 0.1, (50, 3)).astype(np.float32)
    got, tiers = _tiers(lambda: _np(pt_topk.within_radius_complete(
        q, r, 0.5, start_cap=32, device="cpu")))
    assert sum(tiers.values()) >= 1
    want = _np(jx_topk.within_radius_complete(q, r, 0.5, start_cap=32))
    assert got[0].shape == want[0].shape == (m, 64)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    D = _d2(q, r)
    for i in range(m):
        assert got[2][i] == int((D[i] <= 0.25).sum()) < 64


# ---- plain kernels against tpu_knn's Pallas builders ---------------------


def _bound_between(s, lo_rank, hi_rank):
    """Per row, the midpoint of the widest gap between consecutive sorted
    scores of ranks lo_rank..hi_rank (no score near it in either f32
    summation order)."""
    srt = np.sort(s, axis=1)[:, :hi_rank + 1]
    j = np.argmax(srt[:, lo_rank + 1:] - srt[:, lo_rank:-1], axis=1) + lo_rank
    rows = np.arange(s.shape[0])
    return ((srt[rows, j] + srt[rows, j + 1]) / 2).astype(np.float32)


@pytest.mark.parametrize("m,n,k,n_ops,depth,banded,n_limit", [
    (16, 3000, 5, 3072, 1, False, None), (16, 3000, 5, 3072, 2, False, None),
    (8, 2000, 7, 2048, 1, True, None), (24, 5000, 16, 5120, 2, False, 2560),
])
def test_b3_plain_matches_pallas(m, n, k, n_ops, depth, banded, n_limit):
    rng = np.random.default_rng(m + n + depth)
    q = rng.random((m, k), np.float32)
    r = rng.random((n, k), np.float32)
    r_op = prep_soa(_t(r), n_ops)
    s = pt_fused.norm_scores(_t(q), r_op, n).numpy()
    lo = _bound_between(s, 3, 30) if banded else None
    tile_n = 512
    mins = jx_fused._build_minima_candidates(m, n, k, 8, tile_n, "highest", n_ops=n_ops,
                                             banded=banded, depth=depth, n_limit=n_limit)
    args = (lo[:, None],) if banded else ()
    r_op_j = jnp.pad(jnp.asarray(r), ((0, n_ops - n), (0, -k % 8))).T
    want = np.asarray(mins(q, (r_op_j,), *args))
    got = pt_fused.minima_candidates(_t(q), r_op, n, depth=depth,
                                     lo=_t(lo) if banded else None, n_limit=n_limit).numpy()
    assert got.shape == want.shape == (m, 128 * depth)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5,
                               atol=1e-5 * np.abs(want[fin]).max())


@pytest.mark.parametrize("m,n,k,n_ops,tile_n,kk,banded", [
    (16, 3000, 5, 3072, 512, 8, False),      # 256-lane cells, quad
    (16, 3000, 5, 3072, 512, 32, False),     # 256-lane cells, cubic
    (8, 2000, 7, 2048, 256, 64, True),       # 128-lane cells, banded + rem
    (8, 1800, 9, 2048, 128, 16, False),      # 64-lane cells, padding columns
    (12, 4000, 6, 4096, 512, 100, True),     # 64-lane cells, cubic band
])
def test_b7_plain_packed_words_equal_pallas(m, n, k, n_ops, tile_n, kk, banded):
    rng = np.random.default_rng(n + kk)
    q = rng.random((m, k), np.float32)
    r = rng.random((n, k), np.float32)
    r[[40, 41, 60, 90]] = q[0]           # a dense cell: the overflow flag
    r_op = prep_soa(_t(r), n_ops)
    s = pt_fused.norm_scores(_t(q), r_op, n).numpy()
    bound = _bound_between(s, 40, 160)
    lo = _bound_between(s, 4, 30) if banded else None
    mom = jx_topk._build_extract_candidates(m, n, k, 8, tile_n, "highest", n_ops=n_ops,
                                            kk=kk, banded=banded, emit_rem=banded)
    args = (lo[:, None],) if banded else ()
    want = [np.asarray(a) for a in mom(q, mom.prep_soa(r), bound[:, None], *args)]
    got = [a.numpy() for a in pt_seeded.extract_moments(
        _t(q), r_op, n, _t(bound), mom.cell, mom.n_fields,
        lo=_t(lo) if banded else None, emit_rem=banded)]
    assert len(got) == len(want)
    for g, w in zip(got[:len(got) - banded], want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    if banded:
        np.testing.assert_allclose(got[-1], want[-1], rtol=1e-5,
                                   atol=1e-5 * np.abs(want[-1][np.isfinite(want[-1])]).max())
    assert (got[0] != 0).any()
    assert ((got[0] >> 30) & 1).any() or banded       # row 0's dense cell


def _engine_count(a, solvable: int):
    """Qualifiers a row's packed B7 words prove, as the seeded engine
    counts them: min(cnt, 3) per cell, solvable + 1 where a cell's
    overflow bit is set."""
    a = np.asarray(a, np.int64)
    return np.where((a >> 30) & 1, solvable + 1, np.minimum(a & 3, solvable)).sum(axis=1)


@pytest.mark.parametrize("planted", [False, True])
@pytest.mark.parametrize("kk", [8, 64])
def test_b3_and_b7_hold_the_uninflated_seeded_bound(kk, planted):
    """The invariant the seeded engine rests on, which the card's B3 and B7
    must keep by scoring every column bit for bit alike: with the bound at
    each row's K-th smallest of B3's lane minima, not inflated, B7 counts
    at least K qualifiers in every row (the K lanes' minima are K distinct
    columns at or under the bound). On uniform data and with K + 2 exact
    copies of a point near query 0 planted in distinct lanes and cells, so
    that row 0's bound is a K-way tie. tpu_knn's B3 and B7 (interpret mode)
    run the same case at their own bound."""
    m, n, k, n_ops, tile_n = 16, 9000, 5, 9216, 512
    rng = np.random.default_rng(kk + planted)
    q = rng.random((m, k), np.float32)
    r = rng.random((n, k), np.float32)
    if planted:
        r[7 + 129 * np.arange(kk + 2)] = q[0] + 1e-3
    mom = jx_topk._build_extract_candidates(m, n, k, 8, tile_n, "highest", n_ops=n_ops,
                                            kk=kk)
    solvable = 2 if mom.n_fields == 4 else 3
    r_op = prep_soa(_t(r), n_ops)
    bound = np.sort(pt_fused.minima_candidates_plain(_t(q), r_op, n).numpy(), axis=1)[:, kk - 1]
    a = pt_seeded.extract_moments_plain(_t(q), r_op, n, _t(bound), mom.cell, mom.n_fields)[0]
    counted = _engine_count(a.numpy(), solvable)
    assert (counted >= kk).all(), counted
    if planted:   # the copies tie at row 0's bound, each in a cell of its own
        assert bound[0] == np.float32(pt_fused.norm_scores(_t(q[:1]), r_op, n)[0, 7])
        assert counted[0] >= kk + 2

    mins = jx_fused._build_minima_candidates(m, n, k, 8, tile_n, "highest", n_ops=n_ops)
    r_op_j = jnp.pad(jnp.asarray(r), ((0, n_ops - n), (0, -k % 8))).T
    jx_bound = np.sort(np.asarray(mins(q, (r_op_j,))), axis=1)[:, kk - 1]
    jx_a = mom(q, mom.prep_soa(r), jx_bound[:, None])[0]
    assert (_engine_count(jx_a, solvable) >= kk).all()


@pytest.mark.parametrize("m,nc,parts,cap,nf,dens", [
    (16, 512, 1, 8, 1, 0.02), (16, 512, 1, 8, 2, 0.08), (12, 1024, 4, 8, 2, 0.02),
    (8, 8192, 1, 48, 2, 0.004), (4, 16384, 1, 16, 2, 0.001), (16, 512, 1, 8, 2, 0.0),
])
def test_compactor_plain_matches_pallas(m, nc, parts, cap, nf, dens):
    """tpu_knn's compactor differential cases, B9's part widths (<= 8192)
    and B8's (16384)."""
    rng = np.random.default_rng(77 + nc + nf)
    qual = rng.random((m, nc)) < dens
    fields = [np.where(qual, rng.integers(1, 1 << 30, (m, nc)), 0).astype(np.int32)]
    for _ in range(nf - 1):
        fields.append(np.where(qual, rng.integers(0, 1 << 26, (m, nc)), 0).astype(np.int32))
    comp = jx_topk._build_cell_compactor(m, nc, parts, cap, nf)
    want = [np.asarray(o) for o in comp(*map(jnp.asarray, fields))]
    got = [o.numpy() for o in pt_seeded.compact_cells(
        [torch.from_numpy(f) for f in fields], parts, cap)]
    assert len(got) == nf + 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---- exact lane recovery against tpu_knn's solver -------------------------


def _legal_cells(cell, solvable):
    """Every legal root multiset of a cell: each set of <= solvable
    distinct lanes, as (c_cnt, e1, p2, p3) and its sorted lanes."""
    rows = []
    for c in range(1, solvable + 1):
        for lanes in itertools.combinations(range(cell), c):
            l = np.array(lanes, np.int64)
            rows.append((c, l.sum(), (l ** 2).sum(), (l ** 3).sum(), lanes))
    cnt, e1, p2, p3 = (np.array([r[i] for r in rows], np.int32)[None] for i in range(4))
    return cnt, e1, p2, p3, [r[4] for r in rows]


def _solve_both(cell, solvable, cnt, e1, p2, p3):
    n = 1 << 20
    cellc = np.full(cnt.shape, 7, np.int32)
    valid = np.ones(cnt.shape, bool)
    solve = jax.jit(lambda *a: jx_topk._solve_cells(*a, cell=cell, n=n, solvable=solvable))
    jc, jok = solve(jnp.asarray(cellc), jnp.asarray(valid), jnp.asarray(cnt),
                    jnp.asarray(e1), jnp.asarray(p2), jnp.asarray(p3))
    pc, pok = pt_seeded._solve_cells(
        torch.from_numpy(cellc), torch.from_numpy(valid), torch.from_numpy(cnt),
        torch.from_numpy(e1), torch.from_numpy(p2), torch.from_numpy(p3),
        cell=cell, n=n, solvable=solvable)
    return (np.asarray(jc), bool(jok)), (pc.numpy(), bool(pok))


@pytest.mark.parametrize("cell,solvable", [(64, 3), (256, 2), (128, 3)])
def test_solve_cells_equals_tpu_knn_on_every_legal_cell(cell, solvable):
    if cell == 128 and solvable == 3:    # 128-lane cubic: a seeded sample
        cnt, e1, p2, p3, lanes = _legal_cells(40, 3)
        shift = np.random.default_rng(3).integers(0, 88)
        e1 = e1 + cnt * shift
        lanes = [tuple(x + shift for x in ls) for ls in lanes]
        p2 = np.array([[sum(x * x for x in ls) for ls in lanes]], np.int32)
        p3 = np.array([[sum(x ** 3 for x in ls) for ls in lanes]], np.int32)
    else:
        cnt, e1, p2, p3, lanes = _legal_cells(cell, solvable)
    (jc, jok), (pc, pok) = _solve_both(cell, solvable, cnt, e1, p2, p3)
    assert jok and pok
    np.testing.assert_array_equal(pc, jc)
    w = cnt.shape[1]
    for i in (0, w // 3, w // 2, w - 1):
        got = sorted(int(pc[0, i + j * w]) - 7 * cell for j in range(solvable)
                     if pc[0, i + j * w] < (1 << 20))
        assert got == sorted(lanes[i])


def test_newton_root_and_certificate_fail_on_illegal_cells():
    """Moments of 4 or 5 lanes claimed as a 3-lane cell (and a corrupt
    sum of squares) must fail the recovery certificate in both packages."""
    rng = np.random.default_rng(9)
    sets = [rng.choice(128, size=rng.integers(4, 6), replace=False) for _ in range(64)]
    cnt = np.full((1, len(sets)), 3, np.int32)
    e1 = np.array([[s.sum() for s in sets]], np.int32)
    p2 = np.array([[(s.astype(np.int64) ** 2).sum() for s in sets]], np.int32)
    p3 = np.array([[(s.astype(np.int64) ** 3).sum() for s in sets]], np.int32)
    for args in ((cnt, e1, p2, p3), (cnt[:, :1], np.array([[244]], np.int32),
                                     np.array([[27487]], np.int32),
                                     np.array([[3240730]], np.int32))):
        (jc, jok), (pc, pok) = _solve_both(128, 3, *args)
        assert not jok and not pok
    # tpu_knn's regression cell (lanes 11, 106, 127) solves exactly.
    (jc, jok), (pc, pok) = _solve_both(128, 3, cnt[:, :1], np.array([[244]], np.int32),
                                       np.array([[27486]], np.int32),
                                       np.array([[3240730]], np.int32))
    assert jok and pok and sorted(pc[0].tolist()) == [7 * 128 + 11, 7 * 128 + 106,
                                                      7 * 128 + 127]
    x = torch.tensor([[3, 0, 255]], dtype=torch.int32)
    for e in range(3):
        r, ok = pt_seeded._newton_max_root(x * 0 + 300, x * 0 + 20000, x * 0 + 9 * e)
        jr, jok = jx_topk._newton_max_root(jnp.full((1, 3), 300, jnp.int32),
                                           jnp.full((1, 3), 20000, jnp.int32),
                                           jnp.full((1, 3), 9 * e, jnp.int32))
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))


@pytest.mark.parametrize("tile_n,cell,nf", [(512, 256, 4), (512, 128, 4), (256, 128, 4),
                                            (512, 256, 8), (512, 128, 8), (2048, 64, 8)])
def test_moment_weights_equal_tpu_knns(tile_n, cell, nf):
    want = np.asarray(jx_topk._moment_weights(tile_n, cell, nf)).astype(np.float32)
    np.testing.assert_array_equal(pt_seeded._moment_weights(tile_n, cell, nf), want)


@pytest.mark.parametrize("k,n,width", [(3, 3000, 3072), (16, 20_000, 20_480), (40, 5000, 5120)])
def test_b3_and_b7_plain_over_a_bf16_operand_are_the_upcast_operands_bit_for_bit(k, n, width):
    """B3's and B7's plain versions over a bf16 store's operand (PAD columns
    planted) equal them over its f32 upcast bit for bit, as their bf16
    instances equal their f32 instances on the card; a PAD column never
    qualifies under a finite bound."""
    rng = np.random.default_rng(k)
    r_op = prep_soa(torch.from_numpy(rng.random((n, k), np.float32)).to(torch.bfloat16), width)
    r_op[:, :64] = torch.tensor(1e30, dtype=torch.bfloat16)
    rf = r_op.float()
    q = _t(rng.random((9, k), np.float32))
    for depth in (1, 2):
        assert torch.equal(pt_fused.minima_candidates(q, r_op, n, depth),
                           pt_fused.minima_candidates(q, rf, n, depth))
    bound = torch.full((9,), 0.2 * k)
    lo = torch.full((9,), 0.05 * k)
    for cell, nf in ((64, 4), (128, 8), (256, 8)):
        got = pt_seeded.extract_moments(q, r_op, n, bound, cell, nf, lo=lo, emit_rem=True)
        want = pt_seeded.extract_moments(q, rf, n, bound, cell, nf, lo=lo, emit_rem=True)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        if cell == 64:
            assert (got[0][:, 0] == 0).all()          # the PAD cell holds no qualifier
