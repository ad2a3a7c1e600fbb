"""NNIndex's quantized stores (store="bf16", store="int8",
from_int8_grid), the presplit index and from_state of each, held against
tpu_knn's on the same numpy inputs.

bf16: the points are quantized once; every route computes exact f32
diff-form distances over the stored points, so the gate is index equality
with tpu_knn and 0 errors against the oracle over the stored points.
int8: queries run in grid space on q' = (q − z)·inv_s, so the gate is the
grid-space oracle built from the index's own constants (after
tests/test_int8_store.py)."""

import ml_dtypes
import numpy as np
import pytest
import torch

import tpu_knn_torch
from tpu_knn.engine.index import NNIndex as JaxIndex
from tpu_knn.harness.checker import check_results
from tpu_knn.oracle import oracle_knn
from tpu_knn_torch.kernels import smallm, tiers

NNIndex = tpu_knn_torch.NNIndex


def _quantized(ref):
    return ref.astype(ml_dtypes.bfloat16).astype(np.float32)


def _same(got, want, d2_rtol=1e-6):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=d2_rtol, atol=1e-7)


BF16_CASES = [(3, 6000), (16, 6000), (40, 5000), (128, 4500)]


@pytest.mark.parametrize("k,n", BF16_CASES)
def test_bf16_store_matches_tpu_knn(k, n, monkeypatch):
    """Every route over the bf16 store (the AoS scan, B2-bf16, B1's packed
    or qsplit2 tier over the bf16 operand) gives tpu_knn's indices and 0
    errors against the oracle over the stored points."""
    rng = np.random.default_rng(10 + k)
    ref = rng.random((n, k), np.float32)
    ix, jx = NNIndex(ref, store="bf16", device="cpu"), JaxIndex(ref, store="bf16")
    assert ix.ref_dev.dtype == ix.r_ops[0].dtype == torch.bfloat16
    assert (ix.precision, ix.tile_n) == (jx.precision, jx.tile_n)
    np.testing.assert_array_equal(ix.r_ops[0].view(torch.int16).numpy(),
                                  np.asarray(jx.r_ops[0]).view(np.int16))
    b2_calls = []
    monkeypatch.setattr(smallm, "smallm_candidates_plain",
                        lambda q, r_op, *a, f=smallm.smallm_candidates_plain:
                        b2_calls.append(r_op.dtype) or f(q, r_op, *a))
    ref_q = _quantized(ref)
    for m in (1, 2, 4, 16, 64):
        q = rng.random((m, k), np.float32)
        got = ix.query(q)
        _same(got, jx.query(q))
        errors, _ = check_results(oracle_knn(q, ref_q), got[0].numpy(), q, ref_q)
        assert errors == 0
    assert b2_calls == ([torch.bfloat16] * 3 if k == 16 else
                        [torch.bfloat16] * 2 if k == 3 else [])   # m = 1 at k = 3: AoS scan


def test_bf16_store_small_batches_at_b2_bf16s_partition_count(monkeypatch):
    """Past 2^15 + 2^10 points B2-bf16 takes its own partition count
    (smallm.bf16_parts: 264 here, against B2's 313): the prepared m = 2
    and 4 answers stay tpu_knn's, with 0 errors over the stored points."""
    rng = np.random.default_rng(23)
    n, k = 40_000, 16
    ref = rng.random((n, k), np.float32)
    ix, jx = NNIndex(ref, store="bf16", device="cpu"), JaxIndex(ref, store="bf16")
    assert smallm.bf16_parts(n) == 264 and smallm.default_parts(n) == 313
    parts = []
    monkeypatch.setattr(smallm, "smallm_candidates_plain",
                        lambda q, r_op, n_, p, f=smallm.smallm_candidates_plain:
                        parts.append(p) or f(q, r_op, n_, p))
    ref_q = _quantized(ref)
    for m in (2, 4):
        q = rng.random((m, k), np.float32)
        got = ix.query(q)
        _same(got, jx.query(q))
        np.testing.assert_array_equal(got[0].numpy(), oracle_knn(q, ref_q))
    assert parts == [264, 264]


def test_bf16_dense_route_and_tie_rule():
    """A small index takes the dense route; bf16 quantization creates exact
    duplicates and the lowest index wins (after test_bf16_store.py:63)."""
    rng = np.random.default_rng(4)
    ref = rng.random((5_000, 4), np.float32)
    q = rng.random((8, 4), np.float32)
    base = q[2] + 1e-4
    ref[1234] = base
    ref[77] = base + 2e-4 * rng.random(4).astype(np.float32)
    ref_q = _quantized(ref)
    assert (ref_q[77] == ref_q[1234]).all()
    ix, jx = NNIndex(ref, store="bf16", device="cpu"), JaxIndex(ref, store="bf16")
    for sl in (slice(0, 8), slice(2, 3), slice(0, 3)):
        got = ix.query(q[sl])
        _same(got, jx.query(q[sl]))
        np.testing.assert_array_equal(got[0].numpy(), oracle_knn(q[sl], ref_q))
    assert int(ix.query(q)[0][2]) == 77
    small = rng.random((1_000, 5), np.float32)
    qs = rng.random((32, 5), np.float32)
    got = NNIndex(small, store="bf16", device="cpu").query(qs)
    _same(got, JaxIndex(small, store="bf16").query(qs))


def test_qsplit2_keeps_duplicate_ties_at_embedding_width():
    """Bit-identical duplicates at k = 128: qsplit2's selection and the
    exact rerank keep the lowest index (after test_quantized_embed.py:87)."""
    rng = np.random.default_rng(80)
    k, n = 128, 3000
    r = rng.random((n, k), np.float32)
    q = rng.random((8, k), np.float32)
    r[2500] = r[700] = q[3]
    ix = NNIndex(r, store="bf16", device="cpu")
    assert ix.precision == "qsplit2"
    idx, d2 = ix.query(q)
    assert int(idx[3]) == 700
    assert 0.0 <= float(d2[3]) <= k * (2.0 ** -9) ** 2
    _same((idx, d2), JaxIndex(r, store="bf16").query(q))


def _grid_oracle(ix, q):
    g = ix.ref_dev.numpy().astype(np.float32)
    qg = ((q - ix._i8_zero) * np.float32(ix._i8_inv_s)).astype(np.float32)
    return oracle_knn(qg, g), qg, g


@pytest.mark.parametrize("k,n,scale,ms", [(16, 6000, 1.0, (1, 2, 4, 16, 64)),
                                          (8, 7000, 250.0, (1, 64)),
                                          (128, 4500, 1.0, (1, 4, 64))])
def test_int8_store_matches_tpu_knn(k, n, scale, ms):
    """The grid is tpu_knn's bit for bit, the embed constants equal, and
    every route (AoS scan off the grid, dense, the tier over the per-call
    bf16 operand with the rescaled certificate) gives tpu_knn's indices,
    d2 to rtol 1e-6, and the grid-space oracle's winners."""
    rng = np.random.default_rng(20 + k)
    ref = rng.random((n, k), np.float32) * scale - scale / 3
    ix, jx = NNIndex(ref, store="int8", device="cpu"), JaxIndex(ref, store="int8")
    assert ix.ref_dev.dtype == torch.int8 and ix.r_ops is None
    np.testing.assert_array_equal(ix.ref_dev.numpy(), np.asarray(jx.ref_dev))
    np.testing.assert_array_equal(ix._i8_zero, jx._i8_zero)
    assert ix._i8_inv_s == jx._i8_inv_s and ix._i8_s2 == jx._i8_s2
    assert (ix.precision, ix.tile_n) == (jx.precision, jx.tile_n)
    for m in ms:
        q = rng.random((m, k), np.float32) * scale - scale / 3
        got = ix.query(q)
        _same(got, jx.query(q))
        want, qg, g = _grid_oracle(ix, q)
        errors, _ = check_results(want, got[0].numpy(), qg, g)
        assert errors == 0


def test_int8_pipeline_collisions_constant_data_and_rejections():
    rng = np.random.default_rng(9)
    ref = rng.random((6000, 7), np.float32)
    ix = NNIndex(ref, store="int8", device="cpu")
    for m in (1, 64):
        q = rng.random((m, 7), np.float32)
        run, ops = ix.pipeline(m)
        pi, pd = run(q, *ops)
        qi, qd = ix.query(q)
        assert torch.equal(pi, qi)
        np.testing.assert_allclose(pd.numpy(), qd.numpy(), rtol=1e-6)
    # Grid collisions: the lowest index wins on every route.
    ref = rng.random((5_000, 4), np.float32)
    q = rng.random((8, 4), np.float32)
    base = np.clip(q[2] + 1e-4, 0, 1).astype(np.float32)
    ref[1234] = base
    ref[77] = np.clip(base + 3e-4 * rng.random(4).astype(np.float32), 0, 1)
    ix = NNIndex(ref, store="int8", device="cpu")
    assert (ix.ref_dev[77] == ix.ref_dev[1234]).all()
    for sl in (slice(0, 8), slice(2, 3)):
        np.testing.assert_array_equal(ix.query(q[sl])[0].numpy(), _grid_oracle(ix, q[sl])[0])
    assert int(ix.query(q)[0][2]) == 77
    # Constant data: the step falls back to 1 and index 0 wins.
    flat = NNIndex(np.full((256, 4), 3.25, np.float32), store="int8", device="cpu")
    assert float(flat._i8_inv_s) == 1.0
    np.testing.assert_array_equal(flat.query(q[:4])[0].numpy(), np.zeros(4, np.int32))
    with pytest.raises(ValueError, match="immutable"):
        NNIndex(ref, store="int8", mutable=True, device="cpu")
    for strategy in ("auto", "projection", "kdtree"):
        with pytest.raises(ValueError, match="strategy='fused'"):
            NNIndex(ref, store="int8", strategy=strategy, device="cpu")
    with pytest.raises(ValueError, match="strategy='fused'"):
        NNIndex(ref, store="bf16", strategy="auto", device="cpu")
    with pytest.raises(ValueError, match="store='float32'"):
        NNIndex(ref, store="int8", metric="cosine", device="cpu")


def test_from_int8_grid_matches_the_constructor_and_tpu_knn():
    rng = np.random.default_rng(12)
    ref = rng.random((6_000, 5), np.float32) * 12.0 - 3.0
    ix = NNIndex(ref, store="int8", device="cpu")
    s = float(np.float32(1.0 / np.float64(ix._i8_inv_s)))
    grid = ix.ref_dev.numpy()
    ix2 = NNIndex.from_int8_grid(grid, ix._i8_zero, s, device="cpu")
    jx2 = JaxIndex.from_int8_grid(grid, ix._i8_zero, s)
    assert ix2.store == "int8" and ix2.r_ops is None and ix2._i8_inv_s == ix._i8_inv_s
    assert (ix2.precision, ix2.tile_n) == (jx2.precision, jx2.tile_n)
    for m in (3, 16):
        q = rng.random((m, 5), np.float32) * 12.0 - 3.0
        a, b = ix.query(q), ix2.query(q)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        _same(b, jx2.query(q))
    with pytest.raises(ValueError, match="int8"):
        NNIndex.from_int8_grid(ref, ix._i8_zero, s, device="cpu")
    with pytest.raises(ValueError, match="positive"):
        NNIndex.from_int8_grid(grid, ix._i8_zero, 0.0, device="cpu")
    with pytest.raises(ValueError, match="zero must be"):
        NNIndex.from_int8_grid(grid, np.zeros(3, np.float32), s, device="cpu")
    with pytest.raises(ValueError, match="mesh="):
        NNIndex.from_int8_grid(grid, ix._i8_zero, s, mesh=object(), device="cpu")


@pytest.mark.parametrize("m", [1, 4, 64])
def test_presplit_index_takes_b12_at_every_m(m, monkeypatch):
    """precision="bf16x3_presplit" keeps (hi, lo, ‖r‖²) as its operands and
    (tpu_knn's len(r_ops) == 1 condition) answers every m through B12."""
    rng = np.random.default_rng(m)
    ref = rng.random((4500, 16), np.float32)
    ix = NNIndex(ref, precision="bf16x3_presplit", device="cpu")
    jx = JaxIndex(ref, precision="bf16x3_presplit")
    assert len(ix.r_ops) == 3 and ix.tile_n == jx.tile_n
    calls = []
    monkeypatch.setattr(tiers, "presplit_candidates_plain",
                        lambda *a, f=tiers.presplit_candidates_plain: calls.append(1) or f(*a))
    q = rng.random((m, 16), np.float32)
    _same(ix.query(q), jx.query(q))
    assert calls == [1]
    np.testing.assert_array_equal(ix.query(q)[0].numpy(), oracle_knn(q, ref))


def test_topk_over_stores_raises():
    """Top-K and radius over the bf16 and int8 stores are served (tpu_knn's
    answers); over a presplit index, f32 or beside the bf16 store, they
    raise tpu_knn's ValueError (tpu_knn serves no top-K there either); the
    presplit tier beside a quantized store is served (A.6.6)."""
    r = np.random.default_rng(2).random((3000, 8), np.float32)
    for store in ("bf16", "int8"):
        ix, jx = NNIndex(r, store=store, device="cpu"), JaxIndex(r, store=store)
        _same(ix.query(r[:4], neighbors=3), jx.query(r[:4], neighbors=3), d2_rtol=1e-5)
        got, want = ix.query_radius(r[:4], 0.1), jx.query_radius(r[:4], 0.1)
        _same(got[:2], want[:2], d2_rtol=1e-5)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    ix = NNIndex(r, device="cpu", precision="bf16x3_presplit")
    for index in (ix, JaxIndex(r, precision="bf16x3_presplit")):
        with pytest.raises(ValueError, match="neighbors>1 requires"):
            index.query(r[:4], neighbors=3)
        with pytest.raises(ValueError, match="neighbors>1 requires"):
            index.query_radius(r[:4], 0.1)
    for store in ("bf16", "int8"):
        ix = NNIndex(r, store=store, precision="bf16x3_presplit", device="cpu")
        assert ix.precision == "bf16x3_presplit"
        _same(ix.query(r[:40]), JaxIndex(r, store=store).query(r[:40]), d2_rtol=1e-5)
    for index in (NNIndex(r, store="bf16", precision="bf16x3_presplit", device="cpu"),
                  JaxIndex(r, store="bf16", precision="bf16x3_presplit")):
        with pytest.raises(ValueError, match="neighbors>1 requires"):
            index.query(r[:4], neighbors=3)


@pytest.fixture(scope="module")
def jax_indexes():
    rng = np.random.default_rng(31)
    r = rng.random((4500, 16), np.float32)
    r[4499] = r[17]
    return r, {"bf16": JaxIndex(r, store="bf16"),
               "presplit": JaxIndex(r, precision="bf16x3_presplit"),
               "int8": JaxIndex(r, store="int8")}


def _state(kind, jx):
    if kind == "int8":
        return {"grid": np.asarray(jx.ref_dev), "zero": jx._i8_zero, "inv_s": jx._i8_inv_s}
    if kind == "presplit":
        return {"ref": np.asarray(jx.ref_dev), "r_ops": tuple(np.asarray(a) for a in jx.r_ops)}
    return {"ref": np.asarray(jx.ref_dev), "r_op": np.asarray(jx.r_ops[0])}


@pytest.mark.parametrize("kind", ["bf16", "presplit", "int8"])
def test_from_state_answers_like_tpu_knn(jax_indexes, kind):
    r, indexes = jax_indexes
    jx = indexes[kind]
    ix = NNIndex.from_state(_state(kind, jx), device="cpu")
    assert (ix.store, ix.precision) == (jx.store, jx.precision)
    rng = np.random.default_rng(len(kind))
    for m in (1, 4, 40):
        q = rng.random((m, 16), np.float32)
        q[0] = r[17]
        _same(ix.query(q), jx.query(q))


@pytest.mark.parametrize("kind", ["bf16", "presplit", "int8"])
def test_from_state_rejects_a_foreign_layout(jax_indexes, kind):
    r, indexes = jax_indexes
    state = _state(kind, indexes[kind])
    if kind == "bf16":
        bad = dict(state, r_op=state["r_op"].copy())
        bad["r_op"][3, 10] = bad["r_op"][3, 11] + np.float32(1.0)
        with pytest.raises(ValueError, match="transpose"):
            NNIndex.from_state(bad, device="cpu")
        with pytest.raises(ValueError, match="bfloat16"):
            NNIndex.from_state(dict(state, r_op=state["r_op"].astype(np.float32)),
                               device="cpu")
    elif kind == "presplit":
        hi, lo, rn = (a.copy() for a in state["r_ops"])
        lo[2, 5] = hi[2, 5]
        with pytest.raises(ValueError, match="split"):
            NNIndex.from_state(dict(state, r_ops=(state["r_ops"][0], lo, rn)), device="cpu")
        with pytest.raises(ValueError, match="norm"):
            NNIndex.from_state(dict(state, r_ops=(*state["r_ops"][:2], rn * 1.01)),
                               device="cpu")
    else:
        with pytest.raises(ValueError, match="int8"):
            NNIndex.from_state(dict(state, grid=state["grid"].astype(np.int16)), device="cpu")
        with pytest.raises(ValueError, match="inv_s"):
            NNIndex.from_state(dict(state, inv_s=-1.0), device="cpu")
        with pytest.raises(ValueError, match="zero"):
            NNIndex.from_state(dict(state, zero=state["zero"][:3]), device="cpu")


@pytest.fixture
def operand_spy(monkeypatch):
    """Records (kernel, operand dtype) of every candidate-kernel call: the
    wrappers take their plain versions on the CPU, so the spy sits there."""
    from tpu_knn_torch.kernels import fused, seeded, topk

    calls = []
    for mod, name, kid in ((topk, "sweep_candidates_plain", "B5"),
                           (topk, "smallm_topk_candidates_plain", "B6"),
                           (smallm, "smallm_candidates_plain", "B2"),
                           (fused, "banded_candidates_plain", "B4"),
                           (fused, "minima_candidates_plain", "B3"),
                           (seeded, "extract_moments_plain", "B7")):
        monkeypatch.setattr(mod, name, lambda q, r_op, *a, f=getattr(mod, name), kid=kid, **kw:
                            calls.append((kid, r_op.dtype)) or f(q, r_op, *a, **kw))
    return calls


def _oracle_topk(q, pts, kk):
    d = ((q[:, None, :] - pts[None, :, :]) ** 2).sum(-1, dtype=np.float32)
    return np.argsort(d, axis=1, kind="stable")[:, :kk]


@pytest.mark.parametrize("m,kk,engines", [(1, 16, set()), (4, 8, {"B2", "B6"}),
                                          (16, 8, {"B5"}), (64, 24, {"B3", "B7"})])
def test_bf16_store_topk_hands_the_engines_its_bf16_operand(m, kk, engines, operand_spy):
    """Top-K over a bf16 store: m = 1 the AoS engine off the bf16 points,
    m >= 2 the sweep (B2 + B6, or B5) and seeded (B3 + B7) engines over the
    store's bf16 operand itself, never an f32 copy; tpu_knn's indices, and
    the oracle's over the stored points."""
    rng = np.random.default_rng(40 + m)
    ref = rng.random((6000, 16), np.float32)
    ix, jx = NNIndex(ref, store="bf16", device="cpu"), JaxIndex(ref, store="bf16")
    q = rng.random((m, 16), np.float32)
    got = ix.query(q, neighbors=kk)
    _same(got, jx.query(q, neighbors=kk), d2_rtol=1e-5)
    np.testing.assert_array_equal(got[0].numpy(), _oracle_topk(q, _quantized(ref), kk))
    assert {kid for kid, _ in operand_spy} == engines
    assert all(dtype == torch.bfloat16 for _, dtype in operand_spy)


@pytest.mark.parametrize("m,kk", [(1, 16), (4, 8), (64, 8), (16, 40)])
def test_int8_store_topk_matches_tpu_knn(m, kk, operand_spy):
    """Top-K over the int8 store: m = 1 the AoS engine off the int8 grid,
    m >= 2 the engines over the per-call bf16 grid operand (tpu_knn's); d2
    rescaled by s², the grid-space oracle's indices."""
    rng = np.random.default_rng(50 + m)
    ref = rng.random((6000, 8), np.float32) * 4.0 - 1.0
    ix, jx = NNIndex(ref, store="int8", device="cpu"), JaxIndex(ref, store="int8")
    q = rng.random((m, 8), np.float32) * 4.0 - 1.0
    got = ix.query(q, neighbors=kk)
    _same(got, jx.query(q, neighbors=kk), d2_rtol=1e-5)
    _, qg, g = _grid_oracle(ix, q)
    np.testing.assert_array_equal(got[0].numpy(), _oracle_topk(qg, g, kk))
    assert bool(operand_spy) == (m > 1)
    assert all(dtype == torch.bfloat16 for _, dtype in operand_spy)


@pytest.mark.parametrize("store", ["bf16", "int8"])
def test_store_radius_escalates_like_tpu_knn(store):
    """query_radius over a quantized store: the escalating and the capped
    forms give tpu_knn's rows and counts (int8: in user units)."""
    rng = np.random.default_rng(60)
    ref = rng.random((5000, 4), np.float32)
    q = rng.random((8, 4), np.float32)
    ref[100:140] = q[0] + 0.02 * (rng.random((40, 4), np.float32) - 0.5)  # 40 near q[0]
    ix, jx = NNIndex(ref, store=store, device="cpu"), JaxIndex(ref, store=store)
    for radius, cap in ((0.1, 5), (0.1, None)):
        got, want = ix.query_radius(q, radius, cap), jx.query_radius(q, radius, cap)
        _same(got[:2], want[:2], d2_rtol=1e-5)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert int(got[2][0]) >= 40 and got[0].shape[1] > 32   # the cap escalated past 32


# ---- A.6.6: the presplit tier beside the quantized stores and "auto" -------


def test_presplit_operands_over_the_bf16_store_are_tpu_knns():
    """B12's operands over a bf16 store: hi is the stored values and lo 0,
    bit for bit tpu_knn's prep_soa over its bf16 array; ‖r‖² is the f32
    norm of the stored points, where tpu_knn's row is bf16: its values are
    within bf16 rounding of ours (2^-7 relative covers the per-term bf16
    products and the final rounding; ROADMAP C)."""
    rng = np.random.default_rng(66)
    ref = rng.random((3000, 40), np.float32)
    ix = NNIndex(ref, store="bf16", precision="bf16x3_presplit", device="cpu")
    jx = JaxIndex(ref, store="bf16", precision="bf16x3_presplit")
    hi, lo, rn = ix.r_ops
    jhi, jlo, jrn = (np.asarray(a) for a in jx.r_ops)
    assert ix.tile_n == jx.tile_n and hi.shape == jhi.shape and rn.shape == jrn.shape
    np.testing.assert_array_equal(hi.view(torch.int16).numpy(), jhi.view(np.int16))
    np.testing.assert_array_equal(lo.view(torch.int16).numpy(), jlo.view(np.int16))
    assert not lo.float().any() and rn.dtype == torch.float32
    pts = _quantized(ref).astype(np.float64)
    np.testing.assert_allclose(rn[0, :3000].numpy(), (pts ** 2).sum(axis=1), rtol=1e-6)
    np.testing.assert_allclose(jrn.astype(np.float32)[0], rn[0].numpy(), rtol=2.0 ** -7)


@pytest.mark.parametrize("store,k", [("bf16", 3), ("bf16", 40), ("int8", 8), ("int8", 40)])
def test_presplit_beside_a_store_answers_every_m(store, k, monkeypatch):
    """B12 serves every batch of a bf16 store (hi = the stored values), the
    int8 store's batches over the split of its per-call grid operand (m <=
    4 stays on the AoS scan off the grid, as in tpu_knn); answers are exact
    over the stored points: tpu_knn's store index's indices, 0 oracle
    errors over the stored (grid) points."""
    rng = np.random.default_rng(70 + k)
    ref = rng.random((5000, k), np.float32)    # past the dense route's n
    ref[4999] = ref[17]
    ix = NNIndex(ref, store=store, precision="bf16x3_presplit", device="cpu")
    jx = JaxIndex(ref, store=store)
    jp = JaxIndex(ref, store=store, precision="bf16x3_presplit")
    assert ix.tile_n == jp.tile_n
    calls = []
    monkeypatch.setattr(tiers, "presplit_candidates_plain",
                        lambda *a, f=tiers.presplit_candidates_plain: calls.append(1) or f(*a))
    for m in (1, 4, 64):
        q = rng.random((m, k), np.float32)
        q[0] = ref[17]
        before = len(calls)
        got = ix.query(q)
        _same(got, jx.query(q), d2_rtol=1e-5)
        assert len(calls) - before == (1 if store == "bf16" or m > 4 else 0)
        if store == "bf16":
            errors, _ = check_results(oracle_knn(q, _quantized(ref)), got[0].numpy(), q,
                                      _quantized(ref))
        else:
            want, qg, g = _grid_oracle(ix, q)
            errors, _ = check_results(want, got[0].numpy(), qg, g)
        assert errors == 0 and int(got[0][0]) == 17


def test_int8_presplit_topk_takes_the_plain_grid_operand():
    """Top-K over an int8 presplit index: m = 1 is tpu_knn's AoS engine off
    the grid (its answers); m >= 2 takes the plain per-call grid operand,
    where tpu_knn hands its engines B12's three operands and fails (ROADMAP
    C), so those answers are tpu_knn's int8 index's at its default tier."""
    rng = np.random.default_rng(8)
    ref = rng.random((3000, 8), np.float32)
    ix = NNIndex(ref, store="int8", precision="bf16x3_presplit", device="cpu")
    jp = JaxIndex(ref, store="int8", precision="bf16x3_presplit")
    jx = JaxIndex(ref, store="int8")
    q = rng.random((8, 8), np.float32)
    _same(ix.query(q[:1], neighbors=5), jp.query(q[:1], neighbors=5), d2_rtol=1e-5)
    _same(ix.query(q, neighbors=5), jx.query(q, neighbors=5), d2_rtol=1e-5)
    with pytest.raises(ValueError, match="too many values"):
        jp.query(q, neighbors=5)
    got, want = ix.query_radius(q, 0.3), jx.query_radius(q, 0.3)
    _same(got[:2], want[:2], d2_rtol=1e-5)


def test_auto_with_presplit_probes_and_routes_like_tpu_knn():
    """strategy="auto" with the presplit tier: B12's operands, tpu_knn's
    probe (the same certification rate) and routing (last_strategy); the
    projection route's fallback prepares its own plain operand."""
    rng = np.random.default_rng(3)
    ref = rng.random((1 << 14, 3), np.float32)
    ix = NNIndex(ref, strategy="auto", precision="bf16x3_presplit", device="cpu")
    jx = JaxIndex(ref, strategy="auto", precision="bf16x3_presplit")
    assert len(ix.r_ops) == 3 and ix.cert_rate == jx.cert_rate
    assert (ix.proj_index is None) == (jx.proj_index is None)
    for m in (1, 4, 16, 64):
        q = rng.random((m, 3), np.float32)
        _same(ix.query(q), jx.query(q))
        assert ix.last_strategy == jx.last_strategy
        np.testing.assert_array_equal(ix.query(q)[0].numpy(), oracle_knn(q, ref))
    with pytest.raises(ValueError, match="neighbors>1 requires"):
        ix.query(q, neighbors=2)
