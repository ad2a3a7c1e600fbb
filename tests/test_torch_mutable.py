"""Mutable NNIndex in the port (add / remove / growth / compact), held
against tpu_knn's on the same numpy inputs (after tests/test_index.py's
mutable tests and test_bf16_store.py's).

Both packages run the same sequence; after each step their ids agree and
their queries (1-NN and top-K at m = 1, 4, 40) give the same indices and
d2 (or metric scores) within 1e-5. Empty and removed slots hold PAD_VALUE
and are never reported.
"""

import numpy as np
import pytest
import torch

import tpu_knn_torch
from tpu_knn.engine.index import NNIndex as JaxIndex
from tpu_knn_torch.engine.index import PAD_VALUE

NNIndex = tpu_knn_torch.NNIndex


def _same(got, want, tol=1e-5):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=tol, atol=tol)


def _check_queries(ix, jx, q, live):
    for m in (1, 4, 40):
        got = ix.query(q[:m])
        _same(got, jx.query(q[:m]))
        assert live[got[0].numpy()].all()
        got = ix.query(q[:m], neighbors=8)
        _same(got, jx.query(q[:m], neighbors=8))
        assert live[got[0].numpy()].all()


def _check_layout(ix):
    """Both layouts hold PAD_VALUE (in the stored dtype) in every slot that
    is not live, and the SoA operand in all its k_pad rows."""
    dead = torch.as_tensor(~ix._live)
    pad = torch.tensor(PAD_VALUE, dtype=ix.ref_dev.dtype)
    assert (ix.ref_dev[dead] == pad).all() and (ix.r_ops[0][:, dead] == pad).all()
    assert ix.r_ops[0].shape[1] == ix.ref_dev.shape[0] == ix.capacity


@pytest.mark.parametrize("store,metric", [("float32", "l2"), ("bf16", "l2"),
                                          ("float32", "cosine"), ("float32", "ip")])
def test_mutable_sequence_matches_tpu_knn(store, metric):
    rng = np.random.default_rng(5)
    k = 8
    pts = rng.random((6000, k), np.float32) + 0.1
    q = rng.random((40, k), np.float32) + 0.1
    kwargs = dict(store=store, metric=metric, mutable=True)
    ix, jx = NNIndex(pts[:2000], device="cpu", **kwargs), JaxIndex(pts[:2000], **kwargs)
    assert (ix.capacity, ix.precision, ix.tile_n) == (jx.capacity, jx.precision, jx.tile_n)
    assert ix.ref_dev.dtype == (torch.bfloat16 if store == "bf16" else torch.float32)
    _check_layout(ix)
    _check_queries(ix, jx, q, ix._live)
    # Add: the same ids; points go into the next free slots.
    ids = ix.add(pts[2000:2500] * (3.0 if metric == "cosine" else 1.0))
    np.testing.assert_array_equal(ids, jx.add(pts[2000:2500] * (3.0 if metric == "cosine"
                                                               else 1.0)))
    _check_queries(ix, jx, q, ix._live)
    # Remove, planting the removed points as queries' exact matches.
    gone = rng.choice(2500, 700, replace=False)
    ix.remove(gone)
    jx.remove(gone)
    assert ix.n_live == jx.n_live == 1800
    _check_layout(ix)
    qq = q.copy()
    qq[:3] = pts[gone[:3]]
    _check_queries(ix, jx, qq, ix._live)
    # Grow past capacity once: ids stay, the capacity doubles.
    cap = ix.capacity
    ids = ix.add(pts[2500:2500 + cap])
    np.testing.assert_array_equal(ids, jx.add(pts[2500:2500 + cap]))
    assert ix.capacity == jx.capacity >= 2 * cap
    _check_layout(ix)
    _check_queries(ix, jx, qq, ix._live)
    # Compact: the same id map, the same shrunken capacity.
    mapping = ix.compact()
    np.testing.assert_array_equal(mapping, jx.compact())
    assert (ix.capacity, ix.n_live, ix.n) == (jx.capacity, jx.n_live, jx.n)
    _check_layout(ix)
    _check_queries(ix, jx, qq, ix._live)
    if metric != "ip":
        got, want = ix.query_radius(q[:6], 0.4 if metric == "l2" else 0.999), \
            jx.query_radius(q[:6], 0.4 if metric == "l2" else 0.999)
        _same(got[:2], want[:2])
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_mutable_single_query_routes_and_k_cap():
    """m = 1 takes the AoS engines over the PAD-filled slots; K is capped by
    n_live (tpu_knn's), not by the capacity or the build's n."""
    rng = np.random.default_rng(8)
    pts = rng.random((1500, 4), np.float32)
    ix, jx = NNIndex(pts, mutable=True, device="cpu"), JaxIndex(pts, mutable=True)
    ix.remove(np.arange(1490))
    jx.remove(np.arange(1490))
    q = rng.random((3, 4), np.float32)
    for m in (1, 3):
        _same(ix.query(q[:m]), jx.query(q[:m]))
        _same(ix.query(q[:m], neighbors=10), jx.query(q[:m], neighbors=10))
        assert set(ix.query(q[:m], neighbors=10)[0].numpy().ravel()) <= set(range(1490, 1500))
    for index in (ix, jx):
        with pytest.raises(ValueError, match="n_live"):
            index.query(q, neighbors=11)
    ix.remove(np.arange(1490, 1500))
    with pytest.raises(ValueError, match="no live points"):
        ix.query(q)


def test_mutable_guards_match_tpu_knn():
    rng = np.random.default_rng(9)
    pts = rng.random((1200, 5), np.float32)
    ix = NNIndex(pts, mutable=True, device="cpu")
    assert ix.add(np.empty((0, 5), np.float32)).size == 0
    with pytest.raises(ValueError, match="points must be"):
        ix.add(np.ones((2, 4), np.float32))
    with pytest.raises(ValueError, match="out of range"):
        ix.remove([1200])
    ix.remove([3, 4])
    with pytest.raises(ValueError, match="already removed"):
        ix.remove([4])
    immutable = NNIndex(pts, device="cpu")
    for call in (lambda: immutable.add(pts[:1]), lambda: immutable.remove([0]),
                 immutable.compact):
        with pytest.raises(ValueError, match="immutable"):
            call()
    for strategy in ("auto", "projection"):
        with pytest.raises(ValueError, match="mutable=True requires"):
            NNIndex(pts, strategy=strategy, mutable=True, device="cpu")
    with pytest.raises(ValueError, match="immutable"):
        NNIndex(pts, store="int8", mutable=True, device="cpu")
    with pytest.raises(ValueError, match="pre-split"):
        NNIndex(pts, precision="bf16x3_presplit", mutable=True, device="cpu")
    cos = NNIndex(pts + 0.1, metric="cosine", mutable=True, device="cpu")
    with pytest.raises(ValueError, match="zero vector"):
        cos.add(np.zeros((1, 5), np.float32))
    ip = NNIndex(pts, metric="ip", mutable=True, device="cpu")
    with pytest.raises(ValueError, match="exceeds the build-time"):
        ip.add(np.full((1, 5), 10.0, np.float32))
    assert ip.add(pts[:1] * 0.5).size == 1


def test_mutable_from_state_answers_like_tpu_knn():
    """A tpu_knn mutable index's state after removes (the PAD-filled slots,
    capacity, _n_slots, _live) gives the port an index that answers, adds
    and grows as tpu_knn's."""
    rng = np.random.default_rng(10)
    pts = rng.random((3000, 6), np.float32)
    q = rng.random((40, 6), np.float32)
    for store in ("float32", "bf16"):
        jx = JaxIndex(pts[:1500], store=store, mutable=True)
        jx.remove(rng.choice(1500, 400, replace=False))
        state = {"ref": np.asarray(jx.ref_dev), "r_op": np.asarray(jx.r_ops[0]),
                 "capacity": jx.capacity, "_n_slots": jx._n_slots, "_live": jx._live,
                 "tile_n": jx.tile_n, "n": jx.n}
        ix = NNIndex.from_state(state, device="cpu")
        assert (ix.mutable, ix.store, ix.capacity, ix.precision) == (True, store, jx.capacity,
                                                                     jx.precision)
        _check_queries(ix, jx, q, ix._live)
        np.testing.assert_array_equal(ix.add(pts[1500:]), jx.add(pts[1500:]))
        assert ix.capacity == jx.capacity
        _check_queries(ix, jx, q, ix._live)
        bad = dict(state, _live=~np.asarray(state["_live"]))
        with pytest.raises(ValueError):
            NNIndex.from_state(bad, device="cpu")


@pytest.mark.parametrize("metric", ["cosine", "ip"])
def test_mutable_metric_adds_take_tensors(metric):
    """A metric index transforms added tensor points in torch on their own
    device (NumPy points in tpu_knn's NumPy arithmetic): the same ids, the
    same stored points to f32 rounding, and the same answers as tpu_knn's
    index given the NumPy points; the guards raise for tensors too."""
    rng = np.random.default_rng(11)
    pts = rng.random((1600, 6), np.float32) + 0.1
    q = rng.random((40, 6), np.float32) + 0.1
    ix = NNIndex(pts[:1000], metric=metric, mutable=True, device="cpu")
    jx = JaxIndex(pts[:1000], metric=metric, mutable=True)
    add = pts[1000:1600] * 0.5
    np.testing.assert_array_equal(ix.add(torch.from_numpy(add)), jx.add(add))
    np.testing.assert_allclose(ix.ref_dev.numpy(), np.asarray(jx.ref_dev), rtol=2e-7, atol=2e-7)
    _check_queries(ix, jx, q, ix._live)
    assert ix.add(torch.empty((0, 6))).size == 0
    with pytest.raises(ValueError, match="points must be"):
        ix.add(torch.ones((2, 5)))
    bad = torch.zeros((1, 6)) if metric == "cosine" else torch.full((1, 6), 10.0)
    with pytest.raises(ValueError, match="zero vector" if metric == "cosine" else "exceeds"):
        ix.add(bad)


def test_n_live_is_kept_by_every_update():
    """n_live is a count kept by add, remove (repeated ids count once),
    growth, compact and from_state; it equals tpu_knn's after each step."""
    rng = np.random.default_rng(12)
    pts = rng.random((3000, 4), np.float32)
    ix, jx = NNIndex(pts[:1000], mutable=True, device="cpu"), JaxIndex(pts[:1000], mutable=True)
    steps = [lambda x: x.add(pts[1000:1300]), lambda x: x.remove([5, 5, 6, 1200]),
             lambda x: x.remove(np.arange(100, 400)), lambda x: x.add(pts[1300:3000]),
             lambda x: x.compact()]
    for step in steps:
        step(ix)
        step(jx)
        assert ix.n_live == jx.n_live == int(ix._live.sum())
    state = {"ref": np.asarray(jx.ref_dev), "r_op": np.asarray(jx.r_ops[0]),
             "capacity": jx.capacity, "_n_slots": jx._n_slots, "_live": jx._live,
             "tile_n": jx.tile_n, "n": jx.n}
    assert NNIndex.from_state(state, device="cpu").n_live == jx.n_live
