"""The KD-tree slice (v9, v10, NNIndex(strategy="kdtree")) against tpu_knn's,
on the CPU, on the same seeded numpy inputs.

The host build and queries are the same native source in both packages
(each its own copy, built by g++), so trees are identical and 1-NN and
top-K answers equal bit for bit (indices and d2). The port's v10 runs its
plain batched traversal here (the kernel's arithmetic: d2 a multiply and
an add per coordinate in order), so its d2 equal the native query's bit
for bit; tpu_knn's v10 sums with jnp.sum, so its d2 are held within 1e-6
relative. Every answer is also held to the oracle: ties go to the lowest
index, exactly."""

import numpy as np
import pytest
import torch

import tpu_knn
import tpu_knn_torch
from tpu_knn import native as tk_native
from tpu_knn.engine.index import NNIndex as JaxIndex
from tpu_knn.kdtree import build as tk_build
from tpu_knn.kdtree.traversal import DeviceKDTree as JaxDeviceKDTree
from tpu_knn.oracle import oracle_knn
from tpu_knn_torch import native
from tpu_knn_torch.engine.registry import best_available_version, get_version
from tpu_knn_torch.kdtree import build, traversal
from tpu_knn_torch.kdtree.build import KDTree, build_kdtree, query_numpy

NNIndex = tpu_knn_torch.NNIndex


def _planted(k, n, m, seed, grid=False):
    """Points and queries with exact duplicates, points on split planes
    (a coarse grid shares coordinates along every axis) and queries equal
    to a point."""
    rng = np.random.default_rng(seed)
    if grid:
        r = rng.integers(0, 6, (n, k)).astype(np.float32) * 0.25
        q = rng.integers(0, 12, (m, k)).astype(np.float32) * 0.125
    else:
        r = rng.random((n, k), np.float32)
        q = rng.random((m, k), np.float32)
    if n > 3:
        r[n // 2] = r[3]
        r[n - 1] = r[3]
        q[0] = r[3]             # equal to three points: the lowest index wins
    q[1] = r[n // 3]
    return r, q


CASES = [(3, 5000, 64, False), (3, 3000, 64, True), (8, 4000, 48, False),
         (16, 2000, 32, False), (1, 1000, 40, True), (5, 1, 8, False)]


def test_tpu_knn_native_library_is_available():
    """The comparisons below need tpu_knn's own native build (its
    build_kdtree falls back to NumPy without it)."""
    assert tk_native.available(), tk_native.load_error()


@pytest.mark.parametrize("k,n,m,grid", CASES)
def test_native_build_is_tpu_knns(k, n, m, grid):
    r, _ = _planted(k, n, m, seed=k * 7 + n, grid=grid)
    got, want = build_kdtree(r), tk_build.build_kdtree(r)
    for name in ("p", "dim", "split_val"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got.p.shape == (4 * n,)


@pytest.mark.parametrize("k,n,m,grid", CASES[:4])
def test_numpy_build_and_query_are_exact(k, n, m, grid):
    """The plain build is tpu_knn's plain build; query_numpy over it and
    over the native tree is exact and gives the native query's d2."""
    r, q = _planted(k, n, m, seed=k + n, grid=grid)
    p, dim = build._build_numpy(r)
    tp, tdim = tk_build._build_numpy(r)
    assert np.array_equal(p, tp) and np.array_equal(dim, tdim)
    plain = KDTree(ref=r, p=p, dim=dim, split_val=build._split_values(r, p, dim))
    want = oracle_knn(q, r)
    tree = build_kdtree(r)
    _, nd2 = native.kdtree_query(q, r, tree.p, tree.dim)
    for t in (plain, tree):
        idx, d2 = query_numpy(t, q)
        np.testing.assert_array_equal(idx, want)
        np.testing.assert_array_equal(d2, nd2)


@pytest.mark.parametrize("k,n,m,grid", CASES)
def test_v9_and_plain_v10_match_tpu_knn_and_the_oracle(k, n, m, grid):
    r, q = _planted(k, n, m, seed=3 * k + n, grid=grid)
    want = oracle_knn(q, r)
    tree = build_kdtree(r)
    i9, d9 = native.kdtree_query(q, r, tree.p, tree.dim)
    ti9, td9 = tk_native.kdtree_query(q, r, tree.p, tree.dim)
    np.testing.assert_array_equal(i9, want)
    np.testing.assert_array_equal(i9, ti9)
    np.testing.assert_array_equal(d9, td9)
    dev = traversal.DeviceKDTree(tree, "cpu")
    i10, d10, visits, nodes = traversal.traverse_plain(
        torch.from_numpy(q), dev.ref, dev.p, dev.dim, dev.split_val, count_visits=True)
    np.testing.assert_array_equal(i10.numpy(), want)
    np.testing.assert_array_equal(d10.numpy(), d9)       # bit for bit
    assert m <= visits <= m * n
    assert 1 <= nodes <= min(visits, n)
    ji, jd = JaxDeviceKDTree(tk_build.build_kdtree(r)).query(q)
    np.testing.assert_array_equal(i10.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d10.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-7)
    for v in ("v9", "v10"):
        got = tpu_knn_torch.nearest_neighbors(q, r, version=v, device="cpu")
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, tpu_knn.nearest_neighbors(q, r, version=v))
    if n > 3:   # query 0 equals r[3]: the lowest index of its equals wins
        assert int(want[0]) == int(np.flatnonzero((r == q[0]).all(axis=1)).min())


def test_kdtree_traverse_checks_its_inputs():
    r, q = _planted(3, 500, 8, seed=5)
    dev = traversal.DeviceKDTree(build_kdtree(r), "cpu")
    qt = torch.from_numpy(q)
    with pytest.raises(ValueError, match="p must be"):
        traversal.kdtree_traverse(qt, dev.ref, dev.p.long(), dev.dim, dev.split_val)
    with pytest.raises(ValueError, match="share k"):
        traversal.kdtree_traverse(qt[:, :2], dev.ref, dev.p, dev.dim, dev.split_val)
    with pytest.raises(ValueError, match="split_val must be"):
        traversal.kdtree_traverse(qt, dev.ref, dev.p, dev.dim, dev.split_val[:-1])
    before = traversal.kdtree_traverse.launches
    idx, _ = traversal.kdtree_traverse(qt, dev.ref, dev.p, dev.dim, dev.split_val)
    np.testing.assert_array_equal(idx.numpy(), oracle_knn(q, r))
    assert traversal.kdtree_traverse.launches == before   # the plain version is not counted


def test_k_guards(monkeypatch):
    """v9 guards k <= 16 (fallback v0), as tpu_knn; v10 keeps the
    reference's k <= 16 (core.cu:1177-1178, fallback v9) where tpu_knn cut
    at k <= 8: at k = 12 the port traverses, tpu_knn delegates to v9."""
    v9, v10 = get_version("v9"), get_version("v10")
    tv9, tv10 = tpu_knn.get_version("v9"), tpu_knn.get_version("v10")
    for k in (1, 8, 16, 17):
        assert v9.guard(k, 4, 100) == tv9.guard(k, 4, 100) == (k <= 16)
        assert v10.guard(k, 4, 100) == (k <= 16)
    assert tv10.guard(12, 4, 100) is False and v10.guard(12, 4, 100) is True
    assert (v9.fallback, v10.fallback) == ("v0", "v9")
    for k in (12, 17):
        r, q = _planted(k, 1500, 16, seed=k)
        calls = []
        monkeypatch.setattr(traversal, "traverse_plain",
                            lambda *a, f=traversal.traverse_plain: calls.append(1) or f(*a))
        got = tpu_knn_torch.nearest_neighbors(q, r, version="v10", device="cpu")
        monkeypatch.undo()
        np.testing.assert_array_equal(got, oracle_knn(q, r))
        assert bool(calls) == (k <= 16)


def test_v10_is_never_selected_by_dispatch():
    """tpu_knn's rule (test_v10_never_selected_by_dispatch): dispatch never
    reaches the tree versions; the port's best is v8, whose guard hands one
    device (here the CPU, no card) to v7, as tpu_knn's does."""
    from tpu_knn.engine.registry import PREFERENCE_ORDER as TK_ORDER
    from tpu_knn_torch.engine.registry import PREFERENCE_ORDER

    best = best_available_version()
    assert best.name == "v8" and best.fallback == "v7"
    if torch.cuda.device_count() < 2:
        assert not best.guard(3, 1024, 1 << 20)
    r, q = _planted(3, 1500, 8, seed=3)
    np.testing.assert_array_equal(tpu_knn_torch.nearest_neighbors(q, r, device="cpu"),
                                  oracle_knn(q, r))
    assert PREFERENCE_ORDER == TK_ORDER
    assert "v9" not in PREFERENCE_ORDER and "v10" not in PREFERENCE_ORDER


@pytest.mark.parametrize("k,n", [(3, 4000), (16, 3000), (20, 2500)])
def test_kdtree_index_matches_tpu_knns(k, n):
    """1-NN, top-K (kdt2 at K <= 128, the reference-format tree above it
    and at k > 16) and radius, as tensors on the index's device."""
    r, q = _planted(k, n, 24, seed=11 * k, grid=k == 3)
    ix, jx = NNIndex(r, strategy="kdtree", device="cpu"), JaxIndex(r, strategy="kdtree")
    assert (ix._kdt2 is not None) == (k <= 16) == (jx._kdt2 is not None)
    assert ix.dev_tree is None and jx.dev_tree is None
    assert ix._tree is None and ix.precision == jx.precision
    for m in (1, 4, 24):
        got, want = ix.query(q[:m]), jx.query(q[:m])
        assert isinstance(got[0], torch.Tensor) and got[0].device.type == "cpu"
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        np.testing.assert_array_equal(got[1].numpy(), want[1])
        np.testing.assert_array_equal(got[0].numpy(), oracle_knn(q[:m], r))
        for kk in (1, 8, 129):
            gt, wt = ix.query(q[:m], neighbors=kk), jx.query(q[:m], neighbors=kk)
            assert gt[0].shape == (m, kk)
            np.testing.assert_array_equal(gt[0].numpy(), wt[0])
            np.testing.assert_array_equal(gt[1].numpy(), wt[1])
    got, want = ix.query_radius(q[:6], 0.3), jx.query_radius(q[:6], 0.3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = ix.query_radius(q[:6], 0.3, max_results=5)
    want = jx.query_radius(q[:6], 0.3, max_results=5)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="neighbors must be"):
        ix.query(q[:2], neighbors=n + 1)
    with pytest.raises(ValueError, match="queries must be"):
        ix.query(q[:2, :-1])
    with pytest.raises(ValueError, match="pipeline"):
        ix.pipeline(4)
    assert ix.tree.p.shape == (4 * n,)        # built on first use
    np.testing.assert_array_equal(ix.tree.p, jx.tree.p)


def test_kdtree_index_takes_a_tensor_and_rejects_what_tpu_knn_rejects():
    r, q = _planted(4, 2000, 8, seed=3)
    ix = NNIndex(torch.from_numpy(r), strategy="kdtree")    # a tensor runs where it is
    assert ix.device.type == "cpu"
    np.testing.assert_array_equal(ix.query(torch.from_numpy(q))[0].numpy(), oracle_knn(q, r))
    for kw in ({"mutable": True}, {"store": "bf16"}, {"metric": "cosine"}):
        with pytest.raises(ValueError):
            NNIndex(r, strategy="kdtree", device="cpu", **kw)
        with pytest.raises(ValueError):
            JaxIndex(r, strategy="kdtree", **kw)
    with pytest.raises(ValueError, match="filtered_view"):
        ix.filtered_view(np.ones(2000, bool))


def test_kdtree_file_crosses_both_ways(tmp_path):
    r, q = _planted(3, 3000, 16, seed=21)
    tree = build_kdtree(r)
    tree.save(str(tmp_path / "port_tree.npz"))
    theirs = tk_build.KDTree.load(str(tmp_path / "port_tree.npz"))
    tk_build.build_kdtree(r).save(str(tmp_path / "tk_tree.npz"))
    mine = KDTree.load(str(tmp_path / "tk_tree.npz"))
    for name in ("ref", "p", "dim", "split_val"):
        assert np.array_equal(getattr(theirs, name), getattr(tree, name))
        assert np.array_equal(getattr(mine, name), getattr(tree, name))
    ix, jx = NNIndex(r, strategy="kdtree", device="cpu"), JaxIndex(r, strategy="kdtree")
    ix.save(str(tmp_path / "port_ix"))
    jx.save(str(tmp_path / "tk_ix"))
    for mine, theirs in ((NNIndex.load(str(tmp_path / "tk_ix.npz"), device="cpu"),
                          JaxIndex.load(str(tmp_path / "port_ix.npz"))),):
        assert mine.strategy == theirs.strategy == "kdtree"
        assert mine._tree is not None and mine._kdt2 is None      # restored, not rebuilt
        np.testing.assert_array_equal(mine.tree.p, tree.p)
        np.testing.assert_array_equal(theirs.tree.p, tree.p)
        for kk in (None, 8):
            a, b = mine.query(q, neighbors=kk), theirs.query(q, neighbors=kk)
            np.testing.assert_array_equal(a[0].numpy(), b[0])
            np.testing.assert_array_equal(a[1].numpy(), b[1])
        assert mine._kdt2 is not None                               # rebuilt at the first query


def test_kdt2_and_the_wrapper_check_their_inputs():
    r, q = _planted(17, 300, 4, seed=1)
    with pytest.raises(ValueError, match="kdt2 supports"):
        native.Kdt2Index(r)
    t = native.Kdt2Index(r[:, :8])
    assert t.depth >= 1
    with pytest.raises(ValueError, match="queries must be"):
        t.query(q)
    with pytest.raises(ValueError, match="kdt2 top-K"):
        t.query_topk(q[:, :8], native.KDT2_TOPK_MAX + 1)
    tree = build_kdtree(r)
    with pytest.raises(ValueError, match="p and dim"):
        native.kdtree_query(q, r, tree.p[:-1], tree.dim)
    assert (native.KDT2_MAX_K, native.KDT2_TOPK_MAX) == (tk_native.KDT2_MAX_K,
                                                           tk_native.KDT2_TOPK_MAX)


def test_a_failed_native_build_raises(monkeypatch, tmp_path):
    """No fallback: one flag set, tpu_knn's (OpenMP included), and a compiler
    that fails raises with its message."""
    from tpu_knn_torch.native import build as nb
    import tpu_knn.native.build as tk_build

    assert nb.CXXFLAGS == tk_build.CXXFLAGS
    monkeypatch.setattr(nb, "CXX", "false")
    monkeypatch.setattr(nb, "BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="native KD-tree build failed"):
        nb.build()
    assert list(tmp_path.iterdir()) == []


# ---- v10's node records and its lane groups (the kernel's order, plain) -------


@pytest.mark.parametrize("k,n,grid", [(3, 5000, False), (3, 7, False), (1, 1000, True),
                                      (16, 300, False), (5, 2, False)])
def test_kd_records_hold_each_nodes_split_point_and_children(k, n, grid):
    """kd_records' row i is node i of the heap: split_val's bits, p, the
    clamped split dimension with bit 8 / bit 9 set exactly where the left /
    right child lies below cap and holds a point (traverse_plain's push
    test), and the point's coordinates; empty nodes hold p = -1 and zeros;
    the rows stop at the last used node. Small n leaves empty children
    inside the heap (n = 7, 2), so the bits are not implied by the index."""
    r, _ = _planted(k, n, 4, seed=k + n, grid=grid)
    dev = traversal.DeviceKDTree(build_kdtree(r), "cpu")
    rec = traversal.kd_records(dev.ref, dev.p, dev.dim, dev.split_val)
    p, dim, split = dev.p.numpy(), dev.dim.numpy(), dev.split_val.numpy()
    top = int(np.flatnonzero(p >= 0).max())
    assert rec.dtype == torch.int32 and rec.shape == (top + 1, traversal.record_words(k))
    assert traversal.record_words(k) % 4 == 0
    rec = rec.numpy()
    cap = p.shape[0]
    empty_children = 0
    for i in range(top + 1):
        row = rec[i]
        assert row[1] == p[i]
        if p[i] < 0:
            assert not row[[0, 2]].any() and not row[4:].any()
            continue
        assert row[0] == split[i:i + 1].view(np.int32)[0]
        assert row[2] & 0xFF == dim[i]
        for bit, child in ((8, 2 * i), (9, 2 * i + 1)):
            exists = child < cap and p[child] >= 0
            assert bool(row[2] >> bit & 1) == exists
            empty_children += not exists
        np.testing.assert_array_equal(row[4:4 + k].view(np.float32), r[p[i]])
        assert not row[4 + k:].any()
    assert empty_children > 0
    with pytest.raises(ValueError, match="root"):
        traversal.kd_records(dev.ref, torch.full_like(dev.p, -1), dev.dim, dev.split_val)


@pytest.mark.parametrize("lanes", [1, 2, 8, 32])
@pytest.mark.parametrize("k,n,m,grid", [(3, 20_000, 256, False), (3, 4000, 200, True),
                                        (8, 3000, 64, False), (2, 3000, 96, True)])
def test_records_traversal_is_traverse_plain(k, n, m, grid, lanes):
    """The kernel's traversal over the records, as torch ops
    (traverse_records_plain: a group of `lanes` pops and visits that many
    entries a step, folds their (d2, index) by the lexicographic minimum,
    pushes in level order), answers traverse_plain's indices and d2 bit
    for bit on uniform and lattice points, whatever the group: the answer
    does not depend on the order of the visits. One lane is
    traverse_plain's own order: its visits are traverse_plain's count."""
    r, q = _planted(k, n, m, seed=5 * k + m, grid=grid)
    dev = traversal.DeviceKDTree(build_kdtree(r), "cpu")
    qt = torch.from_numpy(q)
    args = (qt, dev.ref, dev.p, dev.dim, dev.split_val)
    pi, pd, visits, _ = traversal.traverse_plain(*args, count_visits=True)
    rec = traversal.kd_records(dev.ref, dev.p, dev.dim, dev.split_val)
    gi, gd, steps, pops, vis = traversal.traverse_records_plain(qt, rec, lanes, counts=True)
    assert torch.equal(gi, pi)
    assert torch.equal(gd.view(torch.int32), pd.view(torch.int32))
    np.testing.assert_array_equal(gi.numpy(), oracle_knn(q, r))
    assert bool((steps <= pops).all()) and bool((vis <= pops).all())
    assert bool((pops <= steps * lanes).all())
    if lanes == 1:
        assert int(vis.sum()) == visits and torch.equal(steps, pops)


def test_the_stack_depth_check_raises_for_a_tree_too_deep():
    """The host checks a tree's levels against the traversal's stack
    (STACK_CAP levels: one entry a level for one query, 2 G a level for a
    group of G lanes, csrc kStackCap) before a launch: a heap whose last
    used node lies at level STACK_CAP or deeper raises, the deepest that
    fits does not; the records' check and kdtree_traverse's go through
    it. The lanes a query follow k (traverse_lanes)."""
    cap = traversal.STACK_CAP
    assert traversal.stack_levels(1) == 1 and traversal.stack_levels(5) == 3
    assert traversal.stack_levels(2 ** cap - 1) == cap
    for top in (2 ** cap, 2 ** (cap + 4) + 3):
        with pytest.raises(ValueError, match="deeper than the traversal's stack"):
            traversal.stack_levels(top)
    with pytest.raises(ValueError, match="records must be"):
        traversal._check_records(torch.zeros((1, 8), dtype=torch.int32), torch.zeros((2, 3)))
    assert [traversal.traverse_lanes(k) for k in (1, 3, 4, 16)] == [1, 1, 32, 32]
    assert set(traversal.traverse_lanes(k) for k in range(1, 17)) <= set(traversal.KERNEL_LANES)
