"""NNIndex.save / NNIndex.load (ROADMAP A.6.5) against tpu_knn's on the CPU.

Both packages write the same .npz keys, so a file crosses either way. A
loaded index rebuilds its operands from the saved points (and a kdtree
restores its saved arrays), so it answers bit for bit as the index that
was saved (indices and d2) in the same package. Across packages the
indices are equal and d2 within 1e-6 relative (tpu_knn's norm-form tiers
round differently from the port's plain versions before the exact
rerank; both report the exact diff-form d2 of the same points). The one
exception is tpu_knn's own: its load refuses a bf16 (or int8) index whose
tier is "qsplit2" (k > 32); the port loads it."""

import ml_dtypes
import numpy as np
import pytest
import torch

import tpu_knn_torch
from tpu_knn.engine.index import NNIndex as JaxIndex
from tpu_knn.oracle import oracle_knn
from tpu_knn_torch.engine.index import PAD_VALUE

NNIndex = tpu_knn_torch.NNIndex

K, N = 8, 3000

#: Every state the port holds, as constructor arguments (k = 3 for the
#: projection and auto indexes: v11's niche).
STATES = {
    "fused f32": {},
    "bf16": {"store": "bf16"},
    "int8": {"store": "int8"},
    "presplit": {"precision": "bf16x3_presplit"},
    "bf16 + presplit": {"store": "bf16", "precision": "bf16x3_presplit"},
    "int8 + presplit": {"store": "int8", "precision": "bf16x3_presplit"},
    "projection": {"strategy": "projection"},
    "auto": {"strategy": "auto"},
    "auto + presplit": {"strategy": "auto", "precision": "bf16x3_presplit"},
    "cosine": {"metric": "cosine"},
    "ip": {"metric": "ip"},
    "mutable f32": {"mutable": True},
    "mutable bf16": {"mutable": True, "store": "bf16"},
    "mutable ip": {"mutable": True, "metric": "ip"},
    "kdtree": {"strategy": "kdtree"},
}


def _data(name, seed=5):
    rng = np.random.default_rng(seed)
    k = 3 if name.startswith(("auto", "projection")) else K
    r = rng.random((N, k), np.float32) + 0.05
    q = rng.random((40, k), np.float32) + 0.05
    r[N - 1] = r[11]
    q[0] = r[11]
    return r, q


def _build(cls, name, r, q, **device):
    ix = cls(r, **STATES[name], **device)
    if ix.mutable:   # adds past the first points, removes among both
        ids = ix.add(q * 0.5)
        ix.remove([2, 11, int(ids[3])])
    return ix


def _serves_topk(ix):
    return ix.precision != "bf16x3_presplit" and ix.strategy != "projection"


def _answers(ix, q):
    out = [ix.query(q[:4]), ix.query(q)]
    if _serves_topk(ix):
        out += [ix.query(q[:4], neighbors=8), ix.query(q, neighbors=8)]
    if ix.strategy == "auto":
        out.append(ix.last_strategy)
    return out


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _bit_equal(got, want):
    for a, b in zip(got, want):
        if isinstance(a, str) or a is None:
            assert a == b
            continue
        for x, y in zip(a, b):
            x, y = _np(x), _np(y)
            assert x.dtype == y.dtype and np.array_equal(x.view(np.uint8), y.view(np.uint8))


@pytest.mark.parametrize("name", list(STATES))
def test_round_trip_answers_bit_for_bit(name, tmp_path):
    r, q = _data(name)
    ix = _build(NNIndex, name, r, q, device="cpu")
    path = str(tmp_path / "ix")
    ix.save(path)
    lx = NNIndex.load(path + ".npz", device="cpu")
    for attr in ("strategy", "precision", "store", "metric", "mutable", "k", "k_user",
                 "n_live", "device"):
        assert getattr(lx, attr) == getattr(ix, attr), attr
    _bit_equal(_answers(lx, q), _answers(ix, q))
    with np.load(path + ".npz") as z:
        keys = set(z.files)
    assert {"strategy", "precision", "mutable", "store", "metric", "ref"} <= keys
    assert ("ip_m2" in keys) == (ix.metric == "ip")
    assert ("live" in keys) == ix.mutable
    assert ({"p", "dim", "split_val"} <= keys) == (ix.strategy == "kdtree")
    assert ({"i8_zero", "i8_inv_s"} <= keys) == (ix.store == "int8")
    if ix.strategy == "auto":
        assert lx.cert_rate == ix.cert_rate
        assert (lx.proj_index is None) == (ix.proj_index is None)


def _same_answers(port, theirs, q):
    for kk in (None, 8):
        if kk is not None and not _serves_topk(port):
            continue
        for m in (4, 40):
            got, want = port.query(q[:m], neighbors=kk), theirs.query(q[:m], neighbors=kk)
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
            np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6,
                                       atol=1e-7)


#: tpu_knn's presplit over a quantized store keeps its norm row in bf16 and
#: can miss the nearest point (ROADMAP C): its answers there are compared
#: with its exact store index over the same points instead.
_TK_FAULTY = ("bf16 + presplit", "int8 + presplit")


@pytest.mark.parametrize("name", list(STATES))
def test_tpu_knn_files_load_into_the_port(name, tmp_path):
    r, q = _data(name, seed=6)
    jx = _build(JaxIndex, name, r, q)
    path = str(tmp_path / "tk")
    jx.save(path)
    ix = NNIndex.load(path + ".npz", device="cpu")
    assert (ix.strategy, ix.precision, ix.store, ix.mutable) == (
        jx.strategy, jx.precision, jx.store, jx.mutable)
    if name in _TK_FAULTY:
        jx = JaxIndex(r, store=STATES[name]["store"])
    _same_answers(ix, jx, q)
    if ix.mutable:
        n = ix._n_slots
        assert ix.n_live == jx.n_live and np.array_equal(ix._live[:n], jx._live[:n])


@pytest.mark.parametrize("name", list(STATES))
def test_port_files_load_into_tpu_knn(name, tmp_path):
    r, q = _data(name, seed=7)
    ix = _build(NNIndex, name, r, q, device="cpu")
    path = str(tmp_path / "port")
    ix.save(path)
    jx = JaxIndex.load(path + ".npz")
    assert (jx.strategy, jx.precision, jx.store, jx.mutable) == (
        ix.strategy, ix.precision, ix.store, ix.mutable)
    if name in _TK_FAULTY:
        jx = JaxIndex.load(_resaved_without_presplit(path + ".npz", tmp_path))
    _same_answers(ix, jx, q)


def _resaved_without_presplit(path, tmp_path):
    """The same file with tpu_knn's default tier for the store."""
    with np.load(path) as z:
        fields = {key: z[key] for key in z.files}
    fields["precision"] = np.asarray("packed")
    out = str(tmp_path / "default_tier.npz")
    np.savez_compressed(out, **fields)
    return out


def test_bf16_bits_round_trip(tmp_path):
    r, q = _data("bf16")
    r[5, 0] = np.float32(1.0 + 2.0 ** -9)      # a tie of bf16 rounding (to even)
    ix = NNIndex(r, store="bf16", device="cpu")
    ix.save(str(tmp_path / "b"))
    with np.load(str(tmp_path / "b.npz")) as z:
        saved = z["ref"]
    assert saved.dtype == np.uint16
    want = r.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(saved, want)
    lx = NNIndex.load(str(tmp_path / "b.npz"), device="cpu")
    np.testing.assert_array_equal(lx.ref_dev.view(torch.int16).numpy().view(np.uint16), want)
    np.testing.assert_array_equal(lx.r_ops[0].view(torch.int16).numpy(),
                                  ix.r_ops[0].view(torch.int16).numpy())
    mu = NNIndex(r, store="bf16", mutable=True, device="cpu")
    mu.remove([0, 7])
    mu.save(str(tmp_path / "m"))
    with np.load(str(tmp_path / "m.npz")) as z:
        pad = np.asarray([PAD_VALUE], np.float32).astype(ml_dtypes.bfloat16).view(np.uint16)
        assert (z["ref"][[0, 7]] == pad[0]).all() and z["live"].sum() == N - 2


@pytest.mark.parametrize("mutable", [False, True])
def test_bf16_index_at_k_40_loads_where_tpu_knn_raises(mutable, tmp_path):
    """ROADMAP C: tpu_knn's load passes the saved tier "qsplit2" to its
    constructor, which refuses it; the port restores it (its own tier for
    the store) and answers as the saved index."""
    rng = np.random.default_rng(40)
    r = rng.random((2000, 40), np.float32)
    q = rng.random((20, 40), np.float32)
    for cls, kw in ((NNIndex, {"device": "cpu"}), (JaxIndex, {})):
        ix = cls(r, store="bf16", mutable=mutable, **kw)
        assert ix.precision == "qsplit2"
        ix.save(str(tmp_path / f"{cls.__module__}"))
    for cls in (NNIndex, JaxIndex):
        path = str(tmp_path / f"{cls.__module__}.npz")
        lx = NNIndex.load(path, device="cpu")
        assert lx.precision == "qsplit2" and lx.mutable == mutable
        want = oracle_knn(q, r.astype(ml_dtypes.bfloat16).astype(np.float32))
        for m in (4, 20):
            np.testing.assert_array_equal(lx.query(q[:m])[0].numpy(), want[:m])
        with pytest.raises(ValueError, match="qsplit2"):
            JaxIndex.load(path)


def test_metric_points_are_not_transformed_again(tmp_path):
    """The saved points of a cosine / ip index are already transformed: load
    takes them as they are (_pretransformed), with ip's k_user and max
    norm."""
    r, q = _data("cosine")
    for metric in ("cosine", "ip"):
        ix = NNIndex(r, metric=metric, device="cpu")
        ix.save(str(tmp_path / metric))
        lx = NNIndex.load(str(tmp_path / f"{metric}.npz"), device="cpu")
        assert torch.equal(lx.ref_dev, ix.ref_dev)
        assert (lx.k, lx.k_user) == (ix.k, ix.k_user) == (K + (metric == "ip"), K)
        if metric == "ip":
            assert lx._ip_m2 == ix._ip_m2
        again = NNIndex(ix.ref_dev.numpy(), metric=metric, device="cpu",
                        _pretransformed=True)
        assert torch.equal(again.ref_dev, ix.ref_dev)


def test_mutable_ids_and_live_count_survive(tmp_path):
    r, q = _data("mutable f32")
    ix = _build(NNIndex, "mutable f32", r, q, device="cpu")
    ix.save(str(tmp_path / "mu"))
    lx = NNIndex.load(str(tmp_path / "mu.npz"), device="cpu")
    assert lx._n_slots == ix._n_slots and lx.n_live == ix.n_live == N + 40 - 3
    assert lx.n_live == int(lx._live.sum())
    dead = torch.as_tensor(np.flatnonzero(~lx._live[: lx._n_slots]))
    assert (lx.r_ops[0][:, dead] == PAD_VALUE).all()     # every row, as remove() leaves it
    far = q[:2] + 2.0
    ids = lx.add(far)
    np.testing.assert_array_equal(ids, [ix._n_slots, ix._n_slots + 1])
    np.testing.assert_array_equal(lx.query(far)[0].numpy(), ids)
    lx.remove(ids)
    assert lx.n_live == ix.n_live


def test_views_refuse_to_save(tmp_path):
    r, _ = _data("fused f32")
    for cls, kw in ((NNIndex, {"device": "cpu"}), (JaxIndex, {})):
        view = cls(r, **kw).filtered_view(np.arange(N) % 2 == 0)
        with pytest.raises(ValueError, match="filtered views are ephemeral"):
            view.save(str(tmp_path / "v"))


def test_sharded_files_and_mesh_raise_a9(tmp_path):
    """Sharded .npz files cross between the packages both ways (f32, bf16,
    int8, mutable with removals): tpu_knn's file loads into the port, on
    a CPU mesh of the saved (2, 4) shape by default or on the mesh passed,
    and the port's file into tpu_knn on its 8 virtual devices; each loaded
    index answers as the one saved (indices equal, d2 within 1e-6)."""
    from tpu_knn.distributed.sharded import default_mesh as tk_mesh
    from tpu_knn_torch.distributed.sharded import default_mesh

    r, q = _data("fused f32")
    for kw in ({}, {"store": "bf16"}, {"store": "int8"}, {"mutable": True}):
        jx = JaxIndex(r, strategy="sharded", mesh=tk_mesh(dp=2, sp=4), **kw)
        px = NNIndex(r, strategy="sharded", mesh=default_mesh(dp=2, sp=4, devices="cpu"), **kw)
        for ix in (jx, px) if kw.get("mutable") else ():
            ids = ix.add(q[:3] * 0.5)
            ix.remove([2, 11, int(ids[1])])
        tag = kw.get("store", "mutable" if kw else "f32")
        jx.save(str(tmp_path / f"tk_{tag}"))
        px.save(str(tmp_path / f"pt_{tag}"))
        lx = NNIndex.load(str(tmp_path / f"tk_{tag}.npz"), device="cpu")
        assert lx.strategy == "sharded" and lx.mesh.shape == {"dp": 2, "sp": 4}
        assert lx.store == px.store and lx.n_live == px.n_live
        lx8 = NNIndex.load(str(tmp_path / f"tk_{tag}.npz"),
                           mesh=default_mesh(dp=1, sp=8, devices="cpu"), device="cpu")
        assert lx8.mesh.shape == {"dp": 1, "sp": 8}
        tk = JaxIndex.load(str(tmp_path / f"pt_{tag}.npz"))
        assert tk.strategy == "sharded" and dict(tk.mesh.shape) == {"dp": 2, "sp": 4}
        # m = 40 1-NN and top-K both ways; the int8 store's m = 4 scan too.
        cases = [(lx, jx, 40, None), (lx, jx, 40, 8), (lx8, jx, 40, None),
                 (px, tk, 40, None), (px, tk, 40, 8)]
        if kw.get("store") == "int8":
            cases.append((lx, jx, 4, None))
        for port, theirs, m, kk in cases:
            got = port.query(q[:m], neighbors=kk)
            want = theirs.query(q[:m], neighbors=kk)
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
            np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                       rtol=1e-6, atol=1e-7)
