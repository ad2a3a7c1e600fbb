"""ctypes bindings of the port's host KD-tree library (src/kdtree_native.cc).

The KD-tree half of tpu_knn/native/__init__.py: the reference-format
implicit-heap tree (build, 1-NN and top-K queries) and the leaf-bucketed
kdt2 serving tree. The library is built by build.py on first use; a failed
build raises, and nothing falls back to a NumPy query.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np

#: kdt2 serves k <= KDT2_MAX_K (above it the reference-format tree does,
#: as in tpu_knn: high-dimensional trees degenerate to full scans anyway).
KDT2_MAX_K = 16
#: kdt2's in-traversal heap capacity (top-K above it takes the
#: reference-format tree).
KDT2_TOPK_MAX = 128


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's types."""
    from tpu_knn_torch.native.build import build

    lib = ctypes.CDLL(build())
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.tk_kdtree_build.argtypes = [i32, i32, ptr, ptr, ptr]
    lib.tk_kdtree_build.restype = None
    lib.tk_kdtree_query.argtypes = [i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.tk_kdtree_query.restype = None
    lib.tk_kdtree_query_topk.argtypes = [i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.tk_kdtree_query_topk.restype = None
    lib.tk_kdt2_build.argtypes = [i32, i32, ptr]
    lib.tk_kdt2_build.restype = ptr
    lib.tk_kdt2_free.argtypes = [ptr]
    lib.tk_kdt2_free.restype = None
    lib.tk_kdt2_depth.argtypes = [ptr]
    lib.tk_kdt2_depth.restype = i32
    lib.tk_kdt2_query.argtypes = [ptr, i32, ptr, ptr, ptr]
    lib.tk_kdt2_query.restype = None
    lib.tk_kdt2_query_topk.argtypes = [ptr, i32, i32, ptr, ptr, ptr]
    lib.tk_kdt2_query_topk.restype = None
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32)


def _tree_arrays(search, ref, p, dim):
    """The query's arrays as the C entry points read them, checked: (m, k)
    and (n, k) f32, (4n,) int32 tree arrays."""
    search, ref = _f32(search), _f32(ref)
    p, dim = np.ascontiguousarray(p, np.int32), np.ascontiguousarray(dim, np.int32)
    if search.ndim != 2 or ref.ndim != 2 or search.shape[1] != ref.shape[1]:
        raise ValueError(f"search (m, k) and ref (n, k) must share k, got "
                         f"{search.shape} and {ref.shape}")
    if p.shape != (4 * ref.shape[0],) or dim.shape != p.shape:
        raise ValueError(f"p and dim must be ({4 * ref.shape[0]},) int32, got "
                         f"{p.shape} and {dim.shape}")
    return search, ref, p, dim


def kdtree_build(ref) -> Tuple[np.ndarray, np.ndarray]:
    """Native implicit-heap build: (p (4n,) int32, dim (4n,) int32)."""
    ref = _f32(ref)
    n, k = ref.shape
    p = np.empty(4 * n, np.int32)
    dim = np.empty(4 * n, np.int32)
    _load().tk_kdtree_build(k, n, _ptr(ref), _ptr(p), _ptr(dim))
    return p, dim


def kdtree_query(search, ref, p, dim) -> Tuple[np.ndarray, np.ndarray]:
    """Native 1-NN over the reference-format tree (v9): (idx (m,) int32,
    d2 (m,) f32), lowest index on ties."""
    search, ref, p, dim = _tree_arrays(search, ref, p, dim)
    m, k = search.shape
    idx = np.empty(m, np.int32)
    d2 = np.empty(m, np.float32)
    _load().tk_kdtree_query(k, m, ref.shape[0], _ptr(search), _ptr(ref), _ptr(p), _ptr(dim),
                            _ptr(idx), _ptr(d2))
    return idx, d2


def kdtree_query_topk(search, ref, p, dim, neighbors: int) -> Tuple[np.ndarray, np.ndarray]:
    """Native top-K over the reference-format tree: (idx (m, K) int32, d2
    (m, K) f32), rows ascending by (d2, index); a -1/+inf tail when n < K."""
    search, ref, p, dim = _tree_arrays(search, ref, p, dim)
    if neighbors < 1:
        raise ValueError(f"neighbors must be >= 1, got {neighbors}")
    m, k = search.shape
    idx = np.empty((m, neighbors), np.int32)
    d2 = np.empty((m, neighbors), np.float32)
    _load().tk_kdtree_query_topk(k, m, ref.shape[0], neighbors, _ptr(search), _ptr(ref),
                                 _ptr(p), _ptr(dim), _ptr(idx), _ptr(d2))
    return idx, d2


class Kdt2Index:
    """Owning handle of a native kdt2 tree (freed with the object)."""

    def __init__(self, ref):
        ref = _f32(ref)
        n, k = ref.shape
        if not 1 <= k <= KDT2_MAX_K:
            raise ValueError(f"kdt2 supports 1 <= k <= {KDT2_MAX_K}, got {k}")
        if n < 1:
            raise ValueError("kdt2 needs at least one reference point")
        self._lib = _load()
        self.n, self.k = n, k
        self._h = self._lib.tk_kdt2_build(k, n, _ptr(ref))
        if not self._h:
            raise RuntimeError("tk_kdt2_build failed")

    @property
    def depth(self) -> int:
        return self._lib.tk_kdt2_depth(self._h)

    def _queries(self, search) -> np.ndarray:
        search = _f32(search)
        if search.ndim != 2 or search.shape[1] != self.k:
            # The native call walks search + i*k: a wrong k would read out
            # of bounds.
            raise ValueError(f"queries must be (m, {self.k}), got {search.shape}")
        return search

    def query(self, search) -> Tuple[np.ndarray, np.ndarray]:
        """Exact 1-NN: (idx (m,) int32, d2 (m,) f32)."""
        search = self._queries(search)
        m = search.shape[0]
        idx = np.empty(m, np.int32)
        d2 = np.empty(m, np.float32)
        self._lib.tk_kdt2_query(self._h, m, _ptr(search), _ptr(idx), _ptr(d2))
        return idx, d2

    def query_topk(self, search, neighbors: int) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-K, kdtree_query_topk's contract, K <= KDT2_TOPK_MAX."""
        if not 1 <= neighbors <= KDT2_TOPK_MAX:
            raise ValueError(f"kdt2 top-K supports 1 <= K <= {KDT2_TOPK_MAX}, "
                             f"got {neighbors}")
        search = self._queries(search)
        m = search.shape[0]
        idx = np.empty((m, neighbors), np.int32)
        d2 = np.empty((m, neighbors), np.float32)
        self._lib.tk_kdt2_query_topk(self._h, m, neighbors, _ptr(search), _ptr(idx),
                                     _ptr(d2))
        return idx, d2

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.tk_kdt2_free(h)
            self._h = None
