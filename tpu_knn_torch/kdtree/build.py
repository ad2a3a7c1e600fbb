"""KD-tree construction (counterpart of tpu_knn/kdtree/build.py; reference core.cu:960-1008).

Implicit-heap array layout: node 1 is the root, children of node i are 2i
and 2i+1; ``p[node]`` holds the reference point stored at the node (-1 =
empty), ``dim[node]`` its split dimension (-1 = empty), ``split_val[node]``
that point's coordinate there. The split dimension is the one of maximum
variance over the node's range, the split point the median. Arrays are
sized 4n (the reference's README.md:331).

`build_kdtree` is the native host build (tpu_knn_torch/native, the same
source as tpu_knn's, so both packages build the same tree bit for bit).
`_build_numpy` and `query_numpy` are the plain versions the tests hold the
native build and queries against: trees may differ from the native one
where variances tie, but every query over either is exact.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class KDTree:
    """Implicit-heap KD-tree over an (n, k) reference set."""

    ref: np.ndarray        # (n, k) f32 points
    p: np.ndarray          # (4n,) int32 point index per node, -1 = empty
    dim: np.ndarray        # (4n,) int32 split dimension per node, -1 = empty
    split_val: np.ndarray  # (4n,) f32 ref[p[node], dim[node]] (0 if empty)

    @property
    def n(self) -> int:
        return self.ref.shape[0]

    @property
    def k(self) -> int:
        return self.ref.shape[1]

    def save(self, path: str) -> None:
        """Write tpu_knn's KDTree file (.npz with ref, p, dim, split_val)."""
        np.savez_compressed(path, ref=self.ref, p=self.p, dim=self.dim,
                            split_val=self.split_val)

    @classmethod
    def load(cls, path: str) -> "KDTree":
        with np.load(path) as z:
            return cls(ref=z["ref"], p=z["p"], dim=z["dim"], split_val=z["split_val"])


def _split_values(ref: np.ndarray, p: np.ndarray, dim: np.ndarray) -> np.ndarray:
    valid = p >= 0
    split_val = np.zeros(p.shape[0], np.float32)
    split_val[valid] = ref[p[valid], dim[valid]]
    return split_val


def _build_numpy(ref: np.ndarray):
    """The plain build: (p, dim) by full-variance split dimensions and
    np.argpartition medians, with an explicit stack (tpu_knn's)."""
    n, k = ref.shape
    cap = 4 * n
    p = np.full(cap, -1, np.int32)
    dim = np.full(cap, -1, np.int32)
    order = np.arange(n, dtype=np.int32)
    stack = [(1, 0, n)]
    while stack:
        node, lo, hi = stack.pop()
        if lo >= hi:
            continue
        seg = order[lo:hi]
        d = int(np.argmax(ref[seg].var(axis=0)))
        mid = (lo + hi) // 2
        part = np.argpartition(ref[seg, d], mid - lo)
        order[lo:hi] = seg[part]
        p[node] = order[mid]
        dim[node] = d
        stack.append((2 * node, lo, mid))
        stack.append((2 * node + 1, mid + 1, hi))
    return p, dim


def build_kdtree(ref) -> KDTree:
    """The host build over the native library (a failed library build
    raises; there is no NumPy fallback on this path)."""
    from tpu_knn_torch import native

    ref = np.ascontiguousarray(ref, np.float32)
    p, dim = native.kdtree_build(ref)
    return KDTree(ref=ref, p=p, dim=dim, split_val=_split_values(ref, p, dim))


def query_numpy(tree: KDTree, search: np.ndarray):
    """The plain recursive 1-NN query (reference core.cu:1010-1025, exact,
    lowest index on ties; d2 accumulated in f32 over d = 0..k-1 in order):
    (idx (m,) int32, d2 (m,) f32). The tree is an implicit heap of ``cap``
    slots, so the recursion is at most log2(cap) + 1 deep."""
    ref, p, dim = tree.ref, tree.p, tree.dim
    cap = p.shape[0]
    k = tree.k

    def ask(node, q, best, besti):
        if node >= cap or p[node] < 0:
            return best, besti
        pi = int(p[node])
        acc = np.float32(0)
        for t in range(k):
            diff = np.float32(q[t] - ref[pi, t])
            acc = np.float32(acc + np.float32(diff * diff))
        if acc < best or (acc == best and pi < besti):
            best, besti = acc, pi
        d = int(dim[node])
        delta = np.float32(q[d] - ref[pi, d])
        near, far = (2 * node, 2 * node + 1) if delta < 0 else (2 * node + 1, 2 * node)
        best, besti = ask(near, q, best, besti)
        if np.float32(delta * delta) <= best:
            best, besti = ask(far, q, best, besti)
        return best, besti

    search = np.ascontiguousarray(search, np.float32)
    m = search.shape[0]
    out_i = np.empty(m, np.int32)
    out_d = np.empty(m, np.float32)
    for i in range(m):
        best, besti = ask(1, search[i], np.float32(np.inf), np.int32(0))
        out_i[i] = besti
        out_d[i] = best
    return out_i, out_d
