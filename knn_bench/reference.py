"""The plain reference: exact K nearest points by brute force, in plain
PyTorch, blocks of points at a time, on whatever device its inputs are on.

It takes the raw points and queries that the benchmark drew, and a
configuration's score from ``references/<name>.py``; it imports nothing
of tpu_knn_torch and takes nothing the program made. Ties go to the lower
index: the answers of a row are ordered by (key, index).

``precision`` picks the arithmetic:

- ``"f64"``, the reference: every product of two float32 values is exact
  in float64, so the keys are exact to float64 rounding.
- ``"tf32"``, the control: the reference one precision below what the
  configurations state (float32 with TF32 off). Each matrix product's
  operands are rounded to TF32 (10 mantissa bits, to nearest even) and
  multiplied in float32; the rest is float32. It is put in the program's
  place to show that the output check fails it.
"""

from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties to even), as float32."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & -0x2000
    return b.view(torch.float32)


def _mm_f64(a, b):
    return a @ b.T


def _mm_tf32(a, b):
    return round_tf32(a) @ round_tf32(b).T


#: precision -> (dtype of the arithmetic, matrix product)
PRECISIONS = {"f64": (torch.float64, _mm_f64), "tf32": (torch.float32, _mm_tf32)}


def _lowest(key: torch.Tensor, kk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kk smallest of each row by (key, column): keys and columns."""
    m = key.shape[0]
    kth = torch.topk(key, kk, dim=1, largest=False).values.max(dim=1, keepdim=True).values
    less = key < kth
    eq = key == kth
    n_less = less.sum(1, keepdim=True)
    if bool((n_less + eq.sum(1, keepdim=True) == kk).all()):
        sel = less | eq
    else:   # a tie straddles the kk-th key: its lowest columns go in
        sel = less | (eq & (torch.cumsum(eq, 1) <= kk - n_less))
    cols = sel.nonzero()[:, 1].view(m, kk)   # ascending in each row
    vals = key.gather(1, cols)
    vals, order = torch.sort(vals, dim=1, stable=True)
    return vals, cols.gather(1, order)


def exact_topk(points: torch.Tensor, queries: torch.Tensor, kk: int, ref,
               precision: str = "f64", block: int = 65536):
    """(keys (m, kk), idx (m, kk) int64) of the kk nearest points of each
    query under the score module ``ref``, rows ascending by (key, index)."""
    dtype, mm = PRECISIONS[precision]
    q = queries.to(dtype)
    cand_k, cand_i = [], []
    for s in range(0, points.shape[0], block):
        p = points[s:s + block].to(dtype)
        vals, cols = _lowest(ref.keys(q, p, mm), min(kk, p.shape[0]))
        cand_k.append(vals)
        cand_i.append(cols + s)
    keys = torch.cat(cand_k, dim=1)
    idx = torch.cat(cand_i, dim=1)
    order = torch.argsort(idx, dim=1)
    keys, idx = keys.gather(1, order), idx.gather(1, order)
    keys, order = torch.sort(keys, dim=1, stable=True)
    return keys[:, :kk], idx.gather(1, order)[:, :kk]


def answer(points: torch.Tensor, queries: torch.Tensor, kk: int, ref,
           precision: str = "tf32") -> tuple[torch.Tensor, torch.Tensor]:
    """The reference in the program's place: (idx (m, kk) int32, scores
    (m, kk) float32), as the index reports them."""
    keys, idx = exact_topk(points, queries, kk, ref, precision)
    return idx.to(torch.int32), ref.score(keys).to(torch.float32)
