"""v10 — batched KD-tree traversal on the card (counterpart of tpu_knn/kdtree/traversal.py).

The reference v10 (core.cu:1051-1191) runs one CUDA thread per query over
the host-built tree; tpu_knn turned it into a vmapped `lax.while_loop`
(`_batched_traverse`, XLA, not Pallas). The port's counterpart is the
reference's shape again, a hand-written kernel (csrc/kdtree_kernels.cu,
`kdtree_traverse`): one thread per query walks the implicit-heap arrays
with an explicit stack of (node, plane d²) entries:

- pop; skip the node when its plane d² > best (strict: equal-distance
  points across the plane are still visited);
- visit: d2 = Σ_d (q_d − r_d)², a multiply and an add per coordinate in
  order d = 0..k−1 (no contraction: the host trees' and the plain
  version's d2 bit for bit); update on d2 < best, or d2 == best and a
  lower index (ties to the lowest index, as v0);
- push the far child with its (q[dim] − split_val)², then the near child
  with 0, each only when child < cap and p[child] >= 0;
- at most cap + STACK_CAP pops a query (tpu_knn's step bound).

`traverse_plain` is the same traversal as batched torch ops, every live
query one pop per step; it serves the CPU and the card-side compare.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_knn_torch.utils.platform import check_device, launch_stream

#: Stack entries a query keeps: depth of a balanced tree of 2^30 points and
#: slack (a visit pops one entry and pushes at most two), tpu_knn's.
STACK_CAP = 36
#: The kernel keeps the query in registers, k a template parameter.
KERNEL_MAX_K = 16

_I32_MAX = 2**31 - 1


def traverse_plain(q, ref, p, dim, split_val, *, count_visits: bool = False):
    """The batched traversal as torch ops: (idx (m,) int32, d2 (m,) f32),
    and with count_visits=True also the number of node visits (the distance
    work the kernel does on these inputs) and the number of distinct nodes
    visited (the tree and points it must read at least once). ``dim`` must
    be clamped at 0."""
    m, k = q.shape
    cap = p.shape[0]
    dev = q.device
    rows = torch.arange(m, device=dev)
    stack_n = torch.zeros((m, STACK_CAP + 1), dtype=torch.int64, device=dev)
    stack_d = torch.zeros((m, STACK_CAP + 1), dtype=torch.float32, device=dev)
    stack_n[:, 0] = 1
    sp = torch.ones(m, dtype=torch.int64, device=dev)
    best = torch.full((m,), torch.inf, dtype=torch.float32, device=dev)
    besti = torch.full((m,), _I32_MAX, dtype=torch.int64, device=dev)
    p64, dim64 = p.long(), dim.long()
    visits = 0
    seen = torch.zeros(cap, dtype=torch.bool, device=dev) if count_visits else None
    for _ in range(cap + STACK_CAP):
        live = sp > 0
        if not bool(live.any()):
            break
        sp = sp - live.long()
        at = sp.clamp(min=0)
        node = stack_n[rows, at]
        visit = live & ~(stack_d[rows, at] > best)
        if count_visits:
            visits += int(visit.sum())
            seen[node[visit]] = True
        node = torch.where(visit, node, 1)
        pi = p64[node]
        r = ref[pi]
        acc = torch.zeros(m, dtype=torch.float32, device=dev)
        for d in range(k):
            diff = q[:, d] - r[:, d]
            acc = acc + diff * diff
        better = visit & ((acc < best) | ((acc == best) & (pi < besti)))
        best = torch.where(better, acc, best)
        besti = torch.where(better, pi, besti)
        delta = q[rows, dim64[node]] - split_val[node]
        left = 2 * node
        near = torch.where(delta < 0, left, left + 1)
        far = torch.where(delta < 0, left + 1, left)
        for child, plane in ((far, delta * delta), (near, torch.zeros_like(delta))):
            ok = (visit & (sp < STACK_CAP) & (child < cap)
                  & (p64[child.clamp(max=cap - 1)] >= 0))
            stack_n[rows, sp] = torch.where(ok, child, stack_n[rows, sp])
            stack_d[rows, sp] = torch.where(ok, plane, stack_d[rows, sp])
            sp = sp + ok.long()
    idx = besti.to(torch.int32)
    if count_visits:
        return idx, best, visits, int(seen.sum())
    return idx, best


def _check_tree(q, ref, p, dim, split_val):
    if q.dim() != 2 or ref.dim() != 2 or q.shape[1] != ref.shape[1]:
        raise ValueError(f"q (m, k) and ref (n, k) must share k, got {tuple(q.shape)} "
                         f"and {tuple(ref.shape)}")
    cap = 4 * ref.shape[0]
    for name, t, dtype in (("q", q, torch.float32), ("ref", ref, torch.float32),
                           ("p", p, torch.int32), ("dim", dim, torch.int32),
                           ("split_val", split_val, torch.float32)):
        if t.dtype != dtype or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {q.device}, "
                             f"got {t.dtype} on {t.device}")
        if name in ("p", "dim", "split_val") and t.shape != (cap,):
            raise ValueError(f"{name} must be ({cap},), got {tuple(t.shape)}")


def kdtree_traverse(q: torch.Tensor, ref: torch.Tensor, p: torch.Tensor, dim: torch.Tensor,
                    split_val: torch.Tensor):
    """Exact 1-NN of (m, k) queries over an implicit-heap KD-tree of ref
    ((n, k) f32; p, dim (clamped at 0), split_val (4n,)): (idx (m,) int32,
    d2 (m,) f32). CPU tensors take the plain version; CUDA tensors launch
    the kernel (csrc/kdtree_kernels.cu, k <= KERNEL_MAX_K) or raise."""
    _check_tree(q, ref, p, dim, split_val)
    m, k = q.shape
    if q.device.type == "cpu":
        return traverse_plain(q, ref, p, dim, split_val)
    check_device(q.device)
    if not 1 <= k <= KERNEL_MAX_K:
        raise ValueError(f"the v10 kernel takes 1 <= k <= {KERNEL_MAX_K}, got k={k}")
    if p.shape[0] > _I32_MAX // 2:
        raise ValueError(f"a tree of {p.shape[0]} nodes overflows the kernel's int32 "
                         "child numbers")
    from tpu_knn_torch.csrc.build import check, load

    lib = load()
    idx = torch.empty(m, dtype=torch.int32, device=q.device)
    d2 = torch.empty(m, dtype=torch.float32, device=q.device)
    if m == 0:
        return idx, d2
    with torch.cuda.device(q.device):
        err = lib.tk_kdtree_traverse(
            q.data_ptr(), ref.data_ptr(), p.data_ptr(), dim.data_ptr(), split_val.data_ptr(),
            idx.data_ptr(), d2.data_ptr(), m, k, p.shape[0],
            launch_stream(q.device))
    check(lib, err, "v10 kdtree_traverse")
    kdtree_traverse.launches += 1
    return idx, d2


#: Kernel launches of the v10 traversal (CUDA tensors only; the plain
#: version is not counted).
kdtree_traverse.launches = 0


class DeviceKDTree:
    """A host-built tree's arrays placed once on ``device`` (dim clamped at
    0, as tpu_knn's DeviceKDTree does); queries run kdtree_traverse."""

    def __init__(self, tree, device="cuda"):
        device = check_device(device)
        self.ref = torch.as_tensor(np.ascontiguousarray(tree.ref, np.float32), device=device)
        self.p = torch.as_tensor(np.ascontiguousarray(tree.p, np.int32), device=device)
        self.dim = torch.as_tensor(np.maximum(tree.dim, 0).astype(np.int32), device=device)
        self.split_val = torch.as_tensor(np.ascontiguousarray(tree.split_val, np.float32),
                                         device=device)

    def query(self, search):
        q = torch.as_tensor(search, dtype=torch.float32, device=self.ref.device).contiguous()
        return kdtree_traverse(q, self.ref, self.p, self.dim, self.split_val)
