"""v10 — batched KD-tree traversal on the card (counterpart of tpu_knn/kdtree/traversal.py).

The reference v10 (core.cu:1051-1191) runs one CUDA thread per query over
the host-built tree; tpu_knn turned it into a vmapped `lax.while_loop`
(`_batched_traverse`, XLA, not Pallas). Its contract, which every version
here keeps:

- pop; skip the node when its plane d² > best (strict: equal-distance
  points across the plane are still visited);
- visit: d2 = Σ_d (q_d − r_d)², a multiply and an add per coordinate in
  order d = 0..k−1 (no contraction: the host trees' and the plain
  version's d2 bit for bit); the answer is the lexicographic minimum of
  (d2, index) over the visits (ties to the lowest index, as v0);
- push the far child with its (q[dim] − split_val)², then the near child
  with 0, each only when child < cap and p[child] >= 0.

`traverse_plain` is that traversal as batched torch ops, every live query
one pop per step; it serves the CPU and the card-side compare.

The card's kernel (csrc/kdtree_kernels.cu) walks node records instead of
the four heap arrays (`kd_records`: one row a node 1..the last used one,
its split value, point index, split dimension with a bit for each child
that exists, and the point's coordinates, 16-byte aligned), so a visit is
one dependent read. A group of traverse_lanes(k) lanes (one, or a warp)
serves one query: each step the group pops up to that many stack entries, visits them side by
side, takes the lexicographic minimum of their (d2, index) by shuffles, and
pushes their children in the order that keeps the stack sorted by level.
No point at the final best distance is ever pruned (a plane d² never
exceeds the distance of a point beyond it, and pruning is strict), so the
answer does not depend on the order of visits: it is traverse_plain's, bit
for bit. `traverse_records_plain` is the group traversal as torch ops (the
kernel's order, its steps and pops counted), tested against
traverse_plain on the CPU.
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
#: The lane groups the kernel is built for (csrc launch_traverse_lanes).
KERNEL_LANES = (1, 32)
#: Words of a node record before its coordinates (csrc kRecordHead):
#: split_val (f32 bits), the point's index, the split dimension with bit 8
#: (left child) and bit 9 (right child), and one word of padding.
RECORD_HEAD = 4

_I32_MAX = 2**31 - 1


def traverse_lanes(k: int) -> int:
    """Lanes a query in the kernel at k dimensions: the stack entries its
    group pops and visits a step. A group visits the top entries side by
    side before their siblings' best is known, so it prunes less (at k = 3
    a warp visits 23 times the one-query traversal's nodes), but where the
    tree prunes little it cuts the chain of steps up to 32 times: one lane
    at k <= 3 (ds10 0.054 ms against a warp's 0.085), a warp from k = 4 on
    (2.40 against 25.0 at k = 16; probes/kd_traverse.py, PERF.md §6, PR
    22)."""
    return 1 if k <= 3 else 32


def stack_levels(top_node: int) -> int:
    """The levels of a heap whose last used node is ``top_node`` (node 1
    at level 0), raising where a depth-first stack of STACK_CAP entries
    could overflow: the one-query traversal keeps at most one entry a
    level, and the kernel's group of G lanes at most 2 G a level
    (2 G STACK_CAP entries, csrc kStackCap), so no push is ever dropped."""
    levels = max(int(top_node), 1).bit_length()
    if levels > STACK_CAP:
        raise ValueError(f"a tree of {levels} levels (last used node {top_node}) is deeper "
                         f"than the traversal's stack of {STACK_CAP} levels")
    return levels


def record_words(k: int) -> int:
    """Words of one node record: RECORD_HEAD and the k coordinates, padded
    to 16 bytes (csrc record_words)."""
    return RECORD_HEAD + -(-k // 4) * 4


def kd_records(ref, p, dim, split_val) -> torch.Tensor:
    """The kernel's node records, (top + 1, record_words(k)) int32 on
    p's device, top the last used node: row i is node i's split_val bits,
    p[i], dim[i] | has_left << 8 | has_right << 9 (a child exists where it
    lies below cap and holds a point, the plain version's push test) and
    its point's coordinates; rows of empty nodes hold p = -1 and zeros.
    ``dim`` must be clamped at 0; the root must hold a point."""
    n, k = ref.shape
    cap = p.shape[0]
    used = torch.nonzero(p >= 0).flatten()
    if cap < 2 or int(p[1]) < 0:
        raise ValueError("the tree's root (node 1) holds no point")
    top = int(used.max())
    stack_levels(top)
    nodes = torch.arange(top + 1, device=p.device)

    def exists(child):
        return (child < cap) & (p[child.clamp(max=cap - 1)] >= 0)

    pn = p[: top + 1]
    live = pn >= 0
    meta = (dim[: top + 1].long() | exists(2 * nodes).long() << 8
            | exists(2 * nodes + 1).long() << 9)
    rec = torch.zeros((top + 1, record_words(k)), dtype=torch.int32, device=p.device)
    rec[:, 0] = split_val[: top + 1].view(torch.int32)
    rec[:, 1] = pn
    rec[:, 2] = torch.where(live, meta, 0).to(torch.int32)
    rec[live, RECORD_HEAD:RECORD_HEAD + k] = ref[pn[live].long()].view(torch.int32)
    return rec


def traverse_records_plain(q, records, lanes: int = 1, *, counts: bool = False):
    """The kernel's traversal over kd_records as torch ops, every query a
    group of ``lanes`` lanes: a step pops the top min(lanes, sp) entries
    (lane j entry sp - 1 - j), visits those whose plane d² is not above
    best, folds the visits' (d2, index) into best by the lexicographic
    minimum, and pushes lane j's far then near child above the children of
    lanes j + 1 .. (so the stack stays sorted by level). Returns (idx (m,)
    int32, d2 (m,) f32) and with counts=True also the per-query steps,
    pops and visits ((m,) int64 each)."""
    m, k = q.shape
    dev = q.device
    split = records[:, 0].view(torch.float32)
    point = records[:, 1].long()
    meta = records[:, 2].long()
    coords = records[:, RECORD_HEAD:RECORD_HEAD + k].view(torch.float32)
    depth = 2 * lanes * STACK_CAP
    rows = torch.arange(m, device=dev)
    stack_n = torch.zeros((m, depth), dtype=torch.int64, device=dev)
    stack_d = torch.zeros((m, depth), dtype=torch.float32, device=dev)
    stack_n[:, 0] = 1
    sp = torch.ones(m, dtype=torch.int64, device=dev)
    best = torch.full((m,), torch.inf, dtype=torch.float32, device=dev)
    besti = torch.full((m,), _I32_MAX, dtype=torch.int64, device=dev)
    steps, pops, visits = (torch.zeros(m, dtype=torch.int64, device=dev) for _ in range(3))
    while bool((sp > 0).any()):
        npop = sp.clamp(max=lanes)
        steps += sp > 0
        pops += npop
        lane_out = []
        for j in range(lanes):
            at = (sp - 1 - j).clamp(min=0)
            node = torch.where(j < npop, stack_n[rows, at], 1)
            visit = (j < npop) & ~(stack_d[rows, at] > best)
            visits += visit
            r = coords[node]
            acc = torch.zeros(m, dtype=torch.float32, device=dev)
            for d in range(k):
                diff = q[:, d] - r[:, d]
                acc = acc + diff * diff
            delta = q[rows, meta[node] & 0xFF] - split[node]
            near_left = delta < 0
            has_left, has_right = (meta[node] >> 8 & 1) == 1, (meta[node] >> 9 & 1) == 1
            left = 2 * node
            lane_out.append((
                torch.where(visit, acc, torch.inf), torch.where(visit, point[node], _I32_MAX),
                (visit & torch.where(near_left, has_right, has_left),
                 torch.where(near_left, left + 1, left), delta * delta),
                (visit & torch.where(near_left, has_left, has_right),
                 torch.where(near_left, left, left + 1), torch.zeros_like(delta))))
        sp = sp - npop
        for cd, ci, _, _ in lane_out:
            better = (cd < best) | ((cd == best) & (ci < besti))
            best = torch.where(better, cd, best)
            besti = torch.where(better, ci, besti)
        for _, _, far, near in reversed(lane_out):
            for ok, child, plane in (far, near):
                at = sp.clamp(max=depth - 1)
                stack_n[rows, at] = torch.where(ok, child, stack_n[rows, at])
                stack_d[rows, at] = torch.where(ok, plane, stack_d[rows, at])
                sp = sp + ok.long()
        if bool((sp > depth).any()):
            raise RuntimeError("the traversal's stack overflowed (a tree deeper than "
                               "stack_levels allows)")
    idx = besti.to(torch.int32)
    if counts:
        return idx, best, steps, pops, visits
    return idx, best


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


def _check_records(records, q):
    k = q.shape[1]
    if (records.dtype != torch.int32 or records.device != q.device or not records.is_contiguous()
            or records.dim() != 2 or records.shape[1] != record_words(k) or records.shape[0] < 2):
        raise ValueError(f"records must be kd_records' contiguous (top + 1, {record_words(k)}) "
                         f"int32 tensor on {q.device}, got {records.dtype} "
                         f"{tuple(records.shape)} on {records.device}")
    stack_levels(records.shape[0] - 1)


def kdtree_traverse(q: torch.Tensor, ref: torch.Tensor, p: torch.Tensor, dim: torch.Tensor,
                    split_val: torch.Tensor, records: torch.Tensor | None = None):
    """Exact 1-NN of (m, k) queries over an implicit-heap KD-tree of ref
    ((n, k) f32; p, dim (clamped at 0), split_val (4n,)): (idx (m,) int32,
    d2 (m,) f32). CPU tensors take the plain version; CUDA tensors launch
    the kernel (csrc/kdtree_kernels.cu, k <= KERNEL_MAX_K) over the tree's
    node records, ``records`` (kd_records of these arrays) or, where none
    are given, records built here, at traverse_lanes(k) lanes a query, or
    raise."""
    _check_tree(q, ref, p, dim, split_val)
    k = q.shape[1]
    if q.device.type == "cpu":
        return traverse_plain(q, ref, p, dim, split_val)
    check_device(q.device)
    if not 1 <= k <= KERNEL_MAX_K:
        raise ValueError(f"the v10 kernel takes 1 <= k <= {KERNEL_MAX_K}, got k={k}")
    if p.shape[0] > _I32_MAX // 2:
        raise ValueError(f"a tree of {p.shape[0]} nodes overflows the kernel's int32 "
                         "child numbers")
    if records is None:
        records = kd_records(ref, p, dim, split_val)
    return _launch(q, records, traverse_lanes(k))


def _launch(q: torch.Tensor, records: torch.Tensor, lanes: int):
    """The kernel's launch over checked CUDA queries and their tree's
    records at ``lanes`` (one of KERNEL_LANES) a query; the card's checks
    and probes call it at each group size."""
    _check_records(records, q)
    if lanes not in KERNEL_LANES:
        raise ValueError(f"the v10 kernel runs {KERNEL_LANES} lanes a query, got {lanes}")
    from tpu_knn_torch.csrc.build import check, load

    lib = load()
    m, k = q.shape
    idx = torch.empty(m, dtype=torch.int32, device=q.device)
    d2 = torch.empty(m, dtype=torch.float32, device=q.device)
    if m == 0:
        return idx, d2
    with torch.cuda.device(q.device):
        err = lib.tk_kdtree_traverse(
            q.data_ptr(), records.data_ptr(), idx.data_ptr(), d2.data_ptr(), m, k,
            records.shape[0] - 1, lanes, launch_stream(q.device))
    check(lib, err, "v10 kdtree_traverse")
    kdtree_traverse.launches += 1
    return idx, d2


#: Kernel launches of the v10 traversal (CUDA tensors only; the plain
#: version is not counted).
kdtree_traverse.launches = 0


class DeviceKDTree:
    """A host-built tree's arrays placed once on ``device`` (dim clamped at
    0, as tpu_knn's DeviceKDTree does) and, on a card, its node records
    (kd_records, built once here); queries run kdtree_traverse."""

    def __init__(self, tree, device="cuda"):
        device = check_device(device)
        self.ref = torch.as_tensor(np.ascontiguousarray(tree.ref, np.float32), device=device)
        self.p = torch.as_tensor(np.ascontiguousarray(tree.p, np.int32), device=device)
        self.dim = torch.as_tensor(np.maximum(tree.dim, 0).astype(np.int32), device=device)
        self.split_val = torch.as_tensor(np.ascontiguousarray(tree.split_val, np.float32),
                                         device=device)
        self.records = (None if device.type == "cpu"
                        else kd_records(self.ref, self.p, self.dim, self.split_val))

    def query(self, search):
        q = torch.as_tensor(search, dtype=torch.float32, device=self.ref.device).contiguous()
        return kdtree_traverse(q, self.ref, self.p, self.dim, self.split_val, self.records)
