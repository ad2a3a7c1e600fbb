"""The reductions over one mesh axis (counterpart of
tpu_knn/distributed/collectives.py).

tpu_knn reduces (distance, index) pairs over a mesh axis with XLA
collectives inside `shard_map`. In the port one process drives every
shard, so a reduction takes the axis's per-shard partials as a list of
tensors, each on its shard's device, and returns the reduced pair once for
each of them, on its device: tpu_knn's "replicated across the axis", so the
"sp" then "dcn" two-stage reduction composes. Data moves device to device
(`Tensor.to`), never through the host.

- "pmin" (default): tpu_knn's two minima, the distances first, then the
  indices masked to the winning distance. Equal f32 distances are
  bit-equal across shards (same arithmetic on the same values), so ties
  go to the lowest index.
- "ring": P − 1 neighbour shifts, shard i receiving shard i − 1's pair and
  folding it by the (d2, idx) lexicographic rule: an independent
  implementation to hold the "pmin" path against.
"""

from __future__ import annotations

import torch

from tpu_knn_torch.kernels.topk import _lex_smallest

_I32_MAX = 2**31 - 1


def _replicate(pair, devices):
    return [pair[0].to(d) for d in devices], [pair[1].to(d) for d in devices]


def topk_allreduce(d2s, idxs, kk: int):
    """Merge per-shard exact top-K lists: ``d2s`` / ``idxs`` the (m, K) f32 /
    int32 lists of the axis's shards, rows ascending by (d2, idx). Returns
    the globally best ``kk`` of each row, rows ascending by (d2, idx), on
    every shard's device."""
    home = d2s[0].device
    d2 = torch.cat([d.to(home) for d in d2s], dim=1)
    idx = torch.cat([i.to(home) for i in idxs], dim=1)
    d2, idx = _lex_smallest(d2, idx, kk)
    return _replicate((d2, idx), [d.device for d in d2s])


def min_index_allreduce(d2s, idxs, method: str = "pmin"):
    """Reduce the per-query (d2 (m,), idx (m,)) pairs of an axis's shards.
    Returns (d2 list, idx list), the minimum on every shard's device; ties
    on d2 resolve to the smallest idx."""
    devices = [d.device for d in d2s]
    if method == "pmin":
        home = devices[0]
        d2 = torch.stack([d.to(home) for d in d2s])
        idx = torch.stack([i.to(home) for i in idxs])
        best = d2.min(dim=0).values
        cand = torch.where(d2 == best, idx, _I32_MAX).min(dim=0).values
        return _replicate((best, cand), devices)
    if method == "ring":
        p = len(d2s)
        cur = list(zip(d2s, idxs))
        acc = list(cur)
        for _ in range(p - 1):
            cur = [(cur[i - 1][0].to(devices[i]), cur[i - 1][1].to(devices[i]))
                   for i in range(p)]
            for i, ((cd, ci), (ad, ai)) in enumerate(zip(cur, acc)):
                better = (cd < ad) | ((cd == ad) & (ci < ai))
                acc[i] = (torch.where(better, cd, ad), torch.where(better, ci, ai))
        return [a[0] for a in acc], [a[1] for a in acc]
    raise ValueError(f"unknown method {method!r}")
