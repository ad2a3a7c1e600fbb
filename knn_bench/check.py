"""The output check: answers of the timed path against the plain reference.

Two numbers are compared, each the largest over every answer checked:

- ``rank_gap``: how far a row's answers stray from the true K nearest in
  their order. A row's returned points are keyed exactly (float64, from
  the raw vectors) in the order returned; at each rank the gap is that
  key less the true key at the rank, so a point that lies farther than
  the rank's true neighbour, or a row out of order, reads the distance.
  The row's returned scores must also step in the key's direction: a
  score that steps back against it reads the step. For "l2" both are
  read as a share of the row's true K-th d², for "cosine" in
  similarity. A row with an index outside [0, n) or one index twice
  reads ``BAD``.
- ``score_err``: how far each returned score lies from the exact score of
  the point it names; a share of that d² for "l2", in similarity for
  "cosine".

The cell's file (``cells/<cell>.json``) gives each number's limit.
"""

from __future__ import annotations

import numpy as np
import torch

from knn_bench import reference

#: What a row reads whose answers name a point that does not exist, or one twice.
BAD = 1e9

NUMBERS = ("rank_gap", "score_err")


def judge(points: torch.Tensor, queries: torch.Tensor, idx, scores, ref) -> dict:
    """Per-row readings of one batch: {"rank_gap": (m,), "score_err": (m,)}
    float64 numpy arrays. ``idx`` and ``scores`` are the batch's answers,
    (m,) or (m, K), as NumPy arrays or tensors."""
    dev = points.device
    idx = torch.as_tensor(np.asarray(idx)).to(dev).long()
    scores = torch.as_tensor(np.asarray(scores)).to(dev).double()
    if idx.dim() == 1:
        idx, scores = idx[:, None], scores[:, None]
    m, kk = idx.shape
    n = points.shape[0]
    true_keys, _ = reference.exact_topk(points, queries, kk, ref, "f64")
    valid = (idx >= 0) & (idx < n)
    srt = torch.sort(torch.where(valid, idx, -1), dim=1).values
    distinct = (srt[:, 1:] != srt[:, :-1]).all(dim=1) if kk > 1 else torch.ones_like(valid[:, 0])
    good = valid.all(dim=1) & distinct
    safe = torch.where(valid, idx, 0)
    got = ref.pair_keys(queries.double(), points[safe.reshape(-1)].double().view(m, kk, -1))
    gap = got - true_keys
    if kk > 1:
        keyed = ref.score_key(scores)
        gap = torch.cat([gap, keyed[:, :-1] - keyed[:, 1:]], dim=1)
    err = (scores - ref.score(got)).abs()
    if ref.RELATIVE:
        gap = gap / true_keys[:, -1:].abs().clamp_min(1e-300)
        err = err / got.abs().clamp_min(1e-300)
    gap = torch.where(good, torch.nan_to_num(gap, nan=BAD, posinf=BAD).max(dim=1).values, BAD)
    err = torch.where(good, torch.nan_to_num(err, nan=BAD, posinf=BAD).max(dim=1).values, BAD)
    return {"rank_gap": gap.cpu().numpy(), "score_err": err.cpu().numpy()}


def verdict(readings: list[dict], limits: dict) -> dict:
    """Fold the batches' per-row readings: each number's largest reading,
    the rows over any limit, and whether every number keeps its limit."""
    out = {"numbers": {}, "failed_rows": 0, "rows": 0, "correct": bool(readings)}
    over = None
    for name in NUMBERS:
        rows = np.concatenate([r[name] for r in readings]) if readings else np.zeros(0)
        value = float(rows.max()) if rows.size else float(BAD)
        out["numbers"][name] = {"value": value, "limit": limits[name]}
        out["correct"] &= value <= limits[name]
        bad = rows > limits[name]
        over = bad if over is None else over | bad
        out["rows"] = int(rows.size)
    out["failed_rows"] = int(over.sum()) if over is not None else 0
    return out
