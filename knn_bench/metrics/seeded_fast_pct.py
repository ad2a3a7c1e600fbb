"""seeded_fast_pct: the share of the seeded top-K engine's calls (or
1024-row chunks) in the window that its first compaction answered:
the window's delta of tpu_knn_torch.kernels.seeded.TIERS, "fast" over
"fast" + "escalated" + "fallback". Nothing to read where the engine did
not run."""


def read(run):
    answered = sum(run.tiers.get(t, 0) for t in ("fast", "escalated", "fallback"))
    if answered == 0:
        return None
    return 100.0 * run.tiers.get("fast", 0) / answered
