"""Where a seeded top-K call's and a knn_graph call's time goes.

    python3 -m tpu_knn_torch.probes.seeded_profile     # repo root, one H100

Prints, beside the card's name and power limit (nvidia-smi), for seeded
topk_knn at ds11 = (16, 1024, 2^20) with K = 8, 16, 32, 64, 128 and 256,
and for knn_graph at (16, 2^17) K = 15:

- the device time per call, split into B3, B7, the compactor (B8/B9),
  the lane-minima merges, B4 (the passes fallback), sorting and selection
  kernels, and the rest (the lane recovery, gathers and rerank arithmetic,
  all torch ops);
- the wall time per call without the profiler, the busy share, and the
  device->host reads per call (the tier decisions that tpu_knn took with
  lax.cond on the device) with the idle time per read;
- which tiers answered (kernels/seeded.py TIERS).
"""

from __future__ import annotations

import subprocess
import sys
import time

_PARTS = (("B3", "minima_candidates_kernel"), ("B7", "extract_moments_kernel"),
          ("compactor", "compact_cells_kernel"), ("merge", "minima_merge_kernel"),
          ("B4 fallback", "fused_candidates_kernel"))


def _profile(label, fn, calls, card):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_knn_torch.kernels import seeded

    reads = [0]
    host_flags = seeded._host_flags

    def counted(*flags):
        reads[0] += 1
        return host_flags(*flags)

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    before = dict(seeded.TIERS)
    seeded._host_flags = counted
    try:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    finally:
        seeded._host_flags = host_flags
    tiers = {k: (v - before[k]) / calls for k, v in seeded.TIERS.items() if v != before[k]}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    parts = {name: 0.0 for name, _ in _PARTS}
    parts.update({"sort/select": 0.0, "other": 0.0})
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    for e in evs:
        name = e.name.lower()
        key = next((p for p, sub in _PARTS if sub in name), None)
        if key is None:
            key = ("sort/select" if any(s in name for s in ("sort", "topk", "radix", "select"))
                   else "other")
        parts[key] += e.device_time / 1e3 / calls
    dev = sum(parts.values())
    n_reads = reads[0] / calls
    split = ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
    print(f"{label}: device {dev:.4f} ms per call ({split}); wall {wall:.4f} ms without "
          f"the profiler (busy share {dev / wall:.3f}); {n_reads:g} host reads per call, "
          f"idle {(wall - dev) / max(n_reads, 1):.4f} ms per read; tiers per call {tiers} "
          f"[{card}]", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("seeded_profile: no CUDA device", file=sys.stderr)
        return 2
    import tpu_knn_torch
    from tpu_knn_torch.kernels import topk

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    q = torch.rand((1024, 16), generator=gen, device=dev)
    r = torch.rand((1 << 20, 16), generator=gen, device=dev)
    for kk in (8, 16, 32, 64, 128, 256):
        _profile(f"topk_knn ds11 K={kk} [seeded]", lambda kk=kk: topk.topk_knn(q, r, kk),
                 5, card)
    pts = torch.rand((1 << 17, 16), generator=gen, device=dev)
    _profile("knn_graph (16, 2^17) K=15 [seeded, 128 chunks]",
             lambda: tpu_knn_torch.knn_graph(pts, 15), 2, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
