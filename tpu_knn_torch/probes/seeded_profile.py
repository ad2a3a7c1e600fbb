"""Where a seeded top-K call's and a knn_graph call's time goes.

    python3 -m tpu_knn_torch.probes.seeded_profile [kernels|split]   # repo root, one H100
    PYTHONPATH=<checkout> python3 tpu_knn_torch/probes/seeded_profile.py [kernels|split]

The second form measures whichever checkout is on the path (run an older
tree and this one in one chip call to compare them). Prints, beside the
card's name and power limit (nvidia-smi):

- split (by default, after kernels): for seeded topk_knn at ds11 = (16,
  1024, 2^20) with K = 8, 16, 32, 64, 128 and 256, and for knn_graph at
  (16, 2^17) K = 15, the device time per call, split into B3, B7, the
  compactor (B8/B9), the lane-minima merges, B4 (the passes fallback),
  sorting and selection kernels, and the rest (the lane recovery, gathers
  and rerank arithmetic, all torch ops); the wall time per call without
  the profiler, the busy share, and the device->host reads per call (the
  tier decisions that tpu_knn took with lax.cond on the device) with the
  idle time per read; which tiers answered (kernels/seeded.py TIERS);
  the host's time per call by op (torch ops and CUDA runtime calls, self
  time, torch.profiler);
- kernels: B3 and B7 alone at the seeded engine's ds11 K = 8 and K = 64
  launches, called as that checkout's engine calls them (with the
  queries' transposed copy made once where the wrappers take it), by CUDA
  events (median) and by their own device time (torch.profiler; B3 with
  its partition merge).
"""

from __future__ import annotations

import functools
import inspect
import os
import subprocess
import sys
import time

#: Kernel names of each part (the lane-per-thread B3 and B7 of older trees,
#: the tiled ones since).
_PARTS = (("B3", ("minima_candidates_kernel", "tiled_minima_kernel")),
          ("B7", ("extract_moments_kernel", "tiled_moments_kernel")),
          ("compactor", ("compact_cells_kernel",)), ("merge", ("minima_merge_kernel",)),
          ("B4 fallback", ("tiled_candidates_kernel",)))


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
        key = next((p for p, subs in _PARTS if any(s in name for s in subs)), None)
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
    host = sorted(((e.key, e.self_cpu_time_total / 1e3 / calls, e.count / calls)
                   for e in prof.key_averages() if e.self_cpu_time_total > 0),
                  key=lambda x: -x[1])[:8]
    print(f"  host time per call by op (self, ms, calls): "
          + "; ".join(f"{name[:40]} {ms:.4f} x{n:g}" for name, ms, n in host), flush=True)


def _kernels(q, r, card, reps=10):
    from tpu_knn_torch.kernels import fused, seeded
    from tpu_knn_torch.utils.timing import device_ms, time_ms

    (m, k), n = q.shape, r.shape[0]
    r_op = fused.prep_soa(r, n)
    takes_q_t = "q_t" in inspect.signature(fused.minima_candidates).parameters
    extra = {"q_t": fused.transposed_queries(q)} if takes_q_t else {}
    for kk in (8, 64):
        g = seeded.seeded_geometry(m, n, k, kk, n)
        b3 = functools.partial(fused.minima_candidates, q, r_op, n, depth=g["depth"],
                               n_limit=g["p1_limit"], **extra)
        bound = seeded._inflate_bound(seeded._kth_smallest(b3(), kk))
        b7 = functools.partial(seeded.extract_moments, q, r_op, n, bound, g["cell"],
                               g["n_fields"], **extra)
        events = time_ms({"B3": b3, "B7": b7}, reps)
        for kid, fn, kernel in (("B3", b3, "minima"), ("B7", b7, "moments")):
            dev = device_ms({kid: fn}, kernel, reps)
            split = ", ".join(f"{name[:40]} {ms:.4f}" for name, ms in dev.items())
            print(f"{kid} at ds11 K={kk}: events {events[kid]:.4f} ms (median of {reps}), "
                  f"device {sum(dev.values()):.4f} ms ({split}); transposed queries passed "
                  f"in: {takes_q_t} [{card}]", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("seeded_profile: no CUDA device", file=sys.stderr)
        return 2
    import tpu_knn_torch
    from tpu_knn_torch.kernels import topk

    sections = sys.argv[1:] or ["kernels", "split"]

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{card}; tpu_knn_torch from {os.path.dirname(tpu_knn_torch.__file__)}")
    q = torch.rand((1024, 16), generator=gen, device=dev)
    r = torch.rand((1 << 20, 16), generator=gen, device=dev)
    pts = torch.rand((1 << 17, 16), generator=gen, device=dev)
    if "kernels" in sections:
        _kernels(q, r, card)
    if "split" in sections:
        for kk in (8, 16, 32, 64, 128, 256):
            _profile(f"topk_knn ds11 K={kk} [seeded]", lambda kk=kk: topk.topk_knn(q, r, kk),
                     5, card)
        _profile("knn_graph (16, 2^17) K=15 [seeded, 128 chunks]",
                 lambda: tpu_knn_torch.knn_graph(pts, 15), 2, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
