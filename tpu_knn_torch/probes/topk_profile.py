"""Partition sweep of the top-K kernels B5 and B6, and where a top-K call's
time goes.

    python3 -m tpu_knn_torch.probes.topk_profile      # repo root, one H100

Prints, beside the card's name and power limit (nvidia-smi):

1. B5 at (k=16, m=8, n=2^20) K=32 and (16, 32, 2^20) K=8, and B6 at
   (16, 4, 2^24) K=16 and (16, 3, 2^20) K=8, for several partition counts
   P: the kernel, the selection over its candidates (topk._finalize_topk)
   and the two together. A wider P fills the card but widens the
   candidate set the selection reads (P * list length * 128 per row);
2. for each top-K call that chip_smoke.py times, the device time per call
   split into the candidate kernels, sorting and selection kernels
   (torch.sort / torch.topk) and the rest, beside the wall time without
   the profiler, and the busy share of the call.

Times are medians of CUDA-event timings (utils/timing.py).
"""

from __future__ import annotations

import subprocess
import sys
import time


def _breakdown(label, fn, calls=5):
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / calls
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    parts = {"kernels": 0.0, "sort/select": 0.0, "other": 0.0}
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    for e in evs:
        name = e.name.lower()
        if "candidates_kernel" in name:
            key = "kernels"
        elif any(s in name for s in ("sort", "topk", "radix", "select")):
            key = "sort/select"
        else:
            key = "other"
        parts[key] += e.device_time / 1e3 / calls
    dev = sum(parts.values())
    split = ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
    print(f"{label}: device {dev:.4f} ms per call ({split}); {len(evs) // calls} "
          f"device events; wall {wall:.4f} ms without the profiler "
          f"(busy share {dev / wall:.3f})")
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=8,
                                    max_name_column_width=60))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("topk_profile: no CUDA device", file=sys.stderr)
        return 2
    import tpu_knn_torch
    from tpu_knn_torch.kernels import smallm, topk
    from tpu_knn_torch.kernels.fused import prep_soa
    from tpu_knn_torch.utils.timing import time_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)

    def rand(shape):
        return torch.rand(shape, generator=gen, device=dev)

    def show(times):
        for name, ms in times.items():
            print(f"{name}: {ms:.4f} ms [{card}]")

    n20, n24 = 1 << 20, 1 << 24
    r20, r24 = rand((n20, 16)), rand((n24, 16))
    r_op20, r_op24 = prep_soa(r20, n20), prep_soa(r24, n24)

    for m, kk in ((8, 32), (32, 8)):
        q = rand((m, 16))
        base = topk.sweep_parts(m, kk, n20)
        fns = {}
        for p in sorted({max(1, base // 2), base, 2 * base, 4 * base, 8 * base}):
            cand = topk.sweep_candidates(q, r_op20, n20, p, kk)
            fns[f"B5 (16, {m}, 2^20) K={kk} P={p} kernel"] = (
                lambda p=p: topk.sweep_candidates(q, r_op20, n20, p, kk))
            fns[f"B5 (16, {m}, 2^20) K={kk} P={p} selection"] = (
                lambda c=cand: topk._finalize_topk(q, r20, *c, kk, n20))
            fns[f"B5 (16, {m}, 2^20) K={kk} P={p} both"] = (
                lambda p=p: topk._finalize_topk(
                    q, r20, *topk.sweep_candidates(q, r_op20, n20, p, kk), kk, n20))
        print(f"B5 default P at m={m}, K={kk}: {base}")
        show(time_ms(fns, 10))

    for m, kk, r, r_op, n in ((4, 16, r24, r_op24, n24), (3, 8, r20, r_op20, n20)):
        q = rand((m, 16))
        _, cs1 = smallm.smallm_candidates(q, r_op, n, smallm.default_parts(n))
        bound = torch.topk(cs1, kk, dim=-1, largest=False).values[:, -1].contiguous()
        label = f"B6 (16, {m}, 2^{n.bit_length() - 1}) K={kk}"
        fns = {}
        for p in (66, 132, 264, 396, 528, 1056):
            cand = topk.smallm_topk_candidates(q, r_op, n, p, kk, bound)
            fns[f"{label} P={p} kernel"] = (
                lambda p=p: topk.smallm_topk_candidates(q, r_op, n, p, kk, bound))
            fns[f"{label} P={p} selection"] = (
                lambda c=cand: topk._finalize_topk(q, r, *c, kk, n))
        print(f"B6 default P at m={m}, K={kk}: {topk.smallm_topk_parts(m, kk, n)}")
        show(time_ms(fns, 10))

    index24 = tpu_knn_torch.NNIndex(r24)
    q8, q32, q4, q3 = rand((8, 16)), rand((32, 16)), rand((4, 16)), rand((3, 16))
    q1024, q64 = rand((1024, 16)), rand((64, 16))
    _breakdown("topk_knn (16, 8, 2^20) K=32 [B5]", lambda: topk.topk_knn(q8, r20, 32))
    _breakdown("topk_knn (16, 32, 2^20) K=8 [B5]", lambda: topk.topk_knn(q32, r20, 8))
    _breakdown("NNIndex.query (16, 4, 2^24) K=16 [B2+B6]",
               lambda: index24.query(q4, neighbors=16))
    _breakdown("NNIndex.query (16, 1, 2^24) K=16 [aos]",
               lambda: index24.query(q4[:1], neighbors=16))
    _breakdown("nearest_neighbors (16, 3, 2^20) neighbors=8 [B2+B6]",
               lambda: tpu_knn_torch.nearest_neighbors(q3, r20, neighbors=8))
    _breakdown("topk_knn passes ds11 (16, 1024, 2^20) K=8 [B4]",
               lambda: topk.topk_knn(q1024, r20, 8, method="passes"), calls=3)
    _breakdown("topk_knn passes (16, 64, 2^20) K=64 [B4]",
               lambda: topk.topk_knn(q64, r20, 64, method="passes"), calls=3)
    return 0


if __name__ == "__main__":
    sys.exit(main())
