"""B10 (v5's staged candidates) beside B1, and the B8/B9 compactor, on the card.

    python3 -m tpu_knn_torch.probes.staging [check|time]     # repo root, one H100
    PYTHONPATH=<checkout> python3 tpu_knn_torch/probes/staging.py [check|time|launches|save DIR]
    python3 tpu_knn_torch/probes/staging.py compare DIR_A DIR_B

The second form measures whichever checkout is on the path (run an older
tree and this one in turns in one chip call to compare them). Prints,
beside the card's name and power limit (nvidia-smi):

- check: B10's indices against B1's at the same partition count P
  (tuning.tiled_geometry's) at ds11 = (16, 1024, 2^20) and ds9 = (16, 1,
  2^24), and the compactor against its plain version at the seeded
  engine's ds11 K = 8 and (16, 1024, 2^22) K = 8 launches, each launch
  made twice; exits 1 on a difference;
- time (after check, by default): B10 and B1 at B1's P at ds11 and ds9
  (and B10 at the checkout's own P where it had one), the compactor at
  those two launches, each by CUDA events (median of 20, in turns) and by
  the kernel's own device time (torch.profiler), and v5 per call at ds11
  and ds9 (median of 5);
- launches: every compactor launch of one seeded topk_knn call at ds11
  K = 8, 32, 64, 128 and at (16, 1024, 2^22) K = 8 (captured by a spy on
  seeded.compact_cells), each timed alone by its device time;
- save DIR: the outputs of the kernels that share B10's template or
  headers (B1, B4, B3, B7, v3, v6) and of B10 and the compactor, and the
  sweep engine's top-K (B5, or B2 + B6 at m = 1), on inputs made on the
  card from a seed, written with torch.save to DIR/outputs.pt;
- compare DIR_A DIR_B: torch.equal of every saved output of two
  checkouts; the last line is {"identical": bool, "outputs": {...}}.
"""

from __future__ import annotations

import subprocess
import sys

DS11 = (16, 1024, 1 << 20)
DS9 = (16, 1, 1 << 24)

#: Kernel names in the profile: B10 (the TMA instance, or an older tree's
#: lane-per-thread kernel), B1, the compactor.
B10_KERNELS = ("tma_candidates_kernel", "dma_candidates_kernel")


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def _data(gen, device, shape):
    import torch

    from tpu_knn_torch.kernels.fused import prep_soa

    k, m, n = shape
    q = torch.rand((m, k), generator=gen, device=device)
    r = torch.rand((n, k), generator=gen, device=device)
    return q, r, prep_soa(r, n)


def _compactor_launch(q, r_op, n, kk):
    """(fields, parts, cap) as the seeded engine gives the compactor for
    (q, operand, K) on its fast tier."""
    from tpu_knn_torch.kernels import fused, seeded

    m, k = q.shape
    g = seeded.seeded_geometry(m, n, k, kk, r_op.shape[1])
    q_t = fused.transposed_queries(q)
    cs1 = fused.minima_candidates(q, r_op, n, depth=g["depth"], n_limit=g["p1_limit"], q_t=q_t)
    bound = seeded._inflate_bound(seeded._kth_smallest(cs1, kk))
    moms = seeded.extract_moments(q, r_op, n, bound, g["cell"], g["n_fields"], q_t=q_t)
    fields = [f.contiguous() for f in moms[:2 if g["n_fields"] == 8 else 1]]
    return fields, g["nparts"], min(g["cap_fast"], g["nc"] // g["nparts"])


def _cases(device):
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    b10 = {label: _data(gen, device, shape) for label, shape in (("ds11", DS11), ("ds9", DS9))}
    q, _, r_op = b10["ds11"]
    comp = {"ds11 K=8": _compactor_launch(q, r_op, DS11[2], 8)}
    q22 = torch.rand((1024, 16), generator=gen, device=device)
    r22 = torch.rand((1 << 22, 16), generator=gen, device=device)
    from tpu_knn_torch.kernels.fused import prep_soa

    comp["(16, 1024, 2^22) K=8"] = _compactor_launch(q22, prep_soa(r22, 1 << 22), 1 << 22, 8)
    return b10, comp


def check(b10, comp) -> bool:
    import torch

    from tpu_knn_torch.kernels import dma_pipeline, fused, seeded

    ok = True
    for label, (q, _, r_op) in b10.items():
        m, k = q.shape
        n = r_op.shape[1]
        p = fused.tiled_parts(m, k, n)
        want = fused.fused_candidates(q, r_op, n, p)[0]
        same = [torch.equal(dma_pipeline.dma_candidates(q, r_op, n, p), want) for _ in range(2)]
        print(f"B10 {label} at P = {p}: indices equal B1's in both launches: {all(same)}")
        ok &= all(same)
    for label, (fields, parts, cap) in comp.items():
        want = seeded.compact_cells_plain(fields, parts, cap)
        same = [all(torch.equal(g, w) for g, w in zip(seeded.compact_cells(fields, parts, cap),
                                                        want)) for _ in range(2)]
        nc = fields[0].shape[1]
        print(f"compactor {label}: {len(fields)} field(s), nc {nc}, {parts} part(s) x cap "
              f"{cap}: identical to plain in both launches: {all(same)}")
        ok &= all(same)
    torch.cuda.synchronize()
    return ok


def time_rows(b10, comp, card: str) -> None:
    import tpu_knn_torch
    from tpu_knn_torch.kernels import dma_pipeline, fused, seeded
    from tpu_knn_torch.utils.timing import device_ms, time_ms

    for label, (q, r, r_op) in b10.items():
        m, k = q.shape
        n = r_op.shape[1]
        p = fused.tiled_parts(m, k, n)
        fns = {f"B10 {label} P={p}": lambda: dma_pipeline.dma_candidates(q, r_op, n, p),
               f"B1 {label} P={p}": lambda: fused.fused_candidates(q, r_op, n, p)}
        if hasattr(dma_pipeline, "default_parts"):   # an older tree's own P
            p_own = dma_pipeline.default_parts(m, k, n)
            fns[f"B10 {label} own P={p_own}"] = lambda: dma_pipeline.dma_candidates(
                q, r_op, n, p_own)
        for name, ms in time_ms(fns, 20).items():
            print(f"time {name}: median {ms:.4f} ms [{card}]")
        for name, fn in fns.items():
            kernels = ("tiled_candidates_kernel",) if name.startswith("B1 ") else B10_KERNELS
            dev = {kn: v for kname in kernels for kn, v in device_ms({name: fn}, kname, 10).items()}
            print(f"device {name}: {sum(dev.values()):.4f} ms ({len(dev)} kernel(s)) [{card}]")
        per_call = time_ms({f"v5 per call {label}": lambda: tpu_knn_torch.knn_callback(
            k, m, n, q, r, version="v5")}, 5)
        for name, ms in per_call.items():
            print(f"time {name}: median {ms:.4f} ms [{card}]")
    for label, (fields, parts, cap) in comp.items():
        name = f"compactor {label}"
        fn = lambda: seeded.compact_cells(fields, parts, cap)   # noqa: E731
        print(f"time {name}: median {time_ms({name: fn}, 20)[name]:.4f} ms [{card}]")
        dev = device_ms({name: fn}, "compact_cells_kernel", 20)
        print(f"device {name}: {sum(dev.values()):.4f} ms [{card}]")


def compactor_launches(card: str) -> None:
    import torch

    from tpu_knn_torch.kernels import seeded, topk
    from tpu_knn_torch.utils.timing import device_ms

    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device)
    gen.manual_seed(13)
    q = torch.rand((1024, 16), generator=gen, device=device)
    r20 = torch.rand((1 << 20, 16), generator=gen, device=device)
    r22 = torch.rand((1 << 22, 16), generator=gen, device=device)
    kernel = seeded.compact_cells
    captured = []

    def spy(fields, parts, cap):
        captured.append(([f.clone() for f in fields], parts, cap))
        return kernel(fields, parts, cap)

    spy.launches = 0
    seeded.compact_cells = spy
    try:
        for label, r, kk in (("ds11 K=8", r20, 8), ("ds11 K=32", r20, 32),
                             ("ds11 K=64", r20, 64), ("ds11 K=128", r20, 128),
                             ("(16, 1024, 2^22) K=8", r22, 8)):
            captured.clear()
            topk.topk_knn(q, r, kk)
            for fields, parts, cap in list(captured):
                m, nc = fields[0].shape
                dev = device_ms({"c": lambda: kernel(fields, parts, cap)}, "compact_cells", 20)
                print(f"launch {label}: m {m}, nc {nc}, {parts} part(s) (width {nc // parts}), "
                      f"cap {cap}, {len(fields)} field(s), density "
                      f"{(fields[0] != 0).float().mean().item():.4f}: device "
                      f"{sum(dev.values()):.4f} ms [{card}]", flush=True)
    finally:
        seeded.compact_cells = kernel


#: (label, k, m, n) of save's B1-family outputs: ds11, a ragged wide-k
#: shape and m = 1.
SAVE_SHAPES = (("ds11", *DS11), ("k768", 768, 100, 5077), ("m1", 17, 1, 70_001))


def save(directory: str) -> None:
    import os

    import torch

    from tpu_knn_torch.kernels import dma_pipeline, fused, seeded, topk

    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device)
    gen.manual_seed(29)
    out = {}
    for label, k, m, n in SAVE_SHAPES:
        q = torch.rand((m, k), generator=gen, device=device)
        r = torch.rand((n, k), generator=gen, device=device)
        r_op = fused.prep_soa(r, -(-n // 128) * 128)
        p = fused.tiled_parts(m, k, n)
        b1 = fused.fused_candidates(q, r_op, n, p)
        out[f"B1 {label}"] = b1
        bound_s = b1[1].min(dim=1).values.contiguous()
        bound_i = b1[0].gather(1, b1[1].argmin(dim=1, keepdim=True)).squeeze(1).contiguous()
        out[f"B4 {label}"] = fused.banded_candidates(q, r_op, n, p, bound_s, bound_i)
        out[f"v3 {label}"] = fused.aos_candidates(q, r, n, p)
        if fused.const_query_fits(m, k):
            out[f"v6 {label}"] = fused.const_query_candidates(q, r_op, n, p)
        out[f"B3 {label}"] = fused.minima_candidates(q, r_op, n, depth=2)
        if k <= 32:   # where an older tree's lane-per-thread B10 had room
            out[f"B10 {label}"] = dma_pipeline.dma_candidates(q, r_op, n, p)
        # The sweep engine's answer (B5, or B2 + B6 at m <= 4): the same
        # across trees whose candidate layouts differ.
        out[f"sweep top-K {label}"] = topk.topk_knn(q, r, 8, method="sweep")
    b10, comp = _cases(device)
    q, _, r_op = b10["ds11"]
    out["B7 ds11 K=8"] = seeded.extract_moments(q, r_op, DS11[2], _bound(q, r_op), 256, 4)
    for label, (fields, parts, cap) in comp.items():
        out[f"compactor {label}"] = seeded.compact_cells(fields, parts, cap)
    os.makedirs(directory, exist_ok=True)
    torch.save({name: tuple(t.cpu() for t in (v if isinstance(v, tuple) else (v,)))
                for name, v in out.items()}, os.path.join(directory, "outputs.pt"))
    print(f"saved {len(out)} outputs to {directory}")


def _bound(q, r_op):
    """A per-row bound for B7: the 41st smallest of each row's B3 lane
    minima (depth 2)."""
    from tpu_knn_torch.kernels import fused

    s = fused.minima_candidates(q, r_op, r_op.shape[1], depth=2)
    return s.sort(dim=1).values[:, 40].contiguous()


def compare(dir_a: str, dir_b: str) -> bool:
    import json
    import os

    import torch

    a, b = (torch.load(os.path.join(d, "outputs.pt")) for d in (dir_a, dir_b))
    same = {name: name in b and all(torch.equal(x, y) for x, y in zip(a[name], b[name]))
            for name in a}
    ok = all(same.values()) and set(a) == set(b)
    print(json.dumps({"identical": ok, "outputs": same}))
    return ok


def main(argv) -> int:
    import torch

    what = argv[1] if len(argv) > 1 else "all"
    if what == "compare":
        return 0 if compare(argv[2], argv[3]) else 1
    if not torch.cuda.is_available():
        print("staging: no CUDA device", file=sys.stderr)
        return 2
    if what == "save":
        save(argv[2])
        return 0
    card = _card()
    print(card)
    if what == "launches":
        compactor_launches(card)
        return 0
    device = torch.device("cuda", 0)
    b10, comp = _cases(device)
    if not check(b10, comp):
        print("staging: a kernel differs from its reference", file=sys.stderr)
        return 1
    if what in ("time", "all"):
        time_rows(b10, comp, card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
