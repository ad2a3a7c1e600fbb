"""The tensor-core tier kernel (B1's tiers and B12) on its own: outputs
saved for a bit-for-bit comparison between two checkouts, and its times at
the main-path shapes.

    python3 tpu_knn_torch/probes/tier_kernel.py save DIR      # repo root, one H100
    python3 tpu_knn_torch/probes/tier_kernel.py compare DIR_A DIR_B
    python3 tpu_knn_torch/probes/tier_kernel.py time [ROW ...]

Run by path with PYTHONPATH=<checkout>, each mode measures whichever
checkout's tpu_knn_torch is on the path, so two checkouts compare in one
chip call (parent, change, change, parent for times).

- save: each instance of IDENTITY_CASES (every operand mode and term
  count, KC = 16 and 32, q resident and in the ring, ragged m and n) at a
  fixed partition count P, on inputs made on the card from a seed, its
  (idx, score) written with torch.save to DIR/<case>.pt;
- compare: torch.equal of every case's idx and score between two such
  directories; the last line is {"identical": bool, "cases": {...}};
- time: each row of PERF.md's kernel table that this kernel serves (or
  those named), at its main-path shape and the checkout's own P
  (tiers.tier_parts), by CUDA events (median) and the kernel's own device
  time (torch.profiler); the last line is one JSON object of them.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

DS11 = (16, 1024, 1 << 20)
EMBED = (768, 1024, 1 << 20)

#: (case, precision, operand kind, k, m, n, P).
IDENTITY_CASES = [
    *[(f"{prec} {kind} ds11 P{p}", prec, kind, *DS11, p)
      for p in (4, 33)
      for prec, kind in (("packed", "f32"), ("bf16x4", "f32"), ("default", "f32"),
                         ("bf16x3", "f32"), ("bf16x3_presplit", "presplit"),
                         ("packed", "bf16"), ("qsplit2", "bf16"))],
    ("packed k3 f32", "packed", "f32", 3, 1024, 1 << 20, 8),            # T = 9
    ("packed k16 f32 m20", "packed", "f32", 16, 20, 30_000, 5),          # rows past m
    ("packed2 f32", "packed", "f32", 32, 1024, 1 << 20, 4),              # KC 32, q resident
    *[(f"{prec} {kind} k768", prec, kind, 768, 1024, 1 << 17, p)
      for prec, kind, p in (("bf16x3", "f32", 4), ("qsplit2", "bf16", 4), ("default", "f32", 7),
                            ("bf16x4", "f32", 3), ("bf16x3_presplit", "presplit", 4),
                            ("qsplit2", "f32", 4), ("packed", "bf16", 5))],
    ("bf16x3 f32 k128 ragged", "bf16x3", "f32", 128, 1000, 100_003, 6),  # q resident, KC 32
    *[(f"{prec} {kind} k40", prec, kind, 40, 333, 50_001, 3)              # KC 16
      for prec, kind in (("bf16x3", "f32"), ("qsplit2", "bf16"), ("bf16x3_presplit", "presplit"),
                         ("bf16x4", "f32"), ("bf16_raw", "bf16"))],
]

#: PERF.md's rows of this kernel: (row, precision, operand kind, (k, m, n)).
TIMED_ROWS = [
    ("B1 packed3", "packed", "f32", DS11),
    ("B1 packed2", "packed", "f32", (32, *DS11[1:])),
    ("B1 bf16x4", "bf16x4", "f32", DS11),
    ("B1 default", "default", "f32", DS11),
    ("B12", "bf16x3_presplit", "presplit", DS11),
    ("B1 packed3 (bf16 store)", "packed", "bf16", DS11),
    ("B1 bf16x3 k=128", "bf16x3", "f32", (128, *EMBED[1:])),
    ("B1 qsplit2 k=128", "qsplit2", "bf16", (128, *EMBED[1:])),
    ("B1 bf16x3", "bf16x3", "f32", EMBED),
    ("B1 qsplit2", "qsplit2", "bf16", EMBED),
]


def _operands(device, seed, kind, k, m, n):
    """(q, the kernel's operands) from a seed: an f32 SoA operand, a bf16
    store's, or B12's (hi, lo, ‖r‖²)."""
    import torch

    from tpu_knn_torch.kernels.fused import prep_soa
    from tpu_knn_torch.kernels.tiers import presplit_ops

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n_pad = -(-n // 128) * 128
    q = torch.rand((m, k), generator=gen, device=device)
    r = torch.rand((n, k), generator=gen, device=device)
    if kind == "bf16":
        return q, (prep_soa(r.to(torch.bfloat16), n_pad),)
    if kind == "presplit":
        return q, presplit_ops(r, n_pad)
    return q, (prep_soa(r, n_pad),)


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def save(out_dir: str) -> int:
    import hashlib

    import torch

    from tpu_knn_torch.kernels import tiers

    device = torch.device("cuda", 0)
    os.makedirs(out_dir, exist_ok=True)
    for i, (case, precision, kind, k, m, n, parts) in enumerate(IDENTITY_CASES):
        q, ops = _operands(device, 9000 + i, kind, k, m, n)
        idx, score = tiers.tier_candidates(q, ops, n, parts, precision)
        torch.cuda.synchronize()
        idx, score = idx.cpu(), score.cpu()
        torch.save((idx, score), os.path.join(out_dir, case.replace(" ", "_") + ".pt"))
        digest = hashlib.sha256(idx.numpy().tobytes() + score.numpy().tobytes()).hexdigest()
        print(f"{case}: k={k} m={m} n={n} P={parts} sha256 {digest[:16]}")
        del q, ops
        torch.cuda.empty_cache()
    return 0


def compare(dir_a: str, dir_b: str) -> int:
    import torch

    cases = {}
    for case, *_ in IDENTITY_CASES:
        name = case.replace(" ", "_") + ".pt"
        (ia, sa), (ib, sb) = (torch.load(os.path.join(d, name)) for d in (dir_a, dir_b))
        same = torch.equal(ia, ib) and torch.equal(sa.view(torch.int32), sb.view(torch.int32))
        cases[case] = same
        print(f"{case}: {'identical' if same else 'DIFFERENT'}"
              + ("" if same else f" ({int((ia != ib).sum())} indices, "
                 f"{int((sa.view(torch.int32) != sb.view(torch.int32)).sum())} scores differ)"))
    print(json.dumps({"identical": all(cases.values()), "cases": cases}))
    return 0 if all(cases.values()) else 1


def time_rows(names) -> int:
    import torch

    from tpu_knn_torch.kernels import tiers
    from tpu_knn_torch.utils.timing import device_ms, time_ms

    device = torch.device("cuda", 0)
    card = _card()
    print(card)
    out = {"card": card}
    for i, (row, precision, kind, (k, m, n)) in enumerate(TIMED_ROWS):
        if names and row not in names:
            continue
        q, ops = _operands(device, 9500 + i, kind, k, m, n)
        parts = tiers.tier_parts(precision, m, k, n)
        reps = 5 if k >= 128 else 10
        fn = lambda: tiers.tier_candidates(q, ops, n, parts, precision)  # noqa: E731
        ev = time_ms({row: fn}, reps)[row]
        dev = sum(device_ms({"fn": fn}, ("CandidatesEpi", "tensor_candidates_norms"),
                            reps).values())
        out[row] = {"P": parts, "ms": ev, "device_ms": dev}
        print(f"{row}: {precision} {kind} (k={k}, m={m}, n={n}) P={parts}: {ev:.4f} ms "
              f"(device {dev:.4f}) [{card}]")
        del q, ops
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("tier_kernel: no CUDA device", file=sys.stderr)
        return 2
    if argv[:1] == ["save"] and len(argv) == 2:
        return save(argv[1])
    if argv[:1] == ["compare"] and len(argv) == 3:
        return compare(argv[1], argv[2])
    if argv[:1] == ["time"]:
        return time_rows(argv[1:])
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
