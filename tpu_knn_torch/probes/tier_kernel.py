"""The tensor-core tier kernels on their own (B1's tiers and B12, the
top-K kernels' tier instances B4, B3, B5 and B7, and the 1-NN ladder's v3,
B10 and v6 instances): outputs saved for a bit-for-bit comparison between two
checkouts, and their times at the main-path shapes.

    python3 tpu_knn_torch/probes/tier_kernel.py save DIR      # repo root, one H100
    python3 tpu_knn_torch/probes/tier_kernel.py compare DIR_A DIR_B
    python3 tpu_knn_torch/probes/tier_kernel.py time [ROW ...]
    python3 tpu_knn_torch/probes/tier_kernel.py launches

Run by path with PYTHONPATH=<checkout>, each mode measures whichever
checkout's tpu_knn_torch is on the path, so two checkouts compare in one
chip call (parent, change, change, parent for times).

- save: each instance of IDENTITY_CASES (every operand mode and term
  count, KC = 16 and 32, q resident and in the ring, ragged m and n) at a
  fixed partition count P, and each top-K instance of TOPK_CASES (B4's two
  passes, B3 at depths 1 and 2 and above lo, B5's lists at K = 1, 8 and
  32, B7 without and with a band, at m ragged against 64- and 128-row
  blocks), and v3's, B10's and v6's tier instances at LADDER_CASES (v6 at
  m = 1, 16, 21, 32, 33, 64, 100 and 200, k from 80 to 16384 at its
  guard's edge, every term list it runs, ragged n), on inputs
  made on the card from a seed, its outputs written with torch.save to
  DIR/<case>.pt;
- compare: torch.equal of every case's idx and score between two such
  directories; the last line is {"identical": bool, "cases": {...}};
- time: each row of PERF.md's kernel table that these kernels serve (or
  those named): B1's at its main-path shape and the checkout's own P
  (tiers.tier_parts), the top-K instances' (TOPK_TIMED_ROWS) at the
  launches their engines make at K = 8 (B5 also at its serving shapes),
  each with its "highest" launch
  beside it, and v3's and B10's (LADDER_TIMED_ROWS) at the checkout's own
  P (fused.ladder_parts) beside B1's tier launch (v6 also beside B1's tier
  at v6's P and its "highest" launch); by CUDA events (median)
  and the kernel's own device time (torch.profiler; v3 and B10 also split
  by kernel, so a norm pass shows apart); the last line is one JSON object
  of them;
- launches: the launches of v3's and B10's tier instances that
  chip_smoke.py's 1-NN ladder path makes (the runner's warm-up, the TA
  shapes, ds8..ds11, each through knn_callback), by row, shape and P.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

DS11 = (16, 1024, 1 << 20)
EMBED = (768, 1024, 1 << 20)
EMBED_TOPK = (768, 1024, 1 << 18)

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


#: v3's (AoS staging) and B10's (TMA staging) tier instances in `save`:
#: (case, rung, precision, k, m, n, P, misaligned): packed at ds11, at k =
#: 12 (v3's 9 terms) and at k = 3, m on each side of a 32- and a 128-row
#: block, an (n, k) array whose base is not 16-byte aligned (v3's 4-byte
#: copies), bf16x3 at k = 768 (32-row chunks, the q parts in the ring) and
#: k = 40 (16-row chunks).
LADDER_CASES = [
    (f"ladder {rung} {prec} k{k} m{m} n{n}{' misaligned' if odd else ''}", rung, prec, k, m, n,
     p, odd)
    for rung in ("v3", "v5")
    for prec, k, m, n, p, odd in (
        ("packed", 16, 1024, 1 << 20, 4, False), ("packed", 12, 1024, 1 << 18, 4, False),
        ("packed", 3, 1024, 1 << 18, 4, False),
        *[("packed", 16, m, 70_001, 5, False) for m in (1, 32, 33, 127, 129)],
        ("packed", 3, 1, 70_001, 5, False), ("packed", 12, 33, 70_001, 5, False),
        ("packed", 16, 65, 20_077, 3, True), ("packed", 3, 33, 20_077, 3, True),
        ("bf16x3", 768, 129, 20_000, 4, False), ("bf16x3", 768, 32, 20_000, 4, False),
        ("bf16x3", 40, 333, 50_001, 3, False), ("bf16x3", 40, 20, 50_001, 3, False))
    if not (odd and rung == "v5")] + [
    (f"ladder v6 {prec} k{k} m{m} n{n}", "v6", prec, k, m, n, p, False)
    for prec, k, m, n, p in (
        ("bf16x3", 16384, 1, 5003, 3), ("bf16x3", 768, 1, 70_001, 5),
        ("bf16x3", 1024, 16, 70_001, 5), ("bf16x3", 768, 16, 70_001, 5),
        ("bf16x3", 768, 21, 70_001, 5), ("bf16x3", 512, 32, 70_001, 5),
        ("bf16x3", 496, 33, 70_001, 5), ("bf16x3", 256, 64, 70_001, 5),
        ("bf16x3", 160, 100, 70_001, 5), ("bf16x3", 80, 200, 70_001, 5),
        ("bf16x4", 768, 16, 20_077, 3), ("bf16x4", 144, 100, 20_077, 3),
        ("default", 4000, 1, 20_077, 3), ("default", 512, 32, 20_077, 3),
        ("default", 208, 70, 20_077, 3), ("bf16x3", 96, 170, 20_077, 3))]

#: v3's and B10's rows of PERF.md's kernel table: (row, rung, precision,
#: (k, m, n)) at ds11, ds10, ds9, ds8 and the embedding width, and v6's
#: live-row instance's at its (768, 16, 2^20), at the guard's edge at k =
#: 768 (m = 1, 21), at a 64-row block full or nearly ((256, 64), (128,
#: 128)) and at two row tiles of B1's own launch ((96, 170)); each v6 row
#: also beside B1's tier at v6's P and v6's "highest" launch.
DS10, DS9, DS8 = (3, 1024, 1 << 20), (16, 1, 1 << 24), (3, 1, 1 << 24)
V6_SHAPES = [(768, 16, 1 << 20), (768, 1, 1 << 20), (768, 21, 1 << 20), (256, 64, 1 << 20),
             (128, 128, 1 << 20), (96, 170, 1 << 20)]
LADDER_TIMED_ROWS = [
    (f"{row} {name}", rung, precision, shape)
    for name, precision, shape in (("packed3 ds11", "packed", DS11),
                                   ("packed3 ds10", "packed", DS10),
                                   ("packed3 ds9", "packed", DS9),
                                   ("packed3 ds8", "packed", DS8),
                                   ("bf16x3", "bf16x3", EMBED_TOPK))
    for row, rung in (("B1 v3", "v3"), ("B10", "v5"))] + [
    ("B1 v6 bf16x3 live rows" if shape == V6_SHAPES[0] else f"B1 v6 bf16x3 {shape}", "v6",
     "bf16x3", shape) for shape in V6_SHAPES]

#: The kernels of each rung's tier launch (torch.profiler names).
LADDER_DEVICE = {"v3": ("tensor_aos",), "v5": ("tensor_tma", "tensor_candidates_norms"),
                 "v6": ("tensor_live", "CandidatesEpi", "tensor_candidates_norms")}
_B1_DEVICE = ("CandidatesEpi", "tensor_candidates_norms")

#: The top-K instances' cases of `save`: (case, precision, operand kind,
#: k, m, n); m = 1, 63, 65, 127, 129, 1023 lie on each side of a 64- and a
#: 128-row block, n is ragged against 128 and 256 columns.
TOPK_CASES = [
    *[(f"topk {prec} {kind} k{k} m{m}", prec, kind, k, m, n)
      for prec, kind, k in (("packed", "f32", 16), ("packed", "bf16", 16), ("packed", "f32", 32),
                            ("packed", "bf16", 32), ("bf16x3", "f32", 40), ("bf16x4", "f32", 32),
                            ("qsplit2", "bf16", 128), ("default", "f32", 16))
      for m, n in ((1, 30_001), (65, 20_077), (129, 9_999))],
    *[(f"topk {prec} {kind} k{k} m{m}", prec, kind, k, m, 40_003)
      for prec, kind, k in (("packed", "f32", 16), ("bf16x3", "f32", 768),
                            ("qsplit2", "bf16", 768))
      for m in (63, 127, 1023)],
]

#: The top-K instances' rows of PERF.md's kernel table, ranked there by
#: launches x (device ms - bound ms): (row, kernel, precision, operand
#: kind, (k, m, n), K), each launch as its engine makes it at K: B3 as the
#: seeded engine launches it ("B3-d2": at depth 2 over the same prefix,
#: "B3-band": at depth 1 above a lo), B5 at ds11, at the embedding width
#: and at the serving shapes auto sends it (m * K <= 256).
SERVE8, SERVE32 = (16, 8, 1 << 20), (16, 32, 1 << 20)
TOPK_TIMED_ROWS = [
    ("B4 bf16x3", "B4", "bf16x3", "f32", EMBED_TOPK, 8),
    ("B7 packed3", "B7", "packed", "f32", DS11, 8),
    ("B4 packed3", "B4", "packed", "f32", DS11, 8),
    ("B3 packed3", "B3", "packed", "f32", DS11, 8),
    ("B3 packed3 depth 2", "B3-d2", "packed", "f32", DS11, 8),
    ("B3 packed3 band", "B3-band", "packed", "f32", DS11, 8),
    ("B3-bf16 packed3", "B3", "packed", "bf16", DS11, 8),
    ("B3 bf16x3", "B3", "bf16x3", "f32", EMBED_TOPK, 8),
    ("B3-bf16 qsplit2", "B3", "qsplit2", "bf16", EMBED_TOPK, 8),
    ("B4-bf16 packed3", "B4", "packed", "bf16", DS11, 8),
    ("B7 bf16x3", "B7", "bf16x3", "f32", EMBED_TOPK, 8),
    ("B4-bf16 qsplit2", "B4", "qsplit2", "bf16", EMBED_TOPK, 8),
    ("B5 packed3", "B5", "packed", "f32", DS11, 8),
    ("B5-bf16 packed3", "B5", "packed", "bf16", DS11, 8),
    ("B5 bf16x3", "B5", "bf16x3", "f32", EMBED_TOPK, 8),
    ("B5-bf16 qsplit2", "B5", "qsplit2", "bf16", EMBED_TOPK, 8),
    ("B5 packed3 (16, 8, 2^20) K=32", "B5", "packed", "f32", SERVE8, 32),
    ("B5 packed3 (16, 32, 2^20) K=8", "B5", "packed", "f32", SERVE32, 8),
    ("B1 packed3 beside highest", "B1", "packed", "f32", DS11, 8),
]

#: The kernels each instance's device time holds (torch.profiler names).
_B3_DEVICE = ("MinimaEpi", "tensor_candidates_norms", "minima_merge", "minima_init")
TOPK_DEVICE = {"B1": ("CandidatesEpi", "tensor_candidates_norms"),
               "B4": ("BandedEpi", "tensor_candidates_norms"),
               "B5": ("SweepEpi", "tensor_candidates_norms"),
               "B3": _B3_DEVICE, "B3-d2": _B3_DEVICE, "B3-band": _B3_DEVICE,
               "B7": ("MomentsEpi", "tensor_candidates_norms")}


def topk_launches(q, r_op, n, precision, kk=8, parts=None):
    """kernel id -> a call of B1, B4, B5, B3 and B7 at the launches the
    engines make over (q, r_op) at K = kk: B1's candidates at its tier's
    P, B4's second pass of the passes engine (the band at the first pass's
    lexicographic minimum), B5's lists, B3 and B7 as the seeded engine
    launches them (B7's bound from B3's inflated K-th minimum), B5 also at
    K = 1 and 32 ("B5-k1", "B5-k32"), B3 at depth 2 ("B3-d2") and above lo,
    half that bound ("B3-band"), over the same prefix, and "B7-band", B7
    with a band below half that bound and the remainder minima (the rounds
    engine's instance). ``parts``: B1's, B4's and B5's
    partition count (else each its engine's), so that two trees whose
    geometries differ compare at one P (B3's and B7's outputs do not
    depend on theirs)."""
    import torch

    from tpu_knn_torch.kernels import fused, seeded, tiers, topk

    m, k = q.shape
    p1 = parts or tiers.tier_parts(precision, m, k, n)
    p4 = parts or fused.banded_parts(precision, m, k, n)
    q_t = fused.transposed_queries(q) if precision == "highest" else None
    b_s = torch.full((m,), -torch.inf, device=q.device)
    b_i = torch.full((m,), -1, dtype=torch.int32, device=q.device)
    i1, s1 = topk._lex_min(*fused.banded_candidates(q, r_op, n, p4, b_s, b_i, q_t, precision))
    p5 = parts or topk.sweep_parts(m, k, n, precision)
    g = seeded.seeded_geometry(m, n, k, kk, r_op.shape[1], precision)
    cs1 = fused.minima_candidates(q, r_op, n, depth=g["depth"], n_limit=g["p1_limit"], q_t=q_t,
                                  precision=precision)
    bound = seeded._inflate_bound(seeded._kth_smallest(cs1, kk))
    lo = bound - bound.abs() * 0.5
    return {
        "B1": lambda: (fused.fused_candidates(q, r_op, n, p1) if precision == "highest"
                       else tiers.tensor_candidates(q, r_op, n, p1, precision)),
        "B4": lambda: fused.banded_candidates(q, r_op, n, p4, s1, i1, q_t, precision),
        "B5": lambda: topk.sweep_candidates(q, r_op, n, p5, kk, precision),
        "B5-k1": lambda: topk.sweep_candidates(q, r_op, n, p5, 1, precision),
        "B5-k32": lambda: topk.sweep_candidates(q, r_op, n, p5, 32, precision),
        "B3": lambda: fused.minima_candidates(q, r_op, n, depth=g["depth"],
                                              n_limit=g["p1_limit"], q_t=q_t,
                                              precision=precision),
        "B3-d2": lambda: fused.minima_candidates(q, r_op, n, depth=2, n_limit=g["p1_limit"],
                                                 q_t=q_t, precision=precision),
        "B3-band": lambda: fused.minima_candidates(q, r_op, n, lo=lo, n_limit=g["p1_limit"],
                                                   q_t=q_t, precision=precision),
        "B7": lambda: seeded.extract_moments(q, r_op, n, bound, g["cell"], g["n_fields"],
                                             q_t=q_t, precision=precision),
        "B7-band": lambda: seeded.extract_moments(q, r_op, n, bound, g["cell"], g["n_fields"],
                                                  lo=lo, emit_rem=True, q_t=q_t,
                                                  precision=precision),
    }


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
    for i, (case, precision, kind, k, m, n) in enumerate(TOPK_CASES):
        q, (r_op,) = _operands(device, 9200 + i, kind, k, m, n)
        for kid, fn in topk_launches(q, r_op, n, precision, parts=3).items():
            outs = fn()
            outs = tuple(t.cpu() for t in (outs if isinstance(outs, tuple) else (outs,))
                         if t is not None)
            torch.cuda.synchronize()
            name = f"{case} {kid}"
            torch.save(outs, os.path.join(out_dir, name.replace(" ", "_") + ".pt"))
            digest = hashlib.sha256(b"".join(t.numpy().tobytes() for t in outs)).hexdigest()
            print(f"{name}: k={k} m={m} n={n} sha256 {digest[:16]}")
        del q, r_op
        torch.cuda.empty_cache()
    for i, case in enumerate(LADDER_CASES):
        outs = _ladder_launch(device, 9400 + i, *case[1:])()
        outs = tuple(t.cpu() for t in (outs if isinstance(outs, tuple) else (outs,)))
        torch.cuda.synchronize()
        torch.save(outs, os.path.join(out_dir, case[0].replace(" ", "_") + ".pt"))
        digest = hashlib.sha256(b"".join(t.numpy().tobytes() for t in outs)).hexdigest()
        print(f"{case[0]}: P={case[6]} sha256 {digest[:16]}")
        torch.cuda.empty_cache()
    return 0


def _ladder_launch(device, seed, rung, precision, k, m, n, parts, misaligned=False):
    """A call of a rung's tier instance ("v3": fused.aos_candidates over
    the (n, k) array, its base one float past 16-byte alignment where
    ``misaligned``; "v5": dma_pipeline.dma_candidates, "v6":
    fused.const_query_candidates over the SoA operand) on inputs made from
    a seed."""
    import torch

    from tpu_knn_torch.kernels import dma_pipeline, fused

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    q = torch.rand((m, k), generator=gen, device=device)
    r = torch.rand((n, k), generator=gen, device=device)
    if rung in ("v5", "v6"):
        r_op = fused.prep_soa(r, -(-n // 128) * 128)
        fn = dma_pipeline.dma_candidates if rung == "v5" else fused.const_query_candidates
        return lambda: fn(q, r_op, n, parts, precision)
    if misaligned:
        flat = torch.zeros(n * k + 1, device=device)
        r = flat[1:].view(n, k)
        r.copy_(torch.rand((n, k), generator=gen, device=device))
    return lambda: fused.aos_candidates(q, r, n, parts, precision)


def _case_names():
    """Every case `save` writes, as (name, whether its tier is packed)."""
    from tpu_knn_torch.kernels.tiers import resolved_tier

    names = [(case, resolved_tier(prec, k).startswith("packed"))
             for case, prec, _, k, *_ in IDENTITY_CASES]
    names += [(f"{case} {kid}", resolved_tier(prec, k).startswith("packed"))
              for case, prec, _, k, _, _ in TOPK_CASES
              for kid in ("B1", "B4", "B5", "B5-k1", "B5-k32", "B3", "B3-d2", "B3-band", "B7",
                          "B7-band")]
    # The ladder's instances change no arithmetic: every case must be identical.
    names += [(case[0], False) for case in LADDER_CASES]
    return names


def compare(dir_a: str, dir_b: str) -> int:
    import torch

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    cases, packed = {}, {}
    for case, is_packed in _case_names():
        name = case.replace(" ", "_") + ".pt"
        a, b = (torch.load(os.path.join(d, name)) for d in (dir_a, dir_b))
        diff = [int((bits(x) != bits(y)).sum()) for x, y in zip(a, b)]
        same = len(a) == len(b) and not any(diff)
        (packed if is_packed else cases)[case] = same
        print(f"{case}: {'identical' if same else 'DIFFERENT'}"
              + ("" if same else f" ({diff} elements of each output differ)")
              + (" [packed]" if is_packed else ""))
    # A packed tier's scores may change with the arithmetic of its sum;
    # every other case must be identical.
    print(json.dumps({"identical": all(cases.values()), "cases": cases,
                      "packed_identical": packed}))
    return 0 if all(cases.values()) else 1


def time_rows(names) -> int:
    import torch

    from tpu_knn_torch.kernels import fused, tiers
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
    for i, (row, kid, precision, kind, (k, m, n), kk) in enumerate(TOPK_TIMED_ROWS):
        if names and row not in names:
            continue
        q, (r_op,) = _operands(device, 9700 + i, kind, k, m, n)
        fn = topk_launches(q, r_op, n, precision, kk)[kid]
        high = topk_launches(q, r_op, n, "highest", kk)[kid]
        reps = 5 if k >= 128 else 10
        ev = time_ms({row: fn, "highest": high}, reps)
        dev = sum(device_ms({"fn": fn}, TOPK_DEVICE[kid], reps).values())
        out[row] = {"ms": ev[row], "device_ms": dev, "highest_ms": ev["highest"]}
        print(f"{row}: {precision} {kind} (k={k}, m={m}, n={n}) K={kk}: {ev[row]:.4f} ms (device "
              f"{dev:.4f}), its highest launch {ev['highest']:.4f} ms [{card}]")
        del q, r_op, fn, high
        torch.cuda.empty_cache()
    for i, (row, rung, precision, (k, m, n)) in enumerate(LADDER_TIMED_ROWS):
        if names and row not in names:
            continue
        parts = fused.ladder_parts(rung, precision, m, k, n)
        fn = _ladder_launch(device, 9900 + i, rung, precision, k, m, n, parts)
        q, r_op = (torch.rand((m, k), device=device),
                   fused.prep_soa(torch.rand((n, k), device=device), -(-n // 128) * 128))
        p1 = tiers.tier_parts(precision, m, k, n)
        b1 = lambda: tiers.tensor_candidates(q, r_op, n, p1, precision)  # noqa: E731
        reps = 5 if k >= 128 else 10
        fns = {row: fn, "B1": b1}
        if rung == "v6":   # B1's tier at v6's P and v6's "highest" launch beside it
            ph = fused.ladder_parts(rung, "highest", m, k, n)
            fns["B1 same P"] = lambda: tiers.tensor_candidates(q, r_op, n, parts, precision)
            fns["highest"] = lambda: fused.const_query_candidates(q, r_op, n, ph)
        ev = time_ms(fns, reps)
        split = device_ms({"fn": fn}, LADDER_DEVICE[rung], reps)
        dev = sum(split.values())
        dev1 = sum(device_ms({"fn": b1}, _B1_DEVICE, reps).values())
        out[row] = {"P": parts, "ms": ev[row], "device_ms": dev,
                    "device_split": {name[:60]: t for name, t in split.items()},
                    "B1_P": p1, "B1_ms": ev["B1"], "B1_device_ms": dev1}
        parts_of = "; ".join(f"{name[:40]} {t:.4f}" for name, t in split.items())
        beside = ""
        if rung == "v6":
            dev_p = sum(device_ms({"fn": fns["B1 same P"]}, _B1_DEVICE, reps).values())
            dev_h = sum(device_ms({"fn": fns["highest"]}, ("tiled_candidates",), reps).values())
            out[row].update(B1_same_P_ms=ev["B1 same P"], B1_same_P_device_ms=dev_p,
                            highest_P=ph, highest_ms=ev["highest"], highest_device_ms=dev_h)
            beside = (f", B1's tier at v6's P {ev['B1 same P']:.4f} ms (device {dev_p:.4f}), "
                      f"'highest' at P={ph} {ev['highest']:.4f} ms (device {dev_h:.4f})")
        print(f"{row}: {precision} (k={k}, m={m}, n={n}) P={parts}: {ev[row]:.4f} ms (device "
              f"{dev:.4f}: {parts_of}), B1's tier at P={p1} {ev['B1']:.4f} ms (device "
              f"{dev1:.4f}){beside} [{card}]")
        if rung == "v6" and hasattr(tiers, "LIVE_PLANS"):
            out[row]["plans"] = _live_plans(device, 9900 + i, precision, k, m, n, reps, card)
        del q, r_op, fn, b1, fns
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


def _live_plans(device, seed, precision, k, m, n, reps, card):
    """v6's live-row instance at each plan of tiers.LIVE_PLANS whose budget
    holds the live rows' parts (tiers.tensor_live_epilogue's choice and the
    others), each at its own P: {plan: {"P", "ms", "device_ms"}}."""
    from tpu_knn_torch.kernels import fused, tiers
    from tpu_knn_torch.utils.timing import device_ms, time_ms

    terms, k16 = tiers.ladder_terms(precision, k), -(-k // 16) * 16
    if tiers.tensor_q_resident(terms, k16):
        return {}
    chosen, out = tiers.tensor_live_epilogue, {}
    try:
        for plan in tiers.LIVE_PLANS:
            tiers.tensor_live_epilogue = lambda *_, plan=plan: plan
            if tiers.tensor_live_q_bytes(terms, m, k16) > tiers._live_q_budget(plan):
                continue
            parts = fused.ladder_parts("v6", precision, m, k, n)
            fn = _ladder_launch(device, seed, "v6", precision, k, m, n, parts)
            ev = time_ms({plan: fn}, reps)[plan]
            dev = sum(device_ms({"fn": fn}, LADDER_DEVICE["v6"], reps).values())
            out[plan] = {"P": parts, "ms": ev, "device_ms": dev}
            mark = " (chosen)" if plan == chosen(terms, m, k16) else ""
            print(f"  v6 (k={k}, m={m}, n={n}) plan {plan}{mark} P={parts}: {ev:.4f} ms "
                  f"(device {dev:.4f}) [{card}]")
    finally:
        tiers.tensor_live_epilogue = chosen
    return out


def ladder_launches(run):
    """(run()'s result, a Counter of the ladder's tier launches it made by
    (row, (k, m, n), P)), from a spy on tiers._ladder_launch."""
    import collections

    from tpu_knn_torch.kernels import tiers

    seen = collections.Counter()
    launch = tiers._ladder_launch

    def spy(entry, rung, q, operand, n, parts, precision, *args, **kwargs):
        m, k = q.shape
        seen[tiers.ladder_tier_row(rung, precision, k), (k, m, n), parts] += 1
        return launch(entry, rung, q, operand, n, parts, precision, *args, **kwargs)

    tiers._ladder_launch = spy
    try:
        return run(), seen
    finally:
        tiers._ladder_launch = launch


def launches() -> int:
    """The launches of v3's and B10's tier instances that chip_smoke.py's
    1-NN ladder path makes (harness.runner.warm_up's shape, the TA shapes,
    ds8..ds11, each through knn_callback with v3 and v5), by row, (k, m,
    n) and P."""
    import torch

    import tpu_knn_torch
    from tpu_knn_torch.harness.generator import BIG_SHAPES, TA_SHAPES

    def run():
        for k, m, n in ((4, 1, 1 << 12), *TA_SHAPES, *BIG_SHAPES):
            q, r = torch.rand((m, k), device="cuda"), torch.rand((n, k), device="cuda")
            for v in ("v3", "v5"):
                tpu_knn_torch.knn_callback(k, m, n, q, r, version=v)

    _, seen = ladder_launches(run)
    for (row, shape, parts), c in sorted(seen.items()):
        print(f"{row} (k, m, n) = {shape} P={parts}: {c}")
    print(json.dumps([[row, list(shape), parts, c] for (row, shape, parts), c in
                      sorted(seen.items())]))
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
    if argv == ["launches"]:
        return launches()
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
