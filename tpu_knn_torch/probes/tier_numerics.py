"""Score error and time of the tensor-core tier kernels over several seeds,
and B1 "highest" refined over its P partitions' lanes or over the merged
128.

    python3 -m tpu_knn_torch.probes.tier_numerics      # repo root, one H100
    PYTHONPATH=<checkout> python3 tpu_knn_torch/probes/tier_numerics.py packed
    python3 -m tpu_knn_torch.probes.tier_numerics default

Prints, beside the card's name and power limit (nvidia-smi):

1. for each tier instance (B1's tiers and B12) on phase 1's grid of
   chip_smoke.py (k = 1 ... 768, ragged n) and at the main path's shapes,
   the largest relative score error against an f64 recomputation
   (tiers.score_errors) over SEEDS seeds, and the smallest headroom to the
   tier's gate (tiers.tier_error_gate) and to its `_TIER_EPS`;
2. the kernel's time (CUDA-event medians) at the main-path shapes;
3. B1 "highest" plus the refine (fused._refine with the tier's cutoff) at
   ds11, (16, 64, 2^20) and the embed shapes, over the kernel's P*128
   lanes and over the lanes merged to 128 (tiers.merge_partitions), with
   the two answers compared.

The last line is one JSON object of these numbers.

`packed`: each packed tier's score error, seed by seed, at ds11 (packed3)
and (32, 1024, 2^20) (packed2) over f32 and bf16 operands, with its share
of the gate; run by path with PYTHONPATH=<checkout> it measures that
checkout, so an older tree's arithmetic and this one's compare in one
chip call. `default`: the harness's gate errors (an index that is not
the exact scan's and whose true distance is off by more than 1e-3) of
fused_knn(precision="default") at ds11 and (768, 1024, 2^20) over SEEDS
data sets.
"""

from __future__ import annotations

import json
import subprocess
import sys


#: Data sets (generator seeds) each tier instance is measured over.
SEEDS = 5


def _operands(gen, device, kind, k, m, n):
    """(q, stored points (n, k) f32, the kernel's operands): "f32" an f32
    SoA operand, "bf16" a bf16 store's, "int8" an int8 grid's per-call bf16
    operand with grid-space queries, "presplit" B12's (hi, lo, ‖r‖²)."""
    import torch

    from tpu_knn_torch.kernels.fused import prep_soa
    from tpu_knn_torch.kernels.tiers import presplit_ops

    n_pad = -(-n // 128) * 128
    q = torch.rand((m, k), generator=gen, device=device)
    if kind == "int8":
        g = torch.randint(-127, 128, (n, k), generator=gen, device=device, dtype=torch.int8)
        return q * 254.0 - 127.0, g.float(), (prep_soa(g.to(torch.bfloat16), n_pad),)
    r = torch.rand((n, k), generator=gen, device=device)
    if kind == "bf16":
        r = r.to(torch.bfloat16)
        return q, r.float(), (prep_soa(r, n_pad),)
    if kind == "presplit":
        return q, r, presplit_ops(r, n_pad)
    return q, r, (prep_soa(r, n_pad),)


def _cases():
    """(row, precision, operand kind, k, m, n, timed): chip_smoke.py's
    phase-1 grid and main-path shapes."""
    n_t, big = 20_077, (1024, 1 << 20)
    cases = []
    for k in (1, 3, 16, 24, 32, 40, 128, 768):
        n_k = n_t if k < 768 else 5077
        if k <= 32:
            row = "packed3" if -(-k // 8) * 8 <= 16 else "packed2"
            cases += [(row, "packed", "f32", k, 100, n_k, False),
                      (row, "packed", "bf16", k, 33, n_k, False)]
        else:
            cases += [("bf16x3", "bf16x3", "f32", k, 100, n_k, False),
                      ("qsplit2", "qsplit2", "bf16", k, 33, n_k, False),
                      ("qsplit2", "qsplit2", "int8", k, 70, n_k, False)]
        cases += [("B12", "bf16x3_presplit", "presplit", k, 64, n_k, False)]
    cases += [("bf16x4", "bf16x4", "f32", k, 50, n_t, False) for k in (16, 40)]
    cases += [("packed3", "packed", "f32", 16, *big, True),
              ("B12", "bf16x3_presplit", "presplit", 16, *big, True),
              ("bf16x4", "bf16x4", "f32", 16, *big, True),
              ("packed2", "packed", "f32", 32, *big, True),
              ("bf16x3", "bf16x3", "f32", 768, *big, True),
              ("qsplit2", "qsplit2", "bf16", 768, *big, True)]
    return cases


def tier_errors(device):
    import torch

    from tpu_knn_torch.kernels import fused, tiers
    from tpu_knn_torch.utils.timing import time_ms

    errors, times = {}, {}
    for row, precision, kind, k, m, n, timed in _cases():
        key = f"{row} k={k} {kind}" + (" main" if timed else "")
        for seed in range(SEEDS):
            gen = torch.Generator(device=device)
            gen.manual_seed(1000 + seed)
            q, pts, ops = _operands(gen, device, kind, k, m, n)
            parts = tiers.tier_parts(precision, m, k, n)
            ki, ks = tiers.tier_candidates(q, ops, n, parts, precision)
            err = tiers.score_errors(q, pts, ki, ks)[0]
            pi, ps = tiers.tier_candidates_plain(q, ops, n, parts, precision)
            plain = tiers.score_errors(q, pts, pi, ps)[0]
            gate = tiers.tier_error_gate(precision, k, plain)
            eps = fused._TIER_EPS.get(tiers.resolved_tier(precision, k), 2.0 ** -8)
            e = errors.setdefault(key, {"err": 0.0, "plain": 0.0, "over_gate": 0.0,
                                        "over_eps": 0.0})
            e["err"] = max(e["err"], err)
            e["plain"] = max(e["plain"], plain)
            e["over_gate"] = max(e["over_gate"], err / gate)
            e["over_eps"] = max(e["over_eps"], err / eps)
            if timed and seed == 0:
                times[key] = time_ms({key: lambda: tiers.tier_candidates(
                    q, ops, n, parts, precision)}, 10)[key]
            del q, pts, ops, ki, ks, pi, ps
            torch.cuda.empty_cache()
        print(f"  {key} (m={m}, n={n}): score error {errors[key]['err']:.3g} (plain "
              f"{errors[key]['plain']:.3g}) over {SEEDS} seeds; largest share of the gate "
              f"{errors[key]['over_gate']:.3f}, of _TIER_EPS {errors[key]['over_eps']:.1f}"
              + (f"; kernel {times[key]:.4f} ms" if key in times else ""), flush=True)
    return errors, times


#: The packed tiers' rows of `packed`: (row, operand kind, k) at m = 1024,
#: n = 2^20.
PACKED_ROWS = [("packed3", "f32", 16), ("packed3", "bf16", 16), ("packed2", "f32", 32),
               ("packed2", "bf16", 32)]


def packed_errors(device):
    """Each packed tier's score error per seed at the main path's shapes,
    and its share of tiers.tier_error_gate."""
    import torch

    from tpu_knn_torch.kernels import tiers

    m, n = 1024, 1 << 20
    out = {}
    for row, kind, k in PACKED_ROWS:
        key = f"{row} {kind} ({k}, {m}, 2^20)"
        out[key] = []
        for seed in range(SEEDS):
            gen = torch.Generator(device=device)
            gen.manual_seed(1000 + seed)
            q, pts, ops = _operands(gen, device, kind, k, m, n)
            parts = tiers.tier_parts("packed", m, k, n)
            ki, ks = tiers.tier_candidates(q, ops, n, parts, "packed")
            err = tiers.score_errors(q, pts, ki, ks)[0]
            pi, ps = tiers.tier_candidates_plain(q, ops, n, parts, "packed")
            plain = tiers.score_errors(q, pts, pi, ps)[0]
            share = err / tiers.tier_error_gate("packed", k, plain)
            out[key].append({"err": err, "plain": plain, "share": share})
            print(f"  {key} seed {seed}: score error {err:.4g} (plain {plain:.4g}), "
                  f"{share:.3f} of the gate", flush=True)
            del q, pts, ops, ki, ks, pi, ps
            torch.cuda.empty_cache()
    return out


def _exact_scan(q, r, chunk_elems=1 << 28):
    """Exact 1-NN on the card: a chunked diff-form scan, lowest index on
    ties (chip_smoke.py's exact_scan)."""
    import torch

    m, k = q.shape
    chunk = max(1, chunk_elems // (m * k))
    best_d = torch.full((m,), torch.inf, device=q.device)
    best_i = torch.zeros((m,), dtype=torch.int64, device=q.device)
    for start in range(0, r.shape[0], chunk):
        rc = r[start:start + chunk]
        d = ((q[:, None, :] - rc[None, :, :]) ** 2).sum(dim=-1)
        v = d.min(dim=1).values
        col = torch.arange(rc.shape[0], device=q.device)
        i = torch.where(d == v[:, None], col, rc.shape[0]).min(dim=1).values + start
        take = v < best_d
        best_i = torch.where(take, i, best_i)
        best_d = torch.where(take, v, best_d)
    return best_i


def default_gate(device):
    """Gate errors of fused_knn(precision="default") per data set: indices
    that are not the exact scan's and whose true distance differs from
    its by more than the harness's tolerance."""
    import torch

    from tpu_knn_torch.harness.checker import TOLERANCE
    from tpu_knn_torch.kernels.fused import fused_knn

    out = {}
    for k, m, n in ((16, 1024, 1 << 20), (768, 1024, 1 << 20)):
        key = f"default ({k}, {m}, 2^20)"
        out[key] = []
        for seed in range(SEEDS):
            gen = torch.Generator(device=device)
            gen.manual_seed(2000 + seed)
            q = torch.rand((m, k), generator=gen, device=device)
            r = torch.rand((n, k), generator=gen, device=device)
            idx = fused_knn(q, r, precision="default", device=device)[0].long()
            want = _exact_scan(q, r)

            def true_d(i):
                return ((q - r[i]) ** 2).sum(dim=1).sqrt()

            ok = (idx == want) | ((true_d(idx) - true_d(want)).abs() <= TOLERANCE)
            errors = int((~ok).sum().item())
            differ = int((idx != want).sum().item())
            out[key].append({"gate_errors": errors, "indices_differ": differ})
            print(f"  {key} seed {seed}: {errors} gate errors ({differ} indices differ "
                  f"from the exact scan's)", flush=True)
            del q, r, idx, want
            torch.cuda.empty_cache()
    return out


def highest_merge(device):
    """B1 "highest" plus the refine over P*128 lanes and over the merged
    128, at ds11, (16, 64, 2^20) and the embed shapes."""
    import torch

    from tpu_knn_torch.kernels import fused, tiers
    from tpu_knn_torch.utils.timing import time_ms

    out = {}
    for k, m, n in ((16, 1024, 1 << 20), (16, 64, 1 << 20), (128, 1024, 1 << 20),
                    (768, 1024, 1 << 20)):
        gen = torch.Generator(device=device)
        gen.manual_seed(7)
        q = torch.rand((m, k), generator=gen, device=device)
        r = torch.rand((n, k), generator=gen, device=device)
        r_op = fused.prep_soa(r, n)
        parts = tiers.tier_parts("highest", m, k, n)
        cutoff = fused.select_cutoff("highest", k)

        def wide():
            return fused._refine(q, r, fused.fused_candidates(q, r_op, n, parts), n, cutoff=cutoff)

        def merged():
            cand = tiers.merge_partitions(*fused.fused_candidates(q, r_op, n, parts))
            return fused._refine(q, r, cand, n, cutoff=cutoff)

        same = bool(torch.equal(wide()[0], merged()[0]))
        t = time_ms({"wide": wide, "merged": merged}, 10 if k < 768 else 3)
        key = f"highest ({k}, {m}, 2^20) P={parts}"
        out[key] = {"wide_ms": t["wide"], "merged_ms": t["merged"], "same_answers": same}
        print(f"  {key}: over P*128 lanes {t['wide']:.4f} ms, merged to 128 "
              f"{t['merged']:.4f} ms; answers identical: {same}", flush=True)
        del q, r, r_op
        torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tier_numerics: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    device = torch.device("cuda", 0)
    if sys.argv[1:] == ["packed"]:
        print(json.dumps({"card": card, "packed": packed_errors(device)}))
        return 0
    if sys.argv[1:] == ["default"]:
        print(json.dumps({"card": card, "default": default_gate(device)}))
        return 0
    errors, times = tier_errors(device)
    merge = highest_merge(device)
    print(json.dumps({"card": card, "errors": errors, "kernel_ms": times, "highest": merge}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
