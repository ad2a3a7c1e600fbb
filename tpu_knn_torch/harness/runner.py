"""The test/bench harness — the reference main()/test() analog, as a CLI
(counterpart of tpu_knn/harness/runner.py).

For each requested version: re-seed, generate each dataset, time the
callback end to end (wall clock, the card synchronized at both ends), and
check it against the first version run (the baseline) with the ±1e-3
true-distance rule. (Re-seeding gives every version the same data, so the
TA datasets are drawn once per run.) The output lines are the reference's

    Callback<t>, <k>, <m>, <n>, <ms>ms
    errors/total w.r.t. baseline: <e>/<m>

and the artifacts tpu_knn's: --screen-log (the transcript), --results-csv
(the baseline's indices and true distances in the format of
tests/golden/results_seed1000.csv), --json (one record per run).

Data: the 8 TA shapes come from the glibc stream (bit-identical to the
reference's, so the golden CSV applies); the 4 big shapes (ds8..ds11) are
drawn on the device from a torch.Generator seeded by --seed, which is not
bit-identical to tpu_knn's jax.random data. A warm-up call (reference
WarmUP, core.cu:1192-1229) absorbs the kernels' build and the card's cold
start, and each (version, shape) runs once untimed before the timed call.

Usage:
    python -m tpu_knn_torch.harness.runner --versions v0,v4,v11 --shapes ta --device cpu
    python -m tpu_knn_torch.harness.runner --shapes both          # on the card
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from tpu_knn_torch.harness.checker import check_results, true_distance
from tpu_knn_torch.harness.generator import (
    BIG_SHAPES, DEFAULT_SEED, TA_SHAPES, SampleStream, device_sample_stream,
)
from tpu_knn_torch.utils.timing import wall_ms


def registered_ladder() -> list[str]:
    """Every registered version, in ladder order (v0, v1, ..., v11)."""
    import tpu_knn_torch

    return sorted(tpu_knn_torch.list_versions(), key=lambda v: int(v[1:]))


def warm_up(versions, device):
    """Run every version once on a small problem so the kernels' build and
    the card's cold start are paid before anything is timed."""
    import tpu_knn_torch

    rng = np.random.default_rng(0)
    q = rng.random((1, 4), np.float32)
    r = rng.random((1 << 12, 4), np.float32)
    for v in versions:
        tpu_knn_torch.knn_callback(4, 1, 1 << 12, q, r, version=v, device=device)


def _check(baseline, results, search, ref):
    """check_results on host copies of only the rows a mismatch needs
    (the big shapes' points stay on the card)."""
    mismatch = np.nonzero(baseline != results)[0]
    total = baseline.shape[0]
    if mismatch.size == 0:
        return 0, total
    if isinstance(search, np.ndarray):
        return check_results(baseline, results, search, ref)
    import torch

    rows = np.concatenate([baseline[mismatch], results[mismatch]]).astype(np.int64)
    q = search[torch.as_tensor(mismatch, device=search.device)].cpu().numpy()
    r = ref[torch.as_tensor(rows, device=ref.device)].cpu().numpy()
    j = np.arange(mismatch.size)
    return check_results(j, j + mismatch.size, q, r)[0], total


def run(versions, shapes, seed=DEFAULT_SEED, check=True, log=print, collect_golden=False,
        device_data=False, warm_shapes=True, records=None, device="cuda"):
    """Run the harness; returns (all_pass, golden_lines)."""
    import tpu_knn_torch

    baseline = {}
    golden_lines = []
    all_pass = True
    if not device_data:
        stream = SampleStream(seed)
        ta_samples = [(s, *stream.get_sample(*s)) for s in shapes]
    for t, version in enumerate(versions, start=1):
        log(f"\non running {version}...")
        samples = (device_sample_stream(seed, shapes, device) if device_data
                   else ta_samples)
        for i, ((k, m, n), search, ref) in enumerate(samples):
            if warm_shapes:
                tpu_knn_torch.knn_callback(k, m, n, search, ref, version=version,
                                           device=device)
            out = {}
            with wall_ms(out):
                results = tpu_knn_torch.knn_callback(k, m, n, search, ref,
                                                     version=version, device=device)
            log(f"Callback{t}, {k:2d}, {m:4d}, {n:5d}, {out['ms']:10.3f}ms")
            record = {"version": version, "k": k, "m": m, "n": n,
                      "ms": round(out["ms"], 3)}
            if records is not None:
                records.append(record)
            if i not in baseline:
                baseline[i] = results
                if collect_golden:
                    d = true_distance(search, ref, np.arange(m), results)
                    golden_lines.append(",".join(str(int(x)) for x in results) + ",")
                    golden_lines.append(",".join("%.3f" % float(x) for x in d) + ",")
            elif check:
                errors, total = _check(baseline[i], results, search, ref)
                log(f"errors/total w.r.t. baseline: {errors}/{total}\n")
                record["errors"] = errors
                record["total"] = total
                if errors:
                    all_pass = False
    return all_pass, golden_lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--versions", default=None,
                    help="comma-separated version list, the first is the baseline "
                         "(default: every registered version, v0 first)")
    ap.add_argument("--shapes", default="ta", choices=["ta", "big", "both"],
                    help="ta = the 8 reference datasets; big = the 4 large shapes "
                         "(data drawn on the device)")
    ap.add_argument("--seed", type=int, default=DEFAULT_SEED)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--cold", action="store_true",
                    help="time first calls (no untimed call per shape)")
    ap.add_argument("--screen-log", metavar="PATH", help="also write the transcript here")
    ap.add_argument("--results-csv", metavar="PATH",
                    help="write the baseline's outputs in results.csv format")
    ap.add_argument("--json", metavar="PATH",
                    help="write one record per run (version, shape, ms, errors) as JSON")
    args = ap.parse_args(argv)

    from tpu_knn_torch.engine.registry import get_version

    versions = ([v.strip() for v in args.versions.split(",") if v.strip()]
                if args.versions else registered_ladder())
    for v in versions:
        get_version(v)       # an unregistered name raises KeyError here
    if args.results_csv and args.shapes == "big":
        ap.error("--results-csv requires the glibc-stream data; the big shapes are "
                 "drawn on the device (use --shapes ta or both)")
    phases = []
    if args.shapes in ("ta", "both"):
        phases.append((list(TA_SHAPES), False))
    if args.shapes in ("big", "both"):
        phases.append((list(BIG_SHAPES), True))

    lines = []

    def log(msg=""):
        print(msg, flush=True)
        lines.append(str(msg))

    if not args.no_warmup:
        warm_up(versions, args.device)

    ok = True
    golden = []
    records = []
    for shapes, device_data in phases:
        phase_ok, phase_golden = run(
            versions, shapes, seed=args.seed, check=not args.no_check, log=log,
            collect_golden=bool(args.results_csv) and not device_data,
            device_data=device_data, warm_shapes=not args.cold, records=records,
            device=args.device)
        ok = ok and phase_ok
        golden.extend(phase_golden)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(records, f, indent=2)
    if args.screen_log:
        with open(args.screen_log, "w") as f:
            f.write("\n".join(lines) + "\n")
    if args.results_csv:
        with open(args.results_csv, "w") as f:
            f.write("\n".join(golden) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
