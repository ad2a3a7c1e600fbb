"""Readings for the limits of a cell's output check, in one process.

    python3 -m knn_bench.calibrate --workload <cell> --seeds 1,2,... \\
        --control-seeds 101,102,103 [--seconds 2]

For each of ``--seeds``: a run of the cell (its data, index, warm-up, a
window of ``--seconds`` at the cell's own load) whose sampled batches are
checked as a benchmark run checks them. For each of ``--control-seeds``:
the control, the plain reference in TF32 put in the program's place
(knn_bench.harness.control_readings). Each reading is one JSON line on
standard output: the largest value of each number compared, and whether
the cell's current limits pass it. The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s.strip()]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=_seeds, default=[])
    parser.add_argument("--control-seeds", type=_seeds, default=[])
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)

    import torch

    from knn_bench import harness, spec

    if not torch.cuda.is_available():
        print("knn_bench.calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    sides = [("program", s) for s in args.seeds] + [("control", s) for s in args.control_seeds]
    for side, seed in sides:
        t = time.perf_counter()
        if side == "program":
            run, verdict = harness.run_cell(cell, seed, args.seconds, False, "cuda",
                                            time.perf_counter())
            extra = {"batches": run.batches, "tiers": run.tiers}
        else:
            verdict, extra = harness.control_readings(cell, seed, "cuda"), {}
        print(json.dumps({"workload": args.workload, "side": side, "seed": seed,
                          **{k: v["value"] for k, v in verdict["numbers"].items()},
                          "rows": verdict["rows"], "passes": verdict["correct"],
                          "seconds": time.perf_counter() - t, **extra}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
