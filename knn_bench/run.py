"""Run one cell of the benchmark once and print its JSON line.

    python3 -m knn_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the line's metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer ones (from a torch.profiler trace of a
slice of the window). The line's last key, ``checks``, holds each number
of the output check beside its limit; standard error ends with the same.
The run fails, and prints no line, without a CUDA card or with fewer
cards than the cell asks for, and if JAX or the JAX package was loaded.
"""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def _interpreter_s() -> float | None:
    """Seconds from the process's start to this module's first line, as
    /proc reads them (to its clock ticks), or None where it cannot."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return None
    return up - (time.perf_counter() - _T_START) - start


def _quarters(run) -> list:
    """Queries a second in each quarter of the window, by the host clock."""
    batch, out = run.queries / max(1, run.batches), []
    for q in range(1, 5):
        lo, hi = run.window_s * (q - 1) / 4, run.window_s * q / 4
        out.append(sum(lo < e <= hi for e in run.ends_s) * batch / (hi - lo))
    return out


def _power_limit() -> str | None:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    interpreter_s = _interpreter_s()
    import torch

    from knn_bench import harness, spec

    cell = spec.cell(args.workload)
    marks = [("imports", time.perf_counter())]
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"knn_bench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, "
              f"count: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    marks.append(("cuda_init", time.perf_counter()))
    trace_path = os.path.join(harness.TRACE_DIR, f"{args.workload}.seed{args.seed}.json.gz")
    run, verdict = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                    "cuda", _T_START, trace_path, marks=marks)
    foreign = harness.foreign_modules()
    if foreign:
        print(f"knn_bench: loaded in this process: {', '.join(foreign)}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": run.memory_peak_bytes}
    line = {"correct": verdict["correct"], "attempted": run.queries,
            "failed": verdict["failed_rows"],
            "metrics": harness.metrics(cell, run, bool(args.trace)), "device": device}
    if args.trace:
        if run.trace is None:
            print("knn_bench: the trace holds no batch", file=sys.stderr)
            return 4
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["span_s"]
        line["breakdown"] = {"device_ops": run.trace["device_ops"],
                             "idle_gaps": run.trace["idle_gaps"]}
        line["trace"] = {k: run.trace[k] for k in ("batches", "kernels", "syncs",
                                                     "profiler_start_s")}
        line["seeded_tiers"] = run.tiers
    line.update({"workload": args.workload, "seed": args.seed, "batches": run.batches,
                 "window_s": run.window_s, "qps_quarters": _quarters(run),
                 "setup_parts": run.setup_parts, "interpreter_s": interpreter_s,
                 "checked_rows": verdict["rows"],
                 "power": _power_limit(), "checks": verdict["numbers"]})
    for name, c in verdict["numbers"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
