"""Launch-geometry sweeps of B1/B4, B2 and v7, and a profile of the main path.

    python3 -m tpu_knn_torch.probes.geometry_sweep     # repo root, one H100
    python3 -m tpu_knn_torch.probes.geometry_sweep fused [BASELINE]
    PYTHONPATH=<checkout> python3 tpu_knn_torch/probes/geometry_sweep.py paths
    python3 -m tpu_knn_torch.probes.geometry_sweep beside
    PYTHONPATH=<checkout> python3 tpu_knn_torch/probes/geometry_sweep.py variants

Prints, beside the card's name and power limit (nvidia-smi):

- with no argument: B2 at ds9 = (k=16, m=1, n=2^24) for partition counts
  P = 132 .. 4224; v7 (twolevel_knn) at ds9 and ds11 = (16, 1024, 2^20)
  for several partition counts; the exact refinement alone at ds9 on B2
  candidates of P partitions; torch.profiler tables of the prepared query
  at ds9 and ds11 and of the default per-call dispatch (v7) at ds9: device
  time, the busy share of the wall time, and the top kernels;
- `fused`: B1 and B4 (the tiled f32 kernel) at ds11, (16, 64, 2^20) and
  (768, 1024, 2^20), launched through the C entry points over
  tuning.tiled_geometry's choices (these launches are not counted); with
  BASELINE, a checkout of the port from before the tiled kernel (e.g.
  `git archive` of a commit before it), also that checkout's lane-per-thread
  template at 32 rows per block over P, built from its own sources;
- `paths`: at the same shapes, B1 and B4 through their wrappers at the
  default P, the passes engine (K = 8 at ds11, K = 64 at m = 64) or
  "highest" 1-NN (k = 768), and cuBLAS's f32 product of the same scores,
  for whichever checkout of the port is on the path (run it once per
  checkout in one chip call to compare two);
- `beside`: B1 at ds11 timed alone, beside its plain version (as
  chip_smoke.py's phase 3 times it) and beside B4 and cuBLAS's product (as
  `paths` does), over prep_soa's operand and over a prepared NNIndex's (as
  chip_smoke.py's), all in one process; and the SM clock right after each
  neighbour, from the time a fixed count of clock cycles takes to spin
  (torch.cuda._sleep); beside each CUDA-event time, the kernel's own
  device time from torch.profiler;
- `variants`: B1's two ladder variants, v3 (`aos_candidates`) and v6
  (`const_query_candidates`), at ds11 and ds9, each at its checkout's own
  default P and beside B1 at that P, by CUDA events and device time, then
  the ladder's per-call v3, v4 and v6 rows there, for whichever checkout
  of the port is on the path (run it once per checkout in one chip call
  to compare two).

Times are medians of CUDA-event timings (utils/timing.py).
"""

from __future__ import annotations

import subprocess
import sys
import time


def _profile(label, fn, calls=5):
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    # Wall time without the profiler, whose own overhead would swamp it.
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
    print(f"=== profile {label} ({calls} calls)")
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=12,
                                    max_name_column_width=60))
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev = sum(e.device_time for e in evs) / 1e3 / calls
    print(f"{label}: {len(evs) // calls} device events and {dev:.4f} ms of device "
          f"time per call; wall {wall:.4f} ms per call without the profiler "
          f"(busy share {dev / wall:.3f})")


#: The shapes of B1 and B4's main paths: (k, m, n), and the K of the
#: passes engine there (0: "highest" 1-NN through fused_knn instead).
FUSED_SHAPES = ((16, 1024, 1 << 20, 8), (16, 64, 1 << 20, 64), (768, 1024, 1 << 20, 0),
                (16, 8, 1 << 20, 0))



def _load_baseline(tree):
    """The C library of another checkout's port (its own csrc/build.py,
    building into that checkout), with that build module's check()."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "baseline_build", os.path.join(tree, "tpu_knn_torch", "csrc", "build.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.load(), mod.check


def fused_sweep(lib, check, rand, show, baseline=None):
    """B1 and B4 through the C entry points at each shape of FUSED_SHAPES:
    the tiled kernel over tuning.tiled_geometry's choices (TM rows per
    warp, P around the helper's; every instance bit-equal to the first at
    each P), and with ``baseline`` (a
    checkout of the port from before the tiled kernel) its
    lane-per-thread template at 32 rows per block over P."""
    import torch

    from tpu_knn_torch.kernels.fused import prep_soa, transposed_queries
    from tpu_knn_torch.kernels.tuning import TILED_ROWS, tiled_geometry
    from tpu_knn_torch.utils.timing import time_ms

    dev = torch.device("cuda", 0)
    old = _load_baseline(baseline) if baseline else None

    def launcher(q, r_op, n, banded, lib, check, *geometry, old_template=False):
        """Launches at a forced P: the tiled kernel (geometry = (TM,),
        over the transposed queries, which it transposes per call
        as the wrapper does), or the baseline's lane-per-thread template
        (geometry = (rows per block,), over q as it is)."""
        m, k = q.shape
        b_s = torch.full((m,), -torch.inf, dtype=torch.float32, device=dev)
        b_i = torch.full((m,), -1, dtype=torch.int32, device=dev)

        def run(parts):
            idx = torch.empty((m, parts * 128), dtype=torch.int32, device=dev)
            score = torch.empty((m, parts * 128), dtype=torch.float32, device=dev)
            stream = torch.cuda.current_stream().cuda_stream
            qs = q if old_template else transposed_queries(q)
            rows = (m, k) if old_template else (m, qs.shape[1], k)
            if banded:
                err = lib.tk_banded_candidates(
                    qs.data_ptr(), r_op.data_ptr(), b_s.data_ptr(), b_i.data_ptr(),
                    idx.data_ptr(), score.data_ptr(), *rows, r_op.stride(0), n, parts,
                    *geometry, stream)
            else:
                err = lib.tk_fused_candidates(
                    qs.data_ptr(), r_op.data_ptr(), idx.data_ptr(), score.data_ptr(),
                    *rows, r_op.stride(0), n, parts, *geometry, stream)
            check(lib, err, "B4" if banded else "B1")
            return idx, score
        return run

    for k, m, n, _ in FUSED_SHAPES:
        q, r = rand((m, k)), rand((n, k))
        r_op = prep_soa(r, n)
        g = tiled_geometry(m, k, n)
        reps = 10 if k == 16 else 3
        fns, first = {}, {}
        for banded in (False, True):
            name = "B4" if banded else "B1"
            for tm in TILED_ROWS:
                if tm < g.tm // 2:
                    continue
                run = launcher(q, r_op, n, banded, lib, check, tm)
                for p in sorted({max(1, g.parts // 2), g.parts, 2 * g.parts}):
                    # Every instance computes the same contract in the same
                    # arithmetic: bit-equal candidates at one P.
                    try:
                        got = run(p)
                    except RuntimeError as e:
                        raise SystemExit(f"{name} TM={tm} P={p}: {e}") from e
                    want = first.setdefault((banded, p), got)
                    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                        raise SystemExit(f"{name} TM={tm} P={p}: candidates differ from "
                                         "the first instance's")
                    fns[f"{name} tiled (k={k}, m={m}) TM={tm} P={p}"] = (
                        lambda p=p, run=run: run(p))
        first.clear()
        show(time_ms(fns, reps))
        if old is not None:
            fns = {}
            for banded in (False, True):
                run = launcher(q, r_op, n, banded, *old, 32, old_template=True)
                ps = (9, 18, 36, 72) if m == 1024 else (66, 132, 264, 528)
                fns.update({f"{'B4' if banded else 'B1'} old (k={k}, m={m}) TM=32 P={p}":
                            (lambda p=p, run=run: run(p)) for p in ps})
            show(time_ms(fns, reps))
        del q, r, r_op
        torch.cuda.empty_cache()


def fused_paths(rand, show):
    """B1 and B4 through their wrappers at the caller's default P, the
    passes engine and "highest" 1-NN, at each shape of FUSED_SHAPES, and
    cuBLAS's f32 product of the same scores. Only public names that every
    slice of the port has, so the same script times an older checkout
    (PYTHONPATH=<checkout> python3 <this file> paths)."""
    import torch

    from tpu_knn_torch.kernels.fused import banded_candidates, fused_candidates, fused_knn, prep_soa
    from tpu_knn_torch.kernels.tiers import tier_parts
    from tpu_knn_torch.kernels.topk import topk_knn
    from tpu_knn_torch.utils.timing import time_ms

    dev = torch.device("cuda", 0)
    for k, m, n, kk in FUSED_SHAPES:
        q, r = rand((m, k)), rand((n, k))
        r_op = prep_soa(r, n)
        parts = tier_parts("highest", m, k, n)
        b_s = torch.full((m,), -torch.inf, dtype=torch.float32, device=dev)
        b_i = torch.full((m,), -1, dtype=torch.int32, device=dev)
        shape = f"(k={k}, m={m}, n={n})"
        fns = {f"B1 {shape} P={parts}": lambda: fused_candidates(q, r_op, n, parts),
               f"B4 {shape} P={parts}":
               lambda: banded_candidates(q, r_op, n, parts, b_s, b_i),
               f"cuBLAS f32 q @ r {shape}": lambda: q @ r_op[:k]}
        if kk:
            fns[f"passes {shape} K={kk}"] = lambda: topk_knn(q, r, kk, method="passes")
        else:
            fns[f"fused_knn highest {shape}"] = lambda: fused_knn(q, r, precision="highest")
        show(time_ms(fns, 10 if k == 16 else 3))
        del q, r, r_op
        torch.cuda.empty_cache()


def b1_beside(rand, show, reps=10, spin=1 << 21):
    """B1 at ds11 in the settings of chip_smoke.py's phase 3 and of
    `paths`, in one process, and the SM clock after each neighbour."""
    import statistics

    import torch

    import tpu_knn_torch
    from tpu_knn_torch.kernels.fused import (
        banded_candidates, fused_candidates, fused_candidates_plain, prep_soa, tiled_parts,
    )
    from tpu_knn_torch.utils.timing import device_ms, time_ms

    k, m, n = 16, 1024, 1 << 20
    q, r = rand((m, k)), rand((n, k))
    r_op, ix_op = prep_soa(r, n), tpu_knn_torch.NNIndex(r).r_ops[0]
    parts = tiled_parts(m, k, n)
    b_s = torch.full((m,), -torch.inf, device=q.device)
    b_i = torch.full((m,), -1, dtype=torch.int32, device=q.device)

    def plain():
        return fused_candidates_plain(q, r_op, n, parts)

    def cublas():
        return q @ r_op[:k]

    def b1(op=r_op):
        return fused_candidates(q, op, n, parts)

    for op_name, op in (("prep_soa operand", r_op), ("NNIndex operand", ix_op)):
        for label, fns in (("alone", {"B1": lambda: b1(op)}),
                           ("beside its plain version", {"B1": lambda: b1(op), "plain": plain}),
                           ("beside B4 and cuBLAS", {
                               "B1": lambda: b1(op),
                               "B4": lambda: banded_candidates(q, r_op, n, parts, b_s, b_i),
                               "cuBLAS": cublas})):
            show({f"B1 ds11 P={parts} {op_name} {label}": time_ms(fns, reps)["B1"]})
            for kname, ms in device_ms(fns, "tiled_candidates", reps).items():
                print(f"  {kname[:60]}: {ms:.4f} ms of device time a round "
                      f"(torch.profiler)", flush=True)
    for label, before in (("idle", None), ("after B1", b1), ("after the plain version", plain),
                          ("after cuBLAS", cublas)):
        samples = []
        for _ in range(reps):
            if before is not None:
                before()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            torch.cuda._sleep(spin)
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end))
        ms = statistics.median(samples)
        print(f"SM clock {label}: {spin / ms / 1e3:.0f} MHz ({spin} cycles in {ms:.4f} ms)",
              flush=True)


def ladder_variants(rand, show, reps=10):
    """v3 and v6 beside B1 (see the module docstring). Only public names,
    with each checkout's own default P for the variants (aos_parts and
    default_parts where the checkout has them, else tiled_parts and
    tuning.resident_geometry), so an older checkout runs it too."""
    import torch

    import tpu_knn_torch
    from tpu_knn_torch.kernels import fused, tuning
    from tpu_knn_torch.kernels.fused import prep_soa
    from tpu_knn_torch.utils.timing import device_ms, time_ms

    for label, (k, m, n) in (("ds11", (16, 1024, 1 << 20)), ("ds9", (16, 1, 1 << 24))):
        q, r = rand((m, k)), rand((n, k))
        r_op = prep_soa(r, n)
        p3 = (fused.aos_parts if hasattr(fused, "aos_parts") else fused.tiled_parts)(m, k, n)
        p6 = (fused.default_parts(m, k, n) if hasattr(fused, "default_parts")
              else tuning.resident_geometry(m, k, n).parts)
        fns = {f"v3 kernel {label} P={p3}": lambda: fused.aos_candidates(q, r, n, p3),
               f"B1 kernel {label} P={p3}": lambda: fused.fused_candidates(q, r_op, n, p3),
               f"v6 kernel {label} P={p6}": lambda: fused.const_query_candidates(q, r_op, n, p6)}
        if p6 != p3:
            fns[f"B1 kernel {label} P={p6}"] = lambda: fused.fused_candidates(q, r_op, n, p6)
        show(time_ms(fns, reps))
        for name, fn in fns.items():
            for kname, ms in device_ms({name: fn}, "candidates_kernel", reps).items():
                print(f"  {name}: {kname[:70]}: {ms:.4f} ms of device time a call "
                      f"(torch.profiler)", flush=True)
        show(time_ms({f"{v} per call {label}": (lambda v=v: tpu_knn_torch.knn_callback(
            k, m, n, q, r, version=v)) for v in ("v3", "v4", "v6")}, 5))
        del q, r, r_op
        torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("geometry_sweep: no CUDA device", file=sys.stderr)
        return 2
    import tpu_knn_torch
    from tpu_knn_torch.csrc.build import check, load
    from tpu_knn_torch.kernels import smallm
    from tpu_knn_torch.kernels.fused import _refine, prep_soa
    from tpu_knn_torch.kernels.twolevel import twolevel_knn
    from tpu_knn_torch.utils.timing import time_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    lib = load()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)

    def rand(shape):
        return torch.rand(shape, generator=gen, device=dev)

    def show(times):
        for name, ms in times.items():
            print(f"{name}: {ms:.4f} ms [{card}]", flush=True)

    if sys.argv[1:2] == ["fused"]:
        fused_sweep(lib, check, rand, show, *sys.argv[2:3])
        return 0
    if sys.argv[1:] == ["paths"]:
        fused_paths(rand, show)
        return 0
    if sys.argv[1:] == ["beside"]:
        b1_beside(rand, show)
        return 0
    if sys.argv[1:] == ["variants"]:
        ladder_variants(rand, show)
        return 0

    k9, n9 = 16, 1 << 24
    q9, r9 = rand((1, k9)), rand((n9, k9))
    r_op9 = prep_soa(r9, n9)
    show(time_ms({f"B2 ds9 P={p}": (lambda p=p: smallm.smallm_candidates(q9, r_op9, n9, p))
                  for p in (132, 264, 528, 1056, 2112, 4224)}, 20))

    k, m, n = 16, 1024, 1 << 20
    q, r = rand((m, k)), rand((n, k))
    r_op = prep_soa(r, n)

    fns = {f"v7 ds9 parts={p}": (lambda p=p: twolevel_knn(q9, r9, parts=p))
           for p in (8, 66, 132, 264, 528)}
    fns.update({f"v7 ds11 parts={p}": (lambda p=p: twolevel_knn(q, r, parts=p))
                for p in (8, 9, 18, 36)})
    show(time_ms(fns, 10))

    for p in (264, 528, 1056):
        cand = smallm.smallm_candidates(q9, r_op9, n9, p)
        show(time_ms({f"refine ds9 P={p}":
                      lambda: _refine(q9, r9, cand, n9, cutoff=float("inf"))}, 10))

    index9 = tpu_knn_torch.NNIndex(r9)
    index11 = tpu_knn_torch.NNIndex(r)
    _profile("ds9 prepared", lambda: index9.query(q9))
    _profile("ds11 prepared", lambda: index11.query(q))
    _profile("ds9 per-call v7", lambda: tpu_knn_torch.knn_callback(k9, 1, n9, q9, r9))
    return 0


if __name__ == "__main__":
    sys.exit(main())
