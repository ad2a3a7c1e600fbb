"""B11 (the projection window scan) and B2-bf16 (the small-m scan over a bf16
store) beside an older checkout's kernels, on the card.

    python3 -m tpu_knn_torch.probes.window_scan compare OLD_CHECKOUT [OUT.json]
    python3 -m tpu_knn_torch.probes.window_scan sweep
    PYTHONPATH=<checkout> python3 tpu_knn_torch/probes/window_scan.py calls

Each form prints the card's name and power limit (nvidia-smi) first.

- compare: builds OLD_CHECKOUT's kernel library (with its own
  csrc/build.py, into its own _build) beside this tree's and calls both
  through their C entry points on the same inputs, made on the card from a
  seed. Bit for bit, at the same launch arguments, each launch made twice:
  B11 at the auto path's (3, 16, 2^24) launch (each tree's split count),
  v11's launches at ds8 (m = 1) and ds10 (m = 1024, one split) and edge
  cases (k = 3..40, m = 1..64, windows at the last tile, an operand whose
  rows are not 16-byte aligned); B2-bf16 at (16, 4, 2^20) and edge cases
  (k = 1..32, m = 1..4, n ragged against 8 and 128, ld not a multiple of
  8, bases offset by 1, 2 and 4 elements), and also bit-equal to this
  tree's B2 on the upcast operand; B2 f32 at ds9 and B6 at (16, 4, 2^24)
  K = 16. Then times in turns (old, this, this, old): CUDA-event medians
  of 20 and the kernels' own device time (torch.profiler), B2-bf16 also
  with a 256 MB write between launches (the operand out of L2). The last
  line is {"identical": bool, "times": {...}}, also written to OUT.json.
- sweep: this tree's B11 over split counts at (3, 16, 2^24) and (3, 1,
  2^24), and B2-bf16 over P and load width at (16, m, 2^20), by device
  time.
- calls: the device time (every kernel of the call, torch.profiler) and
  the event time of NNIndex(store="bf16").query at m = 4 over (16, 2^20)
  and of auto NNIndex.query at m = 16 over (3, 2^24), for whichever
  checkout is on the path (run an older tree and this one in turns in one
  chip call to compare them).
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys

#: Bytes written between launches to push an operand out of the 50 MB L2.
FLUSH_BYTES = 256 << 20

#: (k, m, n) of the timed rows.
AUTO = (3, 16, 1 << 24)     # NNIndex auto at m = 16: B11 at its default splits
DS8 = (3, 1, 1 << 24)       # v11 per call at ds8
DS10 = (3, 1024, 1 << 20)   # v11 per call at ds10: one split
BF16 = (16, 4, 1 << 20)     # NNIndex(store="bf16").query at m = 4
DS9 = (16, 1, 1 << 24)      # B2 f32 at ds9
B6 = (16, 4, 1 << 24, 16)   # prepared query(neighbors=16): B2 + B6


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def _old_library(checkout: str):
    """OLD_CHECKOUT's kernel library, built by its own build.py."""
    import importlib.util

    path = os.path.join(checkout, "tpu_knn_torch", "csrc", "build.py")
    spec = importlib.util.spec_from_file_location("old_tpu_knn_torch_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.load()


def _old_constant(checkout: str, module: str, name: str) -> int:
    with open(os.path.join(checkout, "tpu_knn_torch", "kernels", module)) as f:
        return int(re.search(rf"^{name} = (\d+)", f.read(), re.M).group(1))


def _stream() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream


def _ok(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: cudaError {err} ({lib.tk_error_string(err).decode()})")


# ---- the entry points, called directly ------------------------------------


def b11(lib, q, r_aug, tiles, w_tiles: int, splits: int):
    import torch

    from tpu_knn_torch.kernels.projection import TILE_W

    m, k = q.shape
    out = torch.empty((m, splits * 128), dtype=torch.int32, device=q.device)
    _ok(lib, lib.tk_window_candidates(q.data_ptr(), r_aug.data_ptr(), tiles.data_ptr(),
                                      out.data_ptr(), m, k, r_aug.stride(0),
                                      w_tiles * TILE_W // 128, splits, _stream()), "B11")
    return out


def b2(lib, q, r_op, n: int, parts: int):
    """B2, or B2-bf16 for a bf16 operand; r_op may be a view whose rows are
    r_op.stride(0) apart (an offset base)."""
    import torch

    m, k = q.shape
    entry = (lib.tk_smallm_candidates_bf16 if r_op.dtype == torch.bfloat16
             else lib.tk_smallm_candidates)
    oi = torch.empty((m, parts * 128), dtype=torch.int32, device=q.device)
    os_ = torch.empty((m, parts * 128), dtype=torch.float32, device=q.device)
    _ok(lib, entry(q.data_ptr(), r_op.data_ptr(), oi.data_ptr(), os_.data_ptr(), m, k,
                   r_op.stride(0), n, parts, _stream()), "B2")
    return oi, os_


def b6(lib, q, r_op, bound, n: int, parts: int, kk: int):
    import torch

    m, k = q.shape
    oi = torch.empty((m, parts * kk), dtype=torch.int32, device=q.device)
    os_ = torch.empty((m, parts * kk), dtype=torch.float32, device=q.device)
    _ok(lib, lib.tk_smallm_topk_candidates(q.data_ptr(), r_op.data_ptr(), bound.data_ptr(),
                                           oi.data_ptr(), os_.data_ptr(), m, k, r_op.stride(0),
                                           n, parts, kk, _stream()), "B6")
    return oi, os_


# ---- inputs -----------------------------------------------------------------


def window_case(gen, k: int, m: int, n: int, window: int | None = None, last: bool = False):
    """(q, r_aug, tiles, w_tiles) as the kernel pipeline computes them
    (searchsorted, clip, align down); ``last``: query 0 at the corner
    (1, ..., 1), whose window starts at the last tile."""
    import torch

    from tpu_knn_torch.kernels import projection

    r = torch.rand((n, k), generator=gen, device="cuda")
    q = torch.rand((m, k), generator=gen, device="cuda")
    if last:
        q[0] = 1.0
    index = projection.build_projection_index(r)
    window = window or projection.auto_window(k, n)
    w = min(window, n)
    pos = torch.searchsorted(index[3], projection._axis_column(q, index[2]))
    tiles = ((pos - w // 2).clamp(0, max(n - w, 0)) // projection.TILE_W).to(torch.int32)
    return q, index[6], tiles, projection.window_tiles(n, window)


def unaligned(r_op, offset: int = 1, pad: int = 0):
    """A copy of r_op whose base is `offset` elements past an aligned
    allocation and whose rows are shape[1] + pad apart (a view)."""
    import torch

    rows, cols = r_op.shape
    ld = cols + pad
    buf = torch.zeros(offset + rows * ld, dtype=r_op.dtype, device=r_op.device)
    view = buf[offset:].view(rows, ld)
    view[:, :cols] = r_op
    return view


def bf16_case(gen, k: int, m: int, n: int):
    """(q, the bf16 SoA operand (round_up(k, 8), n_pad))."""
    import torch

    from tpu_knn_torch.kernels.fused import prep_soa

    q = torch.rand((m, k), generator=gen, device="cuda")
    r = torch.rand((n, k), generator=gen, device="cuda").to(torch.bfloat16)
    return q, prep_soa(r, -(-n // 128) * 128)


# ---- compare ------------------------------------------------------------------


def _flush():
    import torch

    buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    return lambda: buf.fill_(1.0)


def _event_ms(fn, reps: int, flush=None) -> float:
    import torch

    for _ in range(2):
        fn()
    ts = []
    for _ in range(reps):
        if flush:
            flush()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end))
    return statistics.median(ts)


def _device_ms(fn, kernel: str, reps: int, flush=None) -> float:
    from tpu_knn_torch.utils.timing import device_ms

    got = device_ms({"fn": (lambda: (flush(), fn())) if flush else fn}, kernel, reps)
    return sum(got.values())


def _turns(times: dict, row: str, fns: dict, kernel: str, card: str, flush=None,
           reps: int = 20) -> None:
    """fns: {"old": fn, "this": fn}, timed old, this, this, old."""
    for who in ("old", "this", "this", "old"):
        ev = _event_ms(fns[who], reps, flush)
        dev = _device_ms(fns[who], kernel, reps, flush)
        times.setdefault(f"{row} [{who}]", []).append((round(ev, 5), round(dev, 5)))
        print(f"time {row} [{who}]: events {ev:.4f} ms, device {dev:.4f} ms [{card}]",
              flush=True)


def compare(checkout: str, out_json: str | None, card: str) -> bool:
    import torch

    from tpu_knn_torch.csrc.build import load
    from tpu_knn_torch.kernels import projection, smallm, topk
    from tpu_knn_torch.kernels.tuning import H100_SMS, pick_parts

    libs = {"old": _old_library(checkout), "this": load()}
    old_b11 = _old_constant(checkout, "projection.py", "B11_BLOCKS_PER_SM")
    old_b2 = _old_constant(checkout, "smallm.py", "B2_BLOCKS_PER_SM")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    same = {}

    def hold(name, fn, want_fn=None):
        """fn(lib) twice on each library: every output equal to this
        tree's first (and to want_fn()'s where given)."""
        def outs(lib):
            o = fn(lib)
            return o if isinstance(o, tuple) else (o,)

        got = [outs(lib) for lib in (libs["this"], libs["this"], libs["old"], libs["old"])]
        if want_fn is not None:
            want = want_fn()
            got.append(want if isinstance(want, tuple) else (want,))
        ok = all(torch.equal(a, b) for o in got[1:] for a, b in zip(o, got[0]))
        same[name] = ok
        print(f"{'same' if ok else 'DIFFERENT'}: {name}", flush=True)

    # B11: the main-path shapes at each tree's split count, then edges.
    b11_rows = {}
    for label, shape, window in (("auto (3, 16, 2^24)", AUTO, None), ("ds8", DS8, None),
                                 ("ds10", DS10, None)):
        k, m, n = shape
        q, r_aug, tiles, w_tiles = window_case(gen, k, m, n, window, last=True)
        groups = w_tiles * projection.TILE_W // 128
        old_splits = max(1, min(groups, -(-old_b11 * H100_SMS // m)))
        new_splits = projection.window_splits(m, w_tiles)
        for splits in sorted({old_splits, new_splits, 1}):
            hold(f"B11 {label} splits {splits}",
                 lambda lib, s=splits: b11(lib, q, r_aug, tiles, w_tiles, s))
        b11_rows[label] = (q, r_aug, tiles, w_tiles, old_splits, new_splits)
    for k, m, n, window, last in ((3, 7, 70_001, 4096, True), (8, 64, 70_001, 1 << 18, True),
                                  (16, 5, 30_000, 4096, False), (40, 3, 30_000, 8192, True),
                                  (3, 1, 9000, 9000, True), (4, 16, 200_000, 20_480, False)):
        q, r_aug, tiles, w_tiles = window_case(gen, k, m, n, window, last)
        for splits in sorted({1, projection.window_splits(m, w_tiles), 3}):
            hold(f"B11 k={k} m={m} n={n} window {window} splits {splits}",
                 lambda lib, s=splits: b11(lib, q, r_aug, tiles, w_tiles, s))
        r_odd = unaligned(r_aug, 1, 1)
        hold(f"B11 k={k} m={m} n={n} unaligned operand (ld {r_odd.stride(0)})",
             lambda lib: b11(lib, q, r_odd, tiles, w_tiles, projection.window_splits(m, w_tiles)))
        del r_aug, r_odd

    # B2-bf16 (and bit-equal to this tree's B2 on the upcast operand).
    def b2_bf16_case(label, q, r_bf, n, parts):
        r_up = r_bf.float()
        hold(f"B2-bf16 {label} P={parts}", lambda lib: b2(lib, q, r_bf, n, parts),
             lambda: b2(libs["this"], q, r_up.contiguous(), n, parts))

    k, m, n = BF16
    q_bf, r_bf = bf16_case(gen, k, m, n)
    p_old, p_new = pick_parts(1, n, old_b2), smallm.bf16_parts(n)
    for parts in sorted({p_old, p_new}):
        b2_bf16_case(f"({k}, {m}, 2^20)", q_bf, r_bf, n, parts)
    for m in (1, 2, 3, 4):
        for k in (1, 8, 9, 16, 17, 32):
            for n, parts in ((1000, 1), (5077, 3), (70_001, None)):
                q, r = bf16_case(gen, k, m, n)
                parts = parts or smallm.bf16_parts(n)
                b2_bf16_case(f"k={k} m={m} n={n}", q, r, n, parts)
            q, r = bf16_case(gen, k, m, 20_003)
            for offset, pad in ((0, 3), (1, 0), (2, 0), (4, 0), (0, 4)):
                v = unaligned(r, offset, pad)
                b2_bf16_case(f"k={k} m={m} n=20003 base +{offset} ld {v.stride(0)}", q, v,
                             20_003, 7)

    # B2 f32 at ds9 and B6 at (16, 4, 2^24) K = 16: the kernels beside B2-bf16.
    k, m, n = DS9
    q9 = torch.rand((m, k), generator=gen, device="cuda")
    r9 = torch.rand((k, n), generator=gen, device="cuda")
    p9 = smallm.default_parts(n)
    hold(f"B2 ds9 P={p9}", lambda lib: b2(lib, q9, r9, n, p9))
    k, m, n, kk = B6
    q6 = torch.rand((m, k), generator=gen, device="cuda")
    p1, p6 = smallm.default_parts(n), topk.smallm_topk_parts(n, k)
    bound = torch.topk(b2(libs["this"], q6, r9, n, p1)[1], kk, dim=-1,
                       largest=False).values[:, -1].contiguous()
    hold(f"B6 (16, 4, 2^24) K={kk} P={p6}", lambda lib: b6(lib, q6, r9, bound, n, p6, kk))
    identical = all(same.values())

    # Times, in turns.
    times = {}
    for label, (q, r_aug, tiles, w_tiles, old_splits, new_splits) in b11_rows.items():
        for tag, splits in (("each tree's", None), ("same", new_splits)):
            if tag == "same" and old_splits == new_splits:
                continue
            fns = {"old": lambda s=splits or old_splits: b11(libs["old"], q, r_aug, tiles,
                                                               w_tiles, s),
                   "this": lambda s=splits or new_splits: b11(libs["this"], q, r_aug, tiles,
                                                                w_tiles, s)}
            _turns(times, f"B11 {label} ({tag} splits: old {splits or old_splits}, this "
                          f"{splits or new_splits})", fns, "window_candidates", card)
    flush = _flush()
    k, m, n = BF16
    for tag, f in (("L2 warm", None), ("L2 flushed", flush)):
        for p_o, p_t in sorted({(p_old, p_new), (p_new, p_new)}):
            fns = {"old": lambda p=p_o: b2(libs["old"], q_bf, r_bf, n, p),
                   "this": lambda p=p_t: b2(libs["this"], q_bf, r_bf, n, p)}
            _turns(times, f"B2-bf16 (16, 4, 2^20) {tag} (P old {p_o}, this {p_t})", fns,
                   "smallm", card, flush=f)
    _turns(times, f"B2 ds9 P={p9}", {who: (lambda lib=lib: b2(lib, q9, r9, DS9[2], p9))
                                     for who, lib in libs.items()},
           "smallm_candidates", card)
    _turns(times, f"B6 (16, 4, 2^24) K={kk} P={p6}",
           {who: (lambda lib=lib: b6(lib, q6, r9, bound, B6[2], p6, kk))
            for who, lib in libs.items()}, "smallm_kselect", card)
    result = {"identical": identical, "card": card, "same": same, "times": times}
    if out_json:
        with open(out_json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({"identical": identical, "times": times}))
    return identical


# ---- sweep ------------------------------------------------------------------


def sweep(card: str) -> None:
    import torch

    from tpu_knn_torch.csrc.build import load
    from tpu_knn_torch.kernels import projection
    from tpu_knn_torch.kernels.tuning import H100_SMS

    lib = load()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    for label, (k, m, n) in (("auto (3, 16, 2^24)", AUTO), ("ds8 (3, 1, 2^24)", DS8)):
        q, r_aug, tiles, w_tiles = window_case(gen, k, m, n)
        groups = w_tiles * projection.TILE_W // 128
        for per_sm in (2, 4, 8, 16):
            splits = max(1, min(groups, -(-per_sm * H100_SMS // m)))
            dev = _device_ms(lambda s=splits: b11(lib, q, r_aug, tiles, w_tiles, s),
                             "window_candidates", 20)
            print(f"sweep B11 {label}: {per_sm} blocks an SM, {splits} splits: device "
                  f"{dev:.4f} ms [{card}]", flush=True)
        del r_aug
    flush = _flush()
    for m in (1, 2, 4):
        q, r_bf = bf16_case(gen, 16, m, 1 << 20)
        for offset in (0, 4):
            v = unaligned(r_bf, offset) if offset else r_bf
            for per_sm in (1, 2, 3, 4, 6, 8):
                parts = per_sm * H100_SMS
                row = []
                for f in (None, flush):
                    row.append(_device_ms(lambda p=parts: b2(lib, q, v, 1 << 20, p), "smallm",
                                          20, f))
                print(f"sweep B2-bf16 (16, {m}, 2^20) base +{offset} P={parts}: device warm "
                      f"{row[0]:.4f} ms, flushed {row[1]:.4f} ms [{card}]", flush=True)


# ---- calls ------------------------------------------------------------------


def _call_device_ms(fn, calls: int = 10) -> float:
    """Device time a call: every CUDA kernel the profiler records over
    `calls` calls, summed, over calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / calls


def calls(card: str) -> None:
    import torch

    import tpu_knn_torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    k, m, n = BF16
    r = torch.rand((n, k), generator=gen, device="cuda")
    q = torch.rand((m, k), generator=gen, device="cuda")
    ix = tpu_knn_torch.NNIndex(r, store="bf16")
    rows = {"NNIndex(store='bf16').query m=4 (16, 2^20)": lambda: ix.query(q)}
    k, m, n = AUTO
    r3 = torch.rand((n, k), generator=gen, device="cuda")
    q16 = torch.rand((m, k), generator=gen, device="cuda")
    auto = tpu_knn_torch.NNIndex(r3, strategy="auto")
    rows["auto NNIndex.query m=16 (3, 2^24)"] = lambda: auto.query(q16)
    for name, fn in rows.items():
        ev = _event_ms(fn, 20)
        dev = _call_device_ms(fn)
        print(f"call {name}: events {ev:.4f} ms, device {dev:.4f} ms [{card}]", flush=True)
    print(f"auto route: {auto.last_strategy}")
    from tpu_knn_torch.kernels import smallm

    if hasattr(smallm, "bf16_parts"):   # the bf16 store's call over B2-bf16's P
        rule = smallm.bf16_parts
        try:
            for parts in (132, 264, 396, 528, 792):
                smallm.bf16_parts = lambda n, p=parts: p
                fn = rows["NNIndex(store='bf16').query m=4 (16, 2^20)"]
                ev, dev = _event_ms(fn, 20), _call_device_ms(fn)
                print(f"call NNIndex(store='bf16').query m=4 at P={parts}: events {ev:.4f} ms, "
                      f"device {dev:.4f} ms [{card}]", flush=True)
        finally:
            smallm.bf16_parts = rule


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("window_scan: no CUDA device", file=sys.stderr)
        return 2
    card = _card()
    print(card, flush=True)
    what = argv[1] if len(argv) > 1 else "sweep"
    if what == "compare":
        return 0 if compare(argv[2], argv[3] if len(argv) > 3 else None, card) else 1
    if what == "sweep":
        sweep(card)
        return 0
    if what == "calls":
        calls(card)
        return 0
    print(f"window_scan: unknown mode {what!r}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv))
