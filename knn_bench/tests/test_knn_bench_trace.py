import pytest

from knn_bench import trace


def ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}


def test_reduce_counts_the_slice_and_names_its_gaps():
    events = [
        ev("user_annotation", trace.BATCH_SPAN, 0, 100),
        ev("user_annotation", trace.BATCH_SPAN, 100, 100),
        ev("cpu_op", "aten::topk", 10, 20),
        ev("cuda_runtime", "cudaLaunchKernel", 12, 2),
        ev("cuda_runtime", "cudaStreamSynchronize", 40, 30),
        ev("cuda_runtime", "cudaEventSynchronize", 150, 40),
        ev("cuda_runtime", "cudaStreamSynchronize", 500, 5),   # outside the slice
        ev("kernel", "k1", 20, 50),
        ev("kernel", "k1", 60, 20),                           # overlaps: union 20..80
        ev("gpu_memcpy", "Memcpy DtoH", 120, 10),
        ev("kernel", "k2", 150, 40),
        ev("cpu_op", "aten::where", 85, 20, tid=2),           # another thread
        ev("gpu_user_annotation", trace.BATCH_SPAN, 0, 200),   # not an operation
    ]
    r = trace.reduce(events)
    assert r["batches"] == 2 and r["span_s"] == pytest.approx(200e-6)
    assert r["busy_s"] == pytest.approx((60 + 10 + 40) * 1e-6)
    assert r["kernels"] == 3 and r["syncs"] == 2
    assert r["device_ops"][0] == ["k1", pytest.approx(70e-6)]
    gaps = dict((name, s) for name, s in r["idle_gaps"])
    # The gap 0..20 is split: 0..10 in the batch span alone, 10..12 and
    # 14..20 in aten::topk, 12..14 in the launch inside it; 80..120,
    # 130..150 and 190..200 lie in the batch spans alone.
    assert gaps["aten::topk"] == pytest.approx(8e-6)
    assert gaps["cudaLaunchKernel"] == pytest.approx(2e-6)
    assert gaps[trace.BATCH_SPAN] == pytest.approx((10 + 40 + 20 + 10) * 1e-6)
    assert sum(s for _, s in r["idle_gaps"]) == pytest.approx(200e-6 - r["busy_s"])


def test_a_gap_across_two_batches_is_split_at_the_loop_between_them():
    events = [
        ev("user_annotation", trace.BATCH_SPAN, 0, 100),
        ev("cuda_runtime", "cudaEventSynchronize", 20, 60),
        ev("cpu_op", "aten::copy_", 90, 10),
        ev("user_annotation", trace.BATCH_SPAN, 130, 100),
        ev("cpu_op", "aten::empty", 130, 40),
        ev("kernel", "k1", 20, 60),
        ev("kernel", "k2", 200, 30),
    ]
    gaps = dict((name, s) for name, s in trace.reduce(events)["idle_gaps"])
    # 0..20 and 80..90 in the first batch span, 90..100 in its copy,
    # 100..130 between the spans, 130..170 in aten::empty, 170..200 in the
    # second span.
    assert gaps == pytest.approx({trace.BATCH_SPAN: 60e-6, "aten::copy_": 10e-6,
                                  "(no host span)": 30e-6, "aten::empty": 40e-6})


def test_a_trace_without_batches_reads_nothing():
    assert trace.reduce([ev("kernel", "k", 0, 5)]) is None
