"""The arithmetic of the metrics: rates over the whole window, the p95 over
every call, busy time, idle share, gaps and the roofline from a synthetic
trace, and the readers found by name."""

import pytest

from tokbench import harness, trace, yardstick
from tokbench.harness import Context, Window
from tokbench.ring import Ring


def _ring():
    return Ring([["a"], ["bb"], ["ccc"]], [1_000_000, 2_000_000, 3_000_000], [], [])


def test_rate_is_all_the_work_over_all_the_window_and_p95_every_call():
    w = Window(None, batches=[0, 1, 2, 0], latency_s=[0.010, 0.020, 0.030, 0.040],
               returned=[5.5, 6.0, 6.5, 7.0], start=5.0, end=7.0)
    v = harness.end_to_end("encode", 12.5, _ring(), w)
    assert v["encode_MBps"] == pytest.approx((1 + 2 + 3 + 1) / 2.0)
    # numpy's linear percentile over all four calls
    assert v["encode_p95_ms"] == pytest.approx(40 - 0.05 * 3 * 10)
    assert v["setup_s"] == 12.5
    assert set(harness.end_to_end("count", 1, _ring(), w)) == {
        "setup_s", "count_MBps", "count_p95_ms"}
    # the calls returned within the window's first second, and its two
    assert harness.prefixes(_ring(), w, 1.0) == pytest.approx(
        [(3 / 1.0, 20 - 0.05 * 10), (7 / 2.0, 40 - 0.05 * 3 * 10)])


def _events():
    call = lambda ts, dur: {"ph": "X", "cat": "user_annotation", "name": trace.CALL,
                            "ts": ts, "dur": dur, "tid": 1}
    dev = lambda name, ts, dur, cat="kernel": {"ph": "X", "cat": cat, "name": name,
                                               "ts": ts, "dur": dur, "tid": 7}
    op = lambda name, ts, dur: {"ph": "X", "cat": "cpu_op", "name": name,
                                "ts": ts, "dur": dur, "tid": 1}
    return [
        call(0, 1000), call(1500, 500),
        {"ph": "X", "cat": "user_annotation", "name": "ProfilerStep#1", "ts": 0,
         "dur": 1600, "tid": 1},
        op("aten::copy_", 100, 300), op("aten::cat", 1600, 50),
        dev("k1", 200, 100), dev("k1", 250, 150),           # overlap: 200-400
        dev("memcpy", 600, 100, "gpu_memcpy"),              # 600-700
        dev("k2", 1700, 200),                               # 1700-1900
        dev("outside", 3000, 100),                          # after the calls
    ]


def test_activity_merges_device_intervals_inside_the_calls():
    a = trace.activity(_events())
    assert a.span_s == pytest.approx(2000e-6)
    assert a.busy_s == pytest.approx((200 + 100 + 200) * 1e-6)
    assert trace.idle_pct(a) == pytest.approx(100 * (1 - 500 / 2000))
    assert a.device_ops[0] == ("k1", pytest.approx(250e-6))
    # longest first, each named by the innermost host event over its middle
    assert [(n, round(s * 1e6)) for n, s in a.idle_gaps] == [
        ("between calls", 1000),      # 700-1700: in no call
        ("aten::copy_", 200),         # 0-200: under the op
        (trace.CALL, 200),            # 400-600: in the call, under no op
        (trace.CALL, 100),            # 1900-2000
    ]


def test_idle_share_and_roofline_need_device_time():
    assert trace.idle_pct(None) is None
    empty = trace.Activity(busy_s=0.0, span_s=1.0)
    assert trace.idle_pct(empty) is None
    kind = "NVIDIA H100 80GB HBM3"
    ctx = Context("encode", 10, {}, {}, empty, 8_000_000, kind)
    assert yardstick.roofline_pct(ctx) is None
    ctx.activity = trace.Activity(busy_s=0.024, span_s=0.05)
    assert yardstick.roofline_pct(ctx) == pytest.approx(
        100 * 8e6 / 3.35e12 / 0.024)
    ctx.card = "an unknown card"
    assert yardstick.roofline_pct(ctx) is None


def test_required_bytes():
    assert yardstick.required_bytes("encode", 100, 3, 40) == 100 + 160
    assert yardstick.required_bytes("count", 100, 3, 0) == 100 + 12
    with pytest.raises(ValueError):
        yardstick.required_bytes("decode", 1, 1, 1)


def test_every_metric_has_a_reader_by_its_quantity(bench):
    import os

    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(
            harness.ROOT, "tokbench", "metrics", harness.quantity(m["name"]) + ".py"))
    e2e = harness.end_to_end("encode", 1.0, _ring(), Window(
        None, batches=[0], latency_s=[0.1], returned=[1.0], start=0.0, end=1.0))
    for m in bench["end_to_end"]:
        if "books-cl100k-encode" in m.get("workloads", ["books-cl100k-encode"]):
            assert harness.quantity(m["name"]) in e2e


def test_readers():
    a = trace.Activity(busy_s=0.02, span_s=0.05)
    before = {"host_reads": 10, "native_chunks": 0, "cold.captures": 5}
    after = {"host_reads": 40, "native_chunks": 5, "cold.captures": 7}
    ctx = Context("encode", 10, before, after, a, 8_000_000, "NVIDIA H100 80GB HBM3")
    read = lambda name: harness.read_metric(name, ctx, harness.ROOT)
    assert read("host_reads_per_call.encode") == 3.0
    assert read("host_reads_per_call.count") == 3.0
    assert read("native_chunks_per_call.encode") == 0.5
    assert read("graph_captures.encode") == 2
    assert read("device_idle_pct.encode") == pytest.approx(60.0)
    assert read("kernels_roofline.count") == pytest.approx(100 * 8e6 / 3.35e12 / 0.02)
    ctx.activity = None
    assert read("device_idle_pct.encode") is None
    assert read("kernels_roofline.encode") is None
