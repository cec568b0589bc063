"""The arithmetic of the readers of the port's span counters: host ms a
call over the window, the spans a quantity sums, nothing read from a
program that keeps no span counter, and the entries that name them in
BENCHMARK.json."""

import pytest

from tokbench import harness
from tokbench.harness import Context

# quantity -> the spans its reader sums
SUMS = {
    "plan_ms_per_call": ["plan"],
    "upload_ms_per_call": ["upload"],
    "stage_a_ms_per_call": ["stage_a"],
    "stages_b_c_ms_per_call": ["stages_b_c", "counts_read"],
    "host_wait_ms_per_call": ["metas_read", "counts_read", "fetch_wait"],
    "fetch_ms_per_call": ["fetch", "fetch_wait"],
    "unpack_split_ms_per_call": ["unpack_split"],
    "facade_ms_per_call": ["special_check"],
}
SPANS = sorted({s for spans in SUMS.values() for s in spans})


def _names(bench, quantity):
    return [m["name"] for m in bench["per_layer"]
            if harness.quantity(m["name"]) == quantity]


@pytest.mark.parametrize("quantity", list(SUMS))
def test_reader_sums_its_spans_per_call(bench, quantity):
    # every span a different number of ms over the window, from a nonzero start
    before = {f"{s}_ns": 7_000 * (k + 1) for k, s in enumerate(SPANS)}
    after = {f"{s}_ns": before[f"{s}_ns"] + 1_000_000 * 2 ** k
             for k, s in enumerate(SPANS)}
    before["host_reads"], after["host_reads"] = 0, 12
    ctx = Context("encode", 4, before, after, None, 0, "")
    want = sum(2 ** SPANS.index(s) for s in SUMS[quantity]) / 4
    names = _names(bench, quantity)
    assert names
    for name in names:
        assert harness.read_metric(name, ctx, harness.ROOT) == pytest.approx(want)


@pytest.mark.parametrize("quantity", list(SUMS))
def test_reader_reads_nothing_without_the_span_counters(bench, quantity):
    """The parent of the spans keeps none of their counters, and one counter
    missing of those a quantity sums is as good as none."""
    before = {"host_reads": 10, "native_chunks": 0, "cold.captures": 5}
    after = {"host_reads": 40, "native_chunks": 0, "cold.captures": 5}
    ctx = Context("count", 10, before, after, None, 0, "")
    for name in _names(bench, quantity):
        assert harness.read_metric(name, ctx, harness.ROOT) is None
    missing = SUMS[quantity][-1]
    ctx.before = {f"{s}_ns": 0 for s in SPANS if s != missing}
    ctx.after = {f"{s}_ns": 10 ** 6 for s in SPANS if s != missing}
    for name in _names(bench, quantity):
        assert harness.read_metric(name, ctx, harness.ROOT) is None


def test_the_entries_of_the_span_metrics(bench):
    encode = ["books-cl100k-encode", "web-r50k-encode"]
    count = ["books-cl100k-count"]
    layers = {"plan_ms_per_call": "engine host path",
              "upload_ms_per_call": "engine host path",
              "stage_a_ms_per_call": "kernels",
              "stages_b_c_ms_per_call": "kernels",
              "host_wait_ms_per_call": "device",
              "fetch_ms_per_call": "engine host path",
              "unpack_split_ms_per_call": "engine host path",
              "facade_ms_per_call": "facade and registry"}
    entries = [m for m in bench["per_layer"] if harness.quantity(m["name"]) in SUMS]
    assert len(entries) == 13
    for m in entries:
        kind = m["name"].split(".")[1]
        assert (m["unit"], m["better"], m["source"]) == (
            "ms/call", "lower", "program_counter")
        assert m["layer"] == layers[harness.quantity(m["name"])]
        assert m["moves"] == f"{kind}_MBps"
        assert m["workloads"] == (encode if kind == "encode" else count)


def test_the_spans_read_are_the_ports():
    from jtokkit_tpu_torch.engine.device import SPANS as PORT

    assert set(SPANS) <= set(PORT)
