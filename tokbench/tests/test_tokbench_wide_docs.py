"""The reader of ``wide_docs_per_call``: the counter's change per call, or
nothing where the program keeps no such counter; and its declaration."""

import pytest

from tokbench import harness
from tokbench.harness import Context

ENCODE_CELLS = ["books-cl100k-encode", "web-r50k-encode", "culturax-cl100k-encode"]


def test_wide_docs_reader_reads_the_counter_or_nothing():
    ctx = Context("encode", 4, {"wide_docs": 100}, {"wide_docs": 4700})
    read = lambda name: harness.read_metric(name, ctx, harness.ROOT)
    assert read("wide_docs_per_call.encode") == pytest.approx(1150.0)
    # a program that keeps no such counter (a port older than the native
    # packer) reads nothing, and the reader does not raise
    ctx.before, ctx.after = {"host_reads": 1}, {"host_reads": 4}
    assert read("wide_docs_per_call.encode") is None


def test_wide_docs_metric_is_declared_for_the_encode_cells(bench):
    (m,) = [m for m in bench["per_layer"] if m["name"] == "wide_docs_per_call.encode"]
    assert (m["unit"], m["source"], m["layer"], m["moves"]) == (
        "docs/call", "program_counter", "engine host path", "encode_MBps")
    assert m["workloads"] == ENCODE_CELLS
    for cell in ENCODE_CELLS:
        assert harness.applies(m, cell)
    assert not harness.applies(m, "books-cl100k-count")
