"""The reader of ``streamed_chunks_per_call``: the counter's change per call,
or nothing where the program keeps no such counter."""

import pytest

from tokbench import harness
from tokbench.harness import Context


def test_streamed_chunks_reader_reads_the_counter_or_nothing():
    ctx = Context("count", 10, {"streamed_chunks": 7}, {"streamed_chunks": 44})
    read = lambda name: harness.read_metric(name, ctx, harness.ROOT)
    assert read("streamed_chunks_per_call.encode") == pytest.approx(3.7)
    assert read("streamed_chunks_per_call.count") == pytest.approx(3.7)
    # a program that keeps no such counter (a port older than the streamed
    # call) reads nothing
    ctx.before, ctx.after = {"host_reads": 1}, {"host_reads": 4}
    assert read("streamed_chunks_per_call.count") is None
