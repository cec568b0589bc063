"""Named spans of the port's host path.

``with span(engine, "stage_a"):`` does two things:

1. It adds the block's host time (``time.perf_counter_ns``) to the int
   attribute ``stage_a_ns`` of ``engine``, always, beside the engine's
   other counters (``host_reads``, ``native_chunks``). Spans nest: a
   parent's total includes its children's. A span records on the thread
   that runs it, and it closes when the block raises too.
2. Only while a torch profiler records, it opens the range
   ``jtokkit.stage_a`` (``torch.profiler.record_function``), so that the
   stage shows in the profiler's trace on the clock of the kernels it
   issued. With no profiler running no range is entered.

A span adds no synchronisation and no CUDA event: it records what the host
did and what it waited for. A stage that only issues work to the card ends
when the issue ends; the blocking read after it holds the card's time.
"""

from __future__ import annotations

import time

from torch.autograd import profiler

PREFIX = "jtokkit."


class span:
    """Context manager: the host time of its block added to
    ``owner.<name>_ns``, and the profiler range ``jtokkit.<name>`` while a
    profiler records. ``ns`` holds the block's time once it has closed."""

    __slots__ = ("owner", "name", "ns", "_t0", "_range")

    def __init__(self, owner, name: str):
        self.owner = owner
        self.name = name
        self.ns = 0

    def __enter__(self) -> "span":
        self._range = None
        if profiler._is_profiler_enabled:
            self._range = profiler.record_function(PREFIX + self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.ns = time.perf_counter_ns() - self._t0
        attr = self.name + "_ns"
        setattr(self.owner, attr, getattr(self.owner, attr) + self.ns)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False
