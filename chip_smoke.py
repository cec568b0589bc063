#!/usr/bin/env python3
"""Smoke run of the PyTorch port (jtokkit_tpu_torch) on one CUDA card.

    python3 chip_smoke.py                 # the run described below
    python3 chip_smoke.py --profile [DIR] # also torch.profiler windows over
                                          # 2 MB of english (cold encode,
                                          # warmed encode, warmed count:
                                          # device time by kernel), their
                                          # tables also written to DIR

Phases (each raises on failure, and then no result line is printed):

1. Card: requires CUDA; prints nvidia-smi's name and power limit.
2. Build: compiles the kernels (jtokkit_tpu_torch/csrc/scan.cu, gather.cu
   and merge.cu) and the native host engine
   (csrc/jtokkit_native.cc) from the checkout, one nvcc or g++ each, started
   together; prints the build times and each kernel's registers and shared
   memory.
3. Each kernel against its plain PyTorch version on the card, exact int32
   equality. The scan first where a single-pass look-back can go wrong:
   1,000 calls back to back on one scratch and then more and fewer tiles,
   two streams at once, n = 2^24 at four leaves in both directions (more
   tiles than resident blocks), a leaf at an odd offset; then at Stage A's
   shapes, decode's (one max leaf of 2^13, 2^20, 2^24), the one-launch floor
   and ragged ones. The table gather at [4096, 128] lookups of a 2048-entry
   table, at 2^24 lookups and at 4 (the launch floor), at tables of 1, 256,
   the longest bulk copy and the limit, at ragged counts and with
   out-of-range indices. Prints kernel, plain, library and bound times.
4. The profiling entry point (jtokkit_tpu_torch.scripts.profile_gather), the
   gather kernel's path: its lines, and the kernel's launch count.
5. Encode and count at full size on the device merge, the un-planned path
   as users call it: cl100k_base from the public registry on the default
   device, its engine built with native_long=False (so cjk measures the
   device merge, not the host), with its graph cache (the default on a
   card). Per corpus (16 MB english, 2 MB mixed, 1 MB cjk; 1 MiB chunks): a
   first encode_ordinary_batch and count_tokens_batch (each shape seen for
   the first time is captured: Stage A, Stages B-C with one merge kernel a
   bucket), then a second encode, count and
   encode_ordinary_batch_arrays over a fresh seed of the flavor, which must
   replay: at most 3 host reads (encode) or 2 (count) plus one per
   capacity-retry batch, no exit test read back, no eager Stage A run, no
   scan launch by the wrapper, no capture, merge kernel runs; their merge
   rounds, read from the device counters, tokens and counts equal the same
   calls on an engine without the cache (every op eager, each bucket's
   rounds read back), timed beside them. MB/s of every call, the cache's graphs and
   pool bytes after each corpus. Tokens are held against the host oracle
   on a >= 1 MB sample of both batches and on the four conformance CSVs
   (through the registry's cached path, no exit test); counts against
   token lengths; the scan counters show 5 kernel launches per eager cl100k
   Stage A run (the warm-ups before a capture) and no plain-version call.
5b. The merge kernel (jtokkit_tpu_torch/csrc/merge.cu) at the main path's
   bucket shapes, english 8 x 2048 and 16 x 512, cjk 384 x 1024 and
   4096 x 512 (the first chunk of one english and one cjk corpus): the
   kernel alone, the bucket as the engine replays it and the plain loop
   reading its test back; ids, active lanes and rounds equal; device ms of
   each beside the bound.
6. Decode: the tokens of the three corpora go back through
   decode_bytes_batch; the bytes equal the documents' UTF-8 and the numpy
   host decode, with one scan launch per call; special and unknown ids behave
   as the oracle does.
7. Long pieces (native_long=False): english documents with a 5000-byte and
   a 4500-byte piece and a 3000-byte CJK run mixed in; tokens equal the
   oracle, the chunks take the device fallback (3 scan launches per fallback
   chunk beside Stage A's 5 per eager run, its bucket merges on the merge
   kernel), and exactly the pieces over 4096 bytes merge on the host.
   Encode (captures), count and a second encode (replays) read no exit test
   back; the second encode's rounds from the device counters equal an eager
   engine's on the same batch, whose pass is timed beside it.
8. Native routing, through the public registry as users get it: chunks
   routed to the native engine out of all chunks per corpus, encode and
   count MB/s against phase 5's native_long=False engine, a warmed cjk plan;
   tokens equal the device-merge tokens and the oracle; single-text encode,
   encode_ordinary and encode_capped on the four conformance CSVs equal the
   expected rows.
9. Data parallel: a world-1 NCCL group (parallel.mesh.initialize_distributed
   over tcp://localhost), the ShardedTokenizer's cold and warmed count and
   encode over 16 MB english and 1 MB cjk, equal to the single engine's;
   its first encode gathers the layout, the second captures the rank's
   encode graphs, and four warmed passes in turns with the single engine's
   each make 1 host read, 1 all_gather (of the bytes logged) and no
   all_reduce (only the ShardedTokenizer's calls count toward this path's
   scan launches); the all_reduce and all_gather ms; the group is
   destroyed.
10. CLI: python -m jtokkit_tpu_torch.cli info, encode, decode and count as
   subprocesses, started together; outputs equal the oracle's, and one run
   without --device (its registry is on the card); each subprocess reports
   its own scan launches.
11. Entry: jtokkit_tpu_torch.entry.entry() on the card equals the same step
   with device="cpu"; entry.dryrun_multichip(1) runs the sharded count and
   encode on one NCCL rank in a child process, against the oracle.
12. Bench: python -m jtokkit_tpu_torch.bench --mb 16 --budget 240 as a
   subprocess (the headline line first and last, cl100k english device on
   the card, 7 companions and none failed), every other mode of bench.run in
   this process at 4 MB of english (equal totals; host at 0.25 MB equal to
   device there), cli bench --mode device-count as a subprocess (its total
   equal), run_scaling(sizes=[1]) on one NCCL rank in a child process
   (efficiency 1.0); each subprocess reports its own scan launches.
13. Steady state (native_long=False): per corpus, preload_corpus, then count_tokens_corpus cold
   and warmed (the warmed passes are CUDA graph replays and end in one host
   read; totals equal the cold pass and the encode phase; the wrapper
   launches no scan in them, and a torch.profiler window over one replayed
   pass must show exactly the scan kernel launches the graphs recorded),
   a plan of three equal chunks whose block pads with an all-zero chunk, then
   encode_ordinary_batch_arrays over the plan: cold, the pass that captures
   one CUDA graph per chunk, and three replayed passes (one host read each,
   one replay per graph, no Stage A run and no scan launch by the wrapper;
   every array equals the cold pass and the encode phase's tokens, which
   phase 5 held against the oracle), the replayed and the eager cached
   dispatch chunk by chunk, each under torch.cuda.set_sync_debug_mode
   ("error"), the fetch formats (12-bit plane, low halves, int32) timed with
   the pack inside graphs (jtokkit_tpu_torch.scripts.fetch_formats, english),
   the scan's clear falling due under a replay, and a second
   native_long=False engine over the documents that the JAX package routes
   to its wide-bucket merge (buckets of 64 lanes and more; tokens equal the
   oracle's, cold, captured and replayed) and over cjk as graph replays:
   the capture pass, three replayed encodes and, after the count's capture
   pass, three replayed counts, each 1 host read and one replay per graph
   with no scan launch by the wrapper and no merge round; the replays equal
   the eager dispatch chunk by chunk, both under set_sync_debug_mode
   ("error"); capture seconds and pool bytes beside the first plan's. Its
   device traces (one replayed count and one replayed encode per plan, the
   second cjk plan too: scan kernel launches equal the graphs' recordings)
   come after every timed pass of the phases above.
14. Bench count plans: the bench's engine over 16 MB of english, four plans
   in turns of the single engine's count and the world-1 sharded one: five
   passes each split by CUDA events around the graph replays, then one pass
   under the bench's profiler (device ms, busy share, idle gaps).
15. One JSON line of kernel numbers, then the last line
   {"ok": true, "device": {...}}.

Imports nothing of JAX or jtokkit_tpu.
"""

from __future__ import annotations

import argparse
import ast
import csv
import functools
import json
import os
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
REPLACES_SCAN = "jtokkit_tpu/ops/pallas_scan.py:144"  # _scan_stacked
REPLACES_GATHER = "scripts/profile_gather.py:100"  # main -> pal
REPLACES_LOOP = "jtokkit_tpu/ops/merge.py:288"  # merge_rows_t3's lax.while_loop


def log(msg: str) -> None:
    print(msg, flush=True)


def make_leaves(kinds, n, gen):
    """Leaves shaped like Stage A's: sparse positions (else -1) for max and
    last, 0/1 for add."""
    import torch

    idx = torch.arange(n, dtype=torch.int32, device="cuda")
    out = []
    for k in kinds:
        if k == "add":
            out.append(torch.randint(0, 2, (n,), generator=gen, device="cuda",
                                     dtype=torch.int32))
        else:
            keep = torch.rand(n, generator=gen, device="cuda") < 0.1
            out.append(torch.where(keep, idx, -1))
    return out


def timed(fn):
    """(fn's result, seconds by the host clock between two synchronisations
    of the card)."""
    import torch

    torch.cuda.synchronize()
    t = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t


def same(got, want):
    """0-d bool on the card: every leaf of ``got`` equals ``want``'s."""
    import torch

    return torch.stack([(g == w).all() for g, w in zip(got, want)]).all()


def phase_scan_hazards(scan, gen):
    """What a single-pass scan on a persistent scratch can get wrong: stale
    status words, the ticket counter's reset, two streams, forward progress
    with more tiles than resident blocks, unaligned leaves. A hang here
    shows as the caller's time limit, so each case logs a line first."""
    import torch

    def case(kinds, n, reverse=False):
        leaves = make_leaves(kinds, n, gen)
        return leaves, kinds, reverse, scan.scan_leaves_plain(leaves, kinds, reverse=reverse)

    def run(c):
        return scan.scan_leaves_cuda(c[0], c[1], reverse=c[2])

    log("scan: 1,000 calls back to back on one scratch, then more tiles, then fewer")
    first = case(("max", "max", "add"), 1 << 20)
    more = case(("last",) * 4, (1 << 22) + 5, True)
    fewer = case(("add",), 5000)
    run(first)  # the stream's scratch exists from here on
    scratch = scan.SCRATCH[(torch.cuda.current_device(),
                            torch.cuda.current_stream().cuda_stream)].words
    ok = torch.ones((), dtype=torch.bool, device="cuda")
    for _ in range(1000):
        ok &= same(run(first), first[3])
    for c in (more, fewer, first, more):
        ok &= same(run(c), c[3])
    torch.cuda.synchronize()
    if not bool(ok):
        raise AssertionError("scan: repeated calls on one scratch went wrong")
    if scan.SCRATCH[(torch.cuda.current_device(),
                     torch.cuda.current_stream().cuda_stream)].words is not scratch:
        raise AssertionError("scan: the scratch was allocated anew")

    log("scan: two streams at once")
    a = case(("max", "last", "add"), (1 << 22) + 3)
    b = case(("last", "add"), (1 << 21) + 1, True)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    flags = []
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    for _ in range(20):
        for st, c in zip(streams, (a, b)):
            with torch.cuda.stream(st):
                flags.append(same(run(c), c[3]))
    torch.cuda.synchronize()
    if not all(bool(f) for f in flags):
        raise AssertionError("scan: two streams at once went wrong")
    dev = torch.cuda.current_device()
    handles = [st.cuda_stream for st in streams + [torch.cuda.current_stream()]]
    if len({id(scan.SCRATCH[(dev, h)].words) for h in handles}) != 3:
        raise AssertionError("scan: streams share a scratch")

    for reverse in (False, True):
        log(f"scan: n = 2^24 at 4 leaves, reverse={reverse} (more tiles than resident blocks)")
        c = case(("max", "last", "add", "last"), 1 << 24, reverse)
        got = run(c)
        torch.cuda.synchronize()
        if not bool(same(got, c[3])):
            raise AssertionError(f"scan: n = 2^24 at 4 leaves, reverse={reverse}")

    log("scan: leaves at an odd offset (4-byte loads)")
    for reverse in (False, True):
        leaves = [x[1:] for x in make_leaves(("max", "last", "add"), (1 << 20) + 1, gen)]
        if all(x.data_ptr() % 16 == 0 for x in leaves):
            raise AssertionError("scan: the odd-offset leaves are aligned")
        kinds = ("max", "last", "add")
        got = scan.scan_leaves_cuda(leaves, kinds, reverse=reverse)
        want = scan.scan_leaves_plain(leaves, kinds, reverse=reverse)
        torch.cuda.synchronize()
        if not bool(same(got, want)):
            raise AssertionError("scan: leaves at an odd offset")
    log("scan: repeated calls, two streams, 2^24 x 4 and odd offsets equal the plain version")


def phase_kernel(scan):
    import numpy as np
    import torch

    from jtokkit_tpu_torch.scripts.profile_gather import event_ms as device_ms

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    phase_scan_hazards(scan, gen)
    main_shapes = [
        # (kinds, n, reverse): Stage A's scans at a 1 MiB chunk
        (("max", "max", "max"), 1 << 20, False),   # boundary scan 1, ascii
        (("max", "max", "add"), 1 << 20, False),   # boundary scan 1, unicode
        (("max", "max", "max"), 1 << 20, False),   # boundary scan 2, unicode
        (("last", "last", "last"), 1 << 20, True),  # boundary scan 3, ascii
        (("last",) * 4, 1 << 20, True),            # boundary scan 3, unicode
        (("max", "max"), 1 << 18, False),          # masked_rows stitch
        (("max", "max"), 1 << 15, False),          # masked_positions, ascii
        (("max", "max"), 1 << 17, False),          # masked_positions, unicode
        # the 12-bit plane's escape side stream, which the steady phase's
        # fetch-format study times (masked_positions at its capacity, a
        # power of two from 1,024 up)
        (("max", "max"), 1 << 10, False),
        (("max", "max"), 1 << 11, False),
        (("max", "max"), 1 << 12, False),
        (("max", "max"), 1 << 13, False),
        (("max", "max"), 1 << 14, False),
        (("max", "max"), 1 << 16, False),
        # decode: one leaf of the output capacity (8 KB, 1 MB and 16 MB of text)
        (("max",), 1 << 13, False),
        (("max",), 1 << 20, False),
        (("max",), 1 << 24, False),
        # the floor: one launch of one block
        (("max",), 1, False),
        # more tiles than resident blocks, both directions
        (("max",) * 4, 1 << 24, False),
        (("last",) * 4, 1 << 24, True),
    ]
    max_err = 0
    rows = []
    for kinds, n, reverse in main_shapes:
        leaves = make_leaves(kinds, n, gen)
        got = scan.scan_leaves_cuda(leaves, kinds, reverse=reverse)
        want = scan.scan_leaves_plain(leaves, kinds, reverse=reverse)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            err = int((g.long() - w.long()).abs().max())
            max_err = max(max_err, err)
            if err:
                raise AssertionError(f"kernel != plain at {kinds} n={n}")
        ms = device_ms(lambda: scan.scan_leaves_cuda(leaves, kinds, reverse=reverse), 200)
        slow_iters = 50 if n <= 1 << 20 else (5 if len(kinds) == 1 else 2)
        plain_ms = device_ms(lambda: scan.scan_leaves_plain(leaves, kinds, reverse=reverse), slow_iters)
        library_ms = None
        if "last" not in kinds:
            def library():
                for x, k in zip(leaves, kinds):
                    if k == "max":
                        torch.cummax(x, 0)
                    else:
                        torch.cumsum(x, 0, dtype=torch.int32)
            library_ms = device_ms(library, slow_iters)
        bound_ms = 2 * len(kinds) * n * 4 / HBM_BYTES_PER_S * 1e3
        rows.append({
            "kinds": list(kinds), "n": n, "reverse": reverse, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
        })
        lib = "null" if library_ms is None else f"{library_ms:.4f}"
        log(f"scan {','.join(kinds):<16} n={n:<8} rev={int(reverse)}  kernel "
            f"{ms:.4f} ms  plain {plain_ms:.4f} ms  library {lib} ms  "
            f"bound {bound_ms:.4f} ms  ({bound_ms / ms:.0%} of bound)")

    # ragged lengths, every kind, both directions
    for n in (1, 127, 129, 4097, 1_000_003):
        for reverse in (False, True):
            for kinds in (("max", "last", "add"), ("add", "max", "last", "last")):
                leaves = make_leaves(kinds, n, gen)
                got = scan.scan_leaves_cuda(leaves, kinds, reverse=reverse)
                want = scan.scan_leaves_plain(leaves, kinds, reverse=reverse)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    if not torch.equal(g, w):
                        raise AssertionError(f"kernel != plain at {kinds} n={n} rev={reverse}")
    # an add leaf whose sum wraps past int32
    big = torch.full((1 << 20,), 1 << 30, dtype=torch.int32, device="cuda")
    got = scan.scan_leaves_cuda([big], ["add"])[0].cpu().numpy()
    want = (np.arange(1, (1 << 20) + 1, dtype=np.int64) << 30).astype(np.uint64)
    want = (want & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    if not np.array_equal(got, want):
        raise AssertionError("int32 add does not wrap")
    log(f"kernel == plain version on every shape (max_abs_err {max_err})")
    return rows, max_err


def phase_gather(gather):
    """The table gather against its plain version; times at the profiled
    shape ([4096, 128] lookups of a 2048-entry table)."""
    import torch

    from jtokkit_tpu_torch.scripts.profile_gather import event_ms as device_ms

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                             dtype=torch.int32)

    def check(table, idx, what):
        got = gather.take_table_cuda(table, idx)
        want = gather.take_table_plain(table, idx)
        torch.cuda.synchronize()
        if got.shape != idx.shape or got.dtype != torch.int32:
            raise AssertionError(f"gather {what}: wrong shape or type")
        if not torch.equal(got, want):
            raise AssertionError(f"gather kernel != plain at {what}")
        return int((got.long() - want.long()).abs().max()) if got.numel() else 0

    max_err = 0
    table = ints(-1000, 1000, (2048,))
    idx = ints(0, 2048, (4096, 128))
    max_err = max(max_err, check(table, idx, "[4096,128] x 2048"))
    for size in (1, 3, 256, gather.MAX_BULK_TABLE, gather.MAX_TABLE):
        t = ints(-1000, 1000, (size,))
        max_err = max(max_err, check(t, ints(0, size, (4096, 128)), f"table {size}"))
        # out-of-range indices clamp, INT32 extremes included
        wild = ints(-3 * size - 5, 4 * size + 5, (1000, 37))
        wild[0, 0], wild[0, 1] = -(1 << 31), (1 << 31) - 1
        max_err = max(max_err, check(t, wild, f"table {size}, out of range"))
    for n in (0, 1, 127, 1_000_003):
        max_err = max(max_err, check(table, ints(0, 2048, (n,)), f"{n} elements"))
    # a view whose data is not 16-byte aligned takes the scalar loop, and a
    # table at an odd offset is copied by plain loads
    max_err = max(max_err, check(table, ints(0, 2048, (4099,))[1:], "unaligned"))
    max_err = max(max_err, check(ints(-9, 9, (2049,))[1:], idx, "unaligned table"))
    many = ints(-5, 2053, (1 << 24,))
    max_err = max(max_err, check(table, many, "2^24 lookups"))
    before = gather.KERNEL_LAUNCHES
    if gather.take_table_cuda(table, ints(0, 2048, (0, 128))).shape != (0, 128):
        raise AssertionError("gather of no elements: wrong shape")
    if gather.KERNEL_LAUNCHES != before:
        raise AssertionError("gather of no elements launched the kernel")
    try:
        gather.take_table_cuda(ints(0, 9, (gather.MAX_TABLE + 1,)), idx)
    except ValueError:
        pass
    else:
        raise AssertionError("a table over the limit was accepted")

    def timed(tbl, ix, iters):
        """Kernel, plain, index_select and bound ms at one shape."""
        flat = ix.reshape(-1)
        n = ix.numel()
        row = {
            "idx": list(ix.shape), "table": tbl.numel(),
            "ms": device_ms(lambda: gather.take_table_cuda(tbl, ix), iters),
            "plain_ms": device_ms(lambda: gather.take_table_plain(tbl, ix), max(iters // 4, 5)),
            "library_ms": device_ms(lambda: tbl.index_select(0, flat), iters),
            "bound_ms": (4 * n + 4 * n + 4 * tbl.numel()) / HBM_BYTES_PER_S * 1e3,
        }
        log(f"gather {row['idx']} x {row['table']}: kernel {row['ms']:.5f} ms  "
            f"plain {row['plain_ms']:.5f} ms  library (index_select) "
            f"{row['library_ms']:.5f} ms  bound {row['bound_ms']:.5f} ms  "
            f"({row['bound_ms'] / row['ms']:.0%} of bound)")
        return row

    # the profiled shape; where the launch no longer counts; the launch floor;
    # the longest table the bulk copy takes and the limit (plain loads)
    head = timed(table, idx, 500)
    shapes = [head, timed(table, many.clamp(0, 2047), 50), timed(table, ints(0, 2048, (4,)), 500)]
    for size in (gather.MAX_BULK_TABLE, gather.MAX_TABLE):
        shapes.append(timed(ints(-1000, 1000, (size,)), ints(0, size, (4096, 128)), 200))
    log(f"gather kernel == plain version on every shape (max_abs_err {max_err})")
    return {
        "ms": head["ms"], "plain_ms": head["plain_ms"], "library_ms": head["library_ms"],
        "bound_ms": head["bound_ms"], "max_abs_err": max_err,
        "shape": {"idx": [4096, 128], "table": 2048},
        "shapes": shapes, "limit_table_ms": shapes[-1]["ms"],
    }


def phase_profile_gather(gather):
    """The gather kernel's path: the profiling entry point."""
    from jtokkit_tpu_torch.scripts import profile_gather

    gather.KERNEL_LAUNCHES = 0
    gather.PLAIN_CALLS = 0
    rows = profile_gather.main()
    launches, plain = gather.KERNEL_LAUNCHES, gather.PLAIN_CALLS
    if launches <= 0 or plain != 0:
        raise AssertionError(
            f"profile_gather: {launches} kernel launches, {plain} plain calls")
    if not rows or not all(r["ms"] > 0 for r in rows):
        raise AssertionError("profile_gather returned no times")
    log(f"profile_gather: {len(rows)} cases, {launches} gather kernel launches")
    return launches


def load_conformance(name: str):
    """(input, tokens, first tokens up to 10) per row."""
    path = os.path.join(ROOT, "tests", "data", f"{name}_encodings.csv")
    with open(path, newline="") as f:
        return [
            (r["input"], ast.literal_eval(r["output"]),
             ast.literal_eval(r["outputMaxTokens10"]))
            for r in csv.DictReader(f, skipinitialspace=True)
        ]


def sample(docs, mb: float):
    out, size = [], 0
    for d in docs:
        if size >= mb * 1e6:
            break
        out.append(d)
        size += len(d.encode("utf-8"))
    if size < mb * 1e6:
        raise AssertionError("corpus sample smaller than asked")
    return out


def engine_counters(engine):
    """What a call of the engine's un-planned path did, as counters to take
    a difference of."""
    from jtokkit_tpu_torch.ops import merge, scan

    return {"host_reads": engine.host_reads, "exit_tests": merge.EXIT_TESTS,
            "merge_rounds": merge.MERGE_ROUNDS, "stage_a_runs": engine.stage_a_runs,
            "scan_launches": scan.KERNEL_LAUNCHES, "graph_replays": engine.graph_replays,
            "captures": engine.cold_captures, "retries": engine.capacity_retries,
            "merge_kernel_runs": engine.merge_kernel_runs}


def counted(engine, fn):
    """(fn's result, seconds between two synchronisations, the counters'
    differences)."""
    before = engine_counters(engine)
    out, sec = timed(fn)
    after = engine_counters(engine)
    return out, sec, {k: after[k] - before[k] for k in before}


def call_breakdown(engine, fn):
    """Host-clock split of one un-planned call of ``fn`` on ``engine``: the
    deltas of the engine's span counters (``<span>_ns``,
    ``jtokkit_tpu_torch/utils/spans.py``) around the call, for each span the
    call ran, in the order of ``engine/device.py``'s ``SPANS`` (the call
    span ``encode`` or ``count`` first, its stages after it). Returns ms per
    span, in order."""
    import torch

    from jtokkit_tpu_torch.engine.device import SPANS

    torch.cuda.synchronize()
    before = {name: getattr(engine, f"{name}_ns") for name in SPANS}
    fn()
    return [(name, (getattr(engine, f"{name}_ns") - ns) / 1e6)
            for name, ns in before.items() if getattr(engine, f"{name}_ns") != ns]


def phase_main_path(card: str):
    """Phase 5: the un-planned path, first and second calls, beside the same
    calls issued eagerly (see the module docstring)."""
    import torch

    from jtokkit_tpu_torch import Encodings, EncodingType
    from jtokkit_tpu_torch.engine.device import DeviceEngine
    from jtokkit_tpu_torch.ops import merge, scan
    from jtokkit_tpu_torch.utils import corpus

    t0 = time.time()
    registry = Encodings.new_default_encoding_registry()
    enc = registry.get_encoding(EncodingType.CL100K_BASE)
    # the device merge for every chunk: no routing to the native engine. The
    # engine runs the un-planned path from its graph cache (the default on a
    # card); "eager" is the same path with every op issued from the host and
    # each bucket's merge reading its rounds back, the reference it is held to
    engine = DeviceEngine.from_oracle(enc.oracle, native_long=False)
    eager = DeviceEngine.from_oracle(enc.oracle, native_long=False, cold_cache=False)
    if engine.device.type != "cuda" or engine.chunk_bytes != 1 << 20 \
            or not engine.cold_cache or eager.cold_cache:
        raise AssertionError(f"engine on {engine.device}, chunk {engine.chunk_bytes}")
    log(f"registry + cl100k tables on {engine.device}, engines built with "
        f"native_long=False (graph cache on; and off): {time.time() - t0:.1f} s")

    sizes = {"english": 16, "mixed": 2, "cjk": 1}
    # warm-up (allocator, library handles) at an 8 KB chunk, a shape the
    # corpora do not have: not counted
    warm_docs = ["warm-up text, not counted. " * 100]
    for e in (engine, eager):
        e.encode_ordinary_batch(warm_docs)
        e.count_tokens_batch(warm_docs)
    torch.cuda.synchronize()

    scan.KERNEL_LAUNCHES = 0
    scan.PLAIN_CALLS = 0
    merge.MERGE_ROUNDS = 0
    launches = runs = 0  # the cached engine's; the eager reference's are not
    merge_runs0 = engine.merge_kernel_runs
    exit_tests0, fallback0 = merge.EXIT_TESTS, engine.fallback_chunks
    results, summary = {}, {}
    oracle = enc.oracle
    for name, size in sizes.items():
        docs = corpus.generate(size, flavor=name)
        fresh = corpus.generate(size, seed=1, flavor=name)
        mb = sum(len(d.encode("utf-8")) for d in docs) / 1e6
        mb1 = sum(len(d.encode("utf-8")) for d in fresh) / 1e6
        calls = {}
        # the first calls meet the corpus's shapes: each new one is captured
        tokens, enc_s, calls["first_encode"] = counted(
            engine, lambda: engine.encode_ordinary_batch(docs))
        counts, cnt_s, calls["first_count"] = counted(
            engine, lambda: engine.count_tokens_batch(docs))
        # a fresh seed of the same flavor: its shapes are cached, the calls replay
        got, enc1_s, calls["second_encode"] = counted(
            engine, lambda: engine.encode_ordinary_batch(fresh))
        counts1, cnt1_s, calls["second_count"] = counted(
            engine, lambda: engine.count_tokens_batch(fresh))
        arrays, arr1_s, calls["second_encode_arrays"] = counted(
            engine, lambda: engine.encode_ordinary_batch_arrays(fresh))
        if name == "english":
            for label, fn in (("encode arrays", lambda: engine.encode_ordinary_batch_arrays(fresh)),
                              ("count", lambda: engine.count_tokens_batch(fresh))):
                split = call_breakdown(engine, fn)
                summary.setdefault("breakdown", {})[label] = split
                log(f"  {label}, seed 1 again, host ms by span: "
                    + ", ".join(f"{n} {ms:.1f}" for n, ms in split) + f" [{card}]")
        stats = engine.cold_cache_stats()
        for c in calls.values():
            launches += c["scan_launches"]
            runs += c["stage_a_runs"]
        # the same bytes, eagerly: tokens, counts and merge rounds to hold the
        # replays to
        want, e_enc_s, e_enc = counted(eager, lambda: eager.encode_ordinary_batch(fresh))
        want_counts, e_cnt_s, e_cnt = counted(eager, lambda: eager.count_tokens_batch(fresh))
        for label, c, limit, eager_c in (
                ("encode", calls["second_encode"], 3, e_enc),
                ("count", calls["second_count"], 2, e_cnt),
                ("encode arrays", calls["second_encode_arrays"], 3, e_enc)):
            if c["host_reads"] > limit + c["retries"] or c["exit_tests"] != 0 \
                    or c["stage_a_runs"] != 0 or c["scan_launches"] != 0 or c["captures"] != 0:
                raise AssertionError(f"{name}: second un-planned {label} did not replay: {c}")
            if c["merge_rounds"] != eager_c["merge_rounds"] or c["merge_kernel_runs"] <= 0:
                raise AssertionError(
                    f"{name}: second {label}: {c['merge_rounds']} merge rounds from the device "
                    f"counters, {eager_c['merge_rounds']} in the eager path")
        if any(c["exit_tests"] for c in calls.values()):
            raise AssertionError(f"{name}: the cached path read an exit test back: {calls}")
        if got != want or counts1 != want_counts or counts1 != [len(t) for t in want] \
                or [a.tolist() for a in arrays] != want:
            raise AssertionError(f"{name}: the replays differ from the eager path")
        if counts != [len(t) for t in tokens]:
            raise AssertionError(f"{name}: counts differ from token lengths")
        for batch, toks in ((docs, tokens), (fresh, got)):
            for d, g in zip(sample(batch, 1.0), toks):
                if g != oracle.encode_ordinary(d)[0]:
                    raise AssertionError(f"{name}: tokens differ from the oracle")
        row = {"mb": mb, "fresh_mb": mb1,
               "first_encode_mb_s": mb / enc_s, "first_count_mb_s": mb / cnt_s,
               "second_encode_mb_s": mb1 / enc1_s, "second_count_mb_s": mb1 / cnt1_s,
               "second_encode_arrays_mb_s": mb1 / arr1_s,
               "eager_encode_mb_s": mb1 / e_enc_s, "eager_count_mb_s": mb1 / e_cnt_s,
               "calls": calls, "eager": {"encode": e_enc, "count": e_cnt},
               "cache": stats}
        summary[name] = row
        n_tok = sum(len(t) for t in tokens)
        log(f"{name}: {mb:.2f} MB, {len(docs)} docs, {n_tok} tokens; first calls (capture "
            f"what is new): encode {row['first_encode_mb_s']:.2f} MB/s "
            f"({calls['first_encode']['captures']} captures, "
            f"{calls['first_encode']['host_reads']} host reads), count "
            f"{row['first_count_mb_s']:.2f} ({calls['first_count']['captures']} captures) "
            f"[{card}]")
        for label in ("second_encode", "second_count", "second_encode_arrays"):
            c = calls[label]
            log(f"  {label.replace('_', ' ')} (seed 1, {mb1:.2f} MB): "
                f"{row[label + '_mb_s']:.2f} MB/s; {c['host_reads']} host reads "
                f"({c['retries']} retry batches), {c['exit_tests']} exit tests, "
                f"{c['stage_a_runs']} eager Stage A runs, {c['scan_launches']} scan "
                f"launches by the wrapper, {c['graph_replays']} replays, "
                f"{c['merge_rounds']} merge rounds from the device counters "
                f"({c['merge_kernel_runs']} merge kernel runs) [{card}]")
        log(f"  eager, same bytes: encode {row['eager_encode_mb_s']:.2f} MB/s "
            f"({e_enc['host_reads']} host reads, {e_enc['exit_tests']} exit tests, "
            f"{e_enc['merge_rounds']} merge rounds), count {row['eager_count_mb_s']:.2f} MB/s "
            f"({e_cnt['host_reads']} host reads); ids, counts and rounds equal; "
            f"{len(sample(fresh, 1.0))} + {len(sample(docs, 1.0))} docs equal the oracle "
            f"[{card}]")
        log(f"  graph cache after {name}: {stats['units']} graphs ({stats['stage_a']['units']} "
            f"Stage A, {stats['stages_b_c']['units']} Stages B-C), pool "
            f"{stats['pool_bytes']} bytes; {stats['captures']} captures in "
            f"{stats['capture_seconds']:.2f} s [{card}]")
        results[name] = (docs, tokens, counts, mb, enc_s, cnt_s)
    plain = scan.PLAIN_CALLS
    fallback_chunks = engine.fallback_chunks - fallback0

    log(f"encode and count (the cached engine): {runs} eager Stage A runs (warm-ups before "
        f"capture), {launches} scan kernel launches, {plain} plain scan calls, "
        f"{merge.EXIT_TESTS - exit_tests0} exit tests in all (the eager engine's included), "
        f"{fallback_chunks} fallback chunks")
    if launches != 5 * runs or runs == 0:
        raise AssertionError(f"{launches} launches for {runs} cl100k Stage A runs")
    if plain != 0:
        raise AssertionError(f"{plain} scans took the plain version")
    if fallback_chunks != 0:
        raise AssertionError(f"{fallback_chunks} chunks took the long-piece fallback")

    for name in ("r50k_base", "p50k_base", "p50k_edit", "cl100k_base"):
        rows = load_conformance(name)
        e = registry.get_encoding(name)
        dev_engine = e.device_engine()
        tests, replays = merge.EXIT_TESTS, dev_engine.graph_replays
        got = e.encode_ordinary_batch([r[0] for r in rows])
        for (text, want, _w10), g in zip(rows, got):
            if g != want or g != e.oracle.encode_ordinary(text)[0]:
                raise AssertionError(f"{name}: conformance row {text!r} differs")
        if e.count_tokens_batch([r[0] for r in rows]) != [len(g) for g in got]:
            raise AssertionError(f"{name}: conformance counts differ")
        if not dev_engine.cold_cache or merge.EXIT_TESTS != tests \
                or dev_engine.graph_replays == replays:
            raise AssertionError(f"{name}: the conformance rows did not take the graph cache")
        log(f"{name}: {len(rows)} conformance rows equal on the card, through the graph "
            f"cache ({dev_engine.graph_replays - replays} replays, 0 exit tests)")
    breakdown = summary.pop("breakdown")
    # every cached call of the phase, the conformance rows' too
    return enc, engine, launches, results, {"corpora": summary,
                                            "merge_kernel_runs":
                                                engine.merge_kernel_runs - merge_runs0,
                                            "breakdown_ms": breakdown}


def phase_loop(engine, card: str):
    """The merge kernel (csrc/merge.cu through ops/merge.py) at the main
    path's bucket shapes: english 8 x 2048 and 16 x 512, cjk 384 x 1024 and
    4096 x 512, from the first chunk of one english and one cjk corpus.
    Each bucket's merge timed three ways, outputs equal (exact): the kernel
    alone (one launch on the bucket's matrix), the bucket as the engine
    replays it (its matrix gathered, then the kernel: one graph), and the
    plain loop eagerly (one exit test read back a round); beside the bytes'
    bound."""
    import torch

    from jtokkit_tpu_torch.engine import device as dev_mod
    from jtokkit_tpu_torch.ops import merge, pipeline, stage4
    from jtokkit_tpu_torch.scripts.profile_gather import event_ms
    from jtokkit_tpu_torch.utils import corpus

    T = engine.tables
    tables = (T.byte_to_id, T.byte_pair_id, T.pair_rows_cat, T.table_mask)
    shapes = []
    max_err = 0
    for flavor, seed, widths in (("english", 5, (8, 16)), ("cjk", 5, (384, 4096))):
        plan = engine.preload_corpus(corpus.generate(1.2, seed=seed, flavor=flavor))
        buf, _de, _parts, ascii_only, buf_dev, de_dev = plan[0]
        divs = dev_mod._DIVS_PRIMARY if ascii_only else dev_mod._DIVS_PRIMARY_UNICODE
        tab, meta = engine._stage_a("ascii" if ascii_only else "unicode", divs,
                                    buf_dev, de_dev)
        counts = meta.cpu().numpy()[2:]
        for b, lanes in enumerate(stage4.BUCKET_WIDTHS):
            cnt = int(counts[b])
            if cnt == 0 or lanes not in widths:
                continue
            cap = engine._bucket_cap(len(buf), lanes, cnt)
            _cols, _live, c_len, mat_t = pipeline.bucket_matrix(
                buf_dev, tab.starts, tab.lens, tab.miss_sorted, tab.group_start[b], cnt,
                lanes=lanes, cap=cap)

            def bucket(fn, rounds):
                cols, live, c_len, mat_t = pipeline.bucket_matrix(
                    buf_dev, tab.starts, tab.lens, tab.miss_sorted, tab.group_start[b],
                    tab.bucket_counts[b], lanes=lanes, cap=cap)
                return fn(mat_t, c_len, *tables, rounds=rounds)

            unit = dev_mod.ColdUnit(("loop", b), [])
            engine._capture(lambda: bucket(merge.merge_rows_t3, 1), [unit],
                            lambda u: bucket(merge.merge_rows_t3, merge.DEVICE),
                            shared_pool=False)
            kernel = merge.merge_rows_t3(mat_t, c_len, *tables, rounds=merge.DEVICE)
            want = merge.merge_rows_t3_plain(mat_t, c_len, *tables)
            unit.graph.replay()  # no scan inside: nothing to account
            outs = {"kernel": kernel, "bucket": unit.out}
            torch.cuda.synchronize()
            err = 0
            for label, (ids, act, counter) in outs.items():
                err = max(err, int((ids != want[0]).sum()), int((act != want[1]).sum()),
                          abs(int(counter) - want[2]))
            if err != 0:
                raise AssertionError(
                    f"merge kernel {flavor} lanes {lanes}: outputs differ from the plain loop "
                    f"({want[2]} rounds): {[(k, int(v[2])) for k, v in outs.items()]}")
            max_err = max(max_err, err)
            row = {
                "flavor": flavor, "lanes": lanes, "cap": cap, "count": cnt,
                "rounds": want[2],
                "ms": event_ms(lambda: merge.merge_rows_t3(mat_t, c_len, *tables,
                                                          rounds=merge.DEVICE), 20),
                "bucket_ms": event_ms(unit.graph.replay, 20),
                "plain_ms": event_ms(lambda: merge.merge_rows_t3_plain(
                    mat_t, c_len, *tables), 2),
                # the bucket's bytes in, ids and active lanes out, once
                "bound_ms": (lanes * cap * (1 + 4 + 1) + cap * 4) / HBM_BYTES_PER_S * 1e3,
            }
            shapes.append(row)
            log(f"merge kernel {flavor} bucket {b} ({lanes} lanes, cap {cap}, {cnt} live): "
                f"ids, active lanes and {want[2]} rounds equal the plain loop's and the "
                f"bucket replay's; kernel {row['ms']:.4f} ms, bucket replay "
                f"{row['bucket_ms']:.4f} ms, plain {row['plain_ms']:.3f} ms, bound "
                f"{row['bound_ms']:.5f} ms [{card}]")
    if [(r["flavor"], r["lanes"]) for r in shapes] != [
            ("english", 8), ("english", 16), ("cjk", 384), ("cjk", 4096)]:
        raise AssertionError(f"phase 5b met other buckets: {[r['lanes'] for r in shapes]}")
    return shapes, max_err


def phase_decode(enc, results, card: str):
    """The corpora's tokens back to bytes on the card."""
    import torch

    from jtokkit_tpu_torch import UnknownTokenError
    from jtokkit_tpu_torch.ops import scan

    engine = enc.device_engine()
    enc.decode_bytes_batch(results["mixed"][1][:16])  # warm-up, not counted
    torch.cuda.synchronize()
    rates = {}
    total_launches = 0
    for name, (docs, tokens, _counts, mb, _e, _c) in results.items():
        scan.KERNEL_LAUNCHES = 0
        scan.PLAIN_CALLS = 0
        t = time.time()
        got = enc.decode_bytes_batch(tokens)
        dec_s = time.time() - t
        launches, plain = scan.KERNEL_LAUNCHES, scan.PLAIN_CALLS
        if launches != 1 or plain != 0:
            raise AssertionError(
                f"decode {name}: {launches} scan launches, {plain} plain scans")
        total_launches += launches
        if got != [d.encode("utf-8") for d in docs]:
            raise AssertionError(f"decode {name}: bytes differ from the documents")
        t = time.time()
        host = engine.decode_bytes_batch_host(tokens)
        host_s = time.time() - t
        if got != host:
            raise AssertionError(f"decode {name}: device and host decode differ")
        if scan.KERNEL_LAUNCHES != 1:
            raise AssertionError("the host decode launched the scan kernel")
        n_tok = sum(len(t) for t in tokens)
        rates[name] = mb / dec_s
        log(f"decode {name}: {mb:.2f} MB from {n_tok} tokens; device path "
            f"{mb / dec_s:.2f} MB/s, numpy host path {mb / host_s:.2f} MB/s, "
            f"1 scan launch [{card}]")

    oracle = enc.oracle
    special = [[100257], [9906], [9906, 100257, 9906]]
    if enc.decode_bytes_batch(special) != [oracle.decode_bytes(t) for t in special]:
        raise AssertionError("decode: special ids differ from the oracle")
    if enc.decode_batch(special)[0] != "<|endoftext|>":
        raise AssertionError("decode: the special token's text is wrong")
    for unknown in (lambda: enc.decode_bytes_batch([[99_999_999]]),
                    lambda: oracle.decode_bytes([99_999_999])):
        try:
            unknown()
        except UnknownTokenError:
            continue
        raise AssertionError("decode: an unknown id did not raise")
    log("decode: special and unknown ids behave as the oracle does")
    return total_launches, rates


def phase_long_pieces(engine, card: str):
    """Chunks with a piece over the largest merge bucket, at 1 MiB chunks, on
    the native_long=False engine: the first encode (captures what is new),
    the count and a second encode replay it, and the fallback's buckets
    merge on the merge kernel, read back with their counters; the same
    encode on an engine without the graph cache reads each bucket's rounds
    back first."""
    import torch

    from jtokkit_tpu_torch.engine import presplit
    from jtokkit_tpu_torch.engine.device import DeviceEngine
    from jtokkit_tpu_torch.ops import merge, scan, stage4
    from jtokkit_tpu_torch.utils import corpus

    docs = corpus.generate(1.5, seed=2, flavor="english")
    long_docs = ["a" * 5000, "x " + "b" * 4500 + " y", "intro " + "中文字" * 333 + " end"]
    for k, d in enumerate(long_docs):
        docs.insert((k + 1) * len(docs) // 4, d)
    mb = sum(len(d.encode("utf-8")) for d in docs) / 1e6
    splitter = presplit.compile_splitter(engine.pattern)
    piece_bytes = [len(d[a:b].encode("utf-8")) for d in docs for a, b in splitter(d)]
    n_over = sum(1 for n in piece_bytes if n > stage4.MAX_PIECE_LEN)
    if n_over != 2 or max(n for n in piece_bytes if n <= 4096) < 2997:
        raise AssertionError(f"long-piece batch: {n_over} pieces over 4096 bytes")

    scan.KERNEL_LAUNCHES = 0
    scan.PLAIN_CALLS = 0
    chunks0, pieces0 = engine.fallback_chunks, engine.host_pieces
    tokens, enc_s, first = counted(engine, lambda: engine.encode_ordinary_batch(docs))
    chunks, pieces = engine.fallback_chunks - chunks0, engine.host_pieces - pieces0
    counts, cnt_s, cnt = counted(engine, lambda: engine.count_tokens_batch(docs))
    again, enc2_s, second = counted(engine, lambda: engine.encode_ordinary_batch(docs))
    launches, plain = scan.KERNEL_LAUNCHES, scan.PLAIN_CALLS
    if plain != 0:
        raise AssertionError(f"long pieces: {plain} scans took the plain version")
    if chunks <= 0 or pieces != n_over:
        raise AssertionError(
            f"long pieces: {chunks} fallback chunks, {pieces} host pieces "
            f"for {n_over} pieces over 4096 bytes")
    if engine.fallback_chunks - chunks0 != 3 * chunks or (
            engine.host_pieces - pieces0 != 3 * n_over):
        raise AssertionError("long pieces: count took another route than encode")
    if counts != [len(t) for t in tokens] or again != tokens:
        raise AssertionError("long pieces: counts differ from token lengths")
    # Stage A's five scans per eager run, the fallback boundaries' three per
    # chunk
    runs = first["stage_a_runs"] + cnt["stage_a_runs"] + second["stage_a_runs"]
    if launches != 5 * runs + 3 * 3 * chunks:
        raise AssertionError(
            f"long pieces: {launches} scan launches for {runs} Stage A runs "
            f"and {3 * chunks} fallback chunks")
    if first["exit_tests"] or cnt["exit_tests"] or second["exit_tests"] \
            or second["captures"] or second["stage_a_runs"] or second["merge_kernel_runs"] <= 0:
        raise AssertionError(f"long pieces: the cached path read exit tests back or "
                             f"captured again: {first}, {cnt}, {second}")
    # the same pass without the graph cache: rounds and tokens to hold it to
    eager = DeviceEngine.from_oracle(engine.oracle, native_long=False, cold_cache=False)
    want, eager_s, eager_c = counted(eager, lambda: eager.encode_ordinary_batch(docs))
    if want != tokens or eager_c["merge_rounds"] != second["merge_rounds"]:
        raise AssertionError(
            f"long pieces: {second['merge_rounds']} rounds from the device counters, "
            f"{eager_c['merge_rounds']} eagerly, or tokens differ")
    oracle = engine.oracle
    for d, got in zip(docs, tokens):
        if got != oracle.encode_ordinary(d)[0]:
            raise AssertionError("long pieces: tokens differ from the oracle")
    log(f"long pieces: {mb:.2f} MB, {len(docs)} docs, {chunks} fallback chunks, "
        f"{pieces} pieces merged on the host, {second['merge_rounds']} merge rounds in an "
        f"encode ({eager_c['merge_rounds']} eagerly), {launches} scan launches (encode, "
        f"count, encode), {second['merge_kernel_runs']} merge kernel runs in the second "
        f"encode; first encode {enc_s:.2f} s ({first['captures']} captures), count "
        f"{cnt_s:.2f} s, second encode {enc2_s:.2f} s ({second['host_reads']} host reads, "
        f"0 exit tests, {second['graph_replays']} replays); without the graph cache "
        f"{eager_s:.2f} s ({eager_c['host_reads']} host reads, {eager_c['exit_tests']} exit "
        f"tests); all docs equal the oracle [{card}]")
    return launches, {"mb": mb, "encode_s": enc_s, "count_s": cnt_s,
                      "second_encode_s": enc2_s, "eager_encode_s": eager_s,
                      "fallback_chunks": chunks, "host_pieces": pieces,
                      "merge_rounds": second["merge_rounds"], "calls": {
                          "first_encode": first, "count": cnt, "second_encode": second,
                          "eager_encode": eager_c}}


def phase_native_routing(enc, results, card: str):
    """The long-piece routing through the public registry, as users get it:
    the registry's engine sends a chunk to the native host engine when its
    pieces over 64 bytes may cover more than a quarter of its bytes. Rates
    beside phase 5's (the same corpora on the native_long=False engine)."""
    import torch

    from jtokkit_tpu_torch import native
    from jtokkit_tpu_torch.ops import scan

    engine = enc.device_engine()
    if not engine.native_long or engine.device.type != "cuda":
        raise AssertionError("the registry's engine does not route long pieces")
    scan.KERNEL_LAUNCHES = 0
    scan.PLAIN_CALLS = 0
    summary = {}
    for name, (docs, tokens, _counts, mb, dm_enc_s, dm_cnt_s) in results.items():
        n_chunks = sum(1 for _ in engine._plan_chunks(docs))
        native0, fallback0 = engine.native_chunks, engine.fallback_chunks
        t = time.time()
        got = enc.encode_ordinary_batch(docs)
        enc_s = time.time() - t
        routed = engine.native_chunks - native0
        t = time.time()
        counts = enc.count_tokens_batch(docs)
        cnt_s = time.time() - t
        if engine.native_chunks - native0 != 2 * routed or engine.fallback_chunks != fallback0:
            raise AssertionError(f"{name}: count took another route than encode")
        if got != tokens or counts != [len(t) for t in tokens]:
            raise AssertionError(f"{name}: routed tokens differ from the device merge's")
        for d, g in zip(sample(docs, 0.1), got):
            if g != enc.oracle.encode_ordinary(d)[0]:
                raise AssertionError(f"{name}: routed tokens differ from the oracle")
        summary[name] = {"chunks": n_chunks, "native_chunks": routed,
                         "encode_mb_s": mb / enc_s, "count_mb_s": mb / cnt_s,
                         "device_merge_encode_mb_s": mb / dm_enc_s,
                         "device_merge_count_mb_s": mb / dm_cnt_s}
        log(f"native routing {name}: {routed} of {n_chunks} chunks to the native engine; "
            f"encode {mb / enc_s:.2f} MB/s, count {mb / cnt_s:.2f} MB/s (native_long=False, "
            f"phase 5: {mb / dm_enc_s:.2f} / {mb / dm_cnt_s:.2f}); tokens equal the device "
            f"merge's and the oracle's [{card}]")
    if summary["cjk"]["native_chunks"] != summary["cjk"]["chunks"]:
        raise AssertionError("not every cjk chunk went to the native engine")
    if summary["english"]["native_chunks"] != 0:
        raise AssertionError("an english chunk went to the native engine")

    # a warmed cjk plan: the cached routing sends its chunks straight to the
    # native engine, with no Stage A
    docs, tokens, _counts, mb = results["cjk"][:4]
    want_total = sum(len(t) for t in tokens)
    plan = engine.preload_corpus(docs)
    count_s, encode_s = [], []
    for k in range(4):
        torch.cuda.synchronize()
        t = time.time()
        total = engine.count_tokens_corpus(docs if k == 0 else None, plan=plan)
        count_s.append(time.time() - t)
        if k == 0:
            runs = engine.stage_a_runs
        t = time.time()
        arrays = engine.encode_ordinary_batch_arrays(None, plan=plan)
        encode_s.append(time.time() - t)
        if total != want_total or [a.tolist() for a in arrays] != tokens:
            raise AssertionError(f"cjk plan pass {k}: differs from the device merge")
    if [c["kind"] for c in plan.chunk_cache] != ["native"] * len(plan):
        raise AssertionError("the cjk plan cached another route")
    if engine.stage_a_runs != runs:
        raise AssertionError("a warmed routed pass ran Stage A")
    summary["cjk_plan"] = {"count_mb_s": [mb / s for s in count_s],
                           "encode_mb_s": [mb / s for s in encode_s]}
    log(f"native routing cjk plan ({len(plan)} chunks): count cold {mb / count_s[0]:.2f}, "
        f"warmed {' / '.join(f'{mb / s:.2f}' for s in count_s[1:])} MB/s; encode "
        f"{mb / encode_s[0]:.2f}, {' / '.join(f'{mb / s:.2f}' for s in encode_s[1:])} MB/s; "
        f"Stage A only in the cold pass [{card}]")

    # single-text calls of the facade run on the native engine
    from jtokkit_tpu_torch import Encodings

    registry = Encodings.new_lazy_encoding_registry()
    for name in ("r50k_base", "p50k_base", "p50k_edit", "cl100k_base"):
        e = enc if name == "cl100k_base" else registry.get_encoding(name)
        if not isinstance(e.native_engine(), native.NativeEngine):
            raise AssertionError(f"{name}: the facade has no native engine")
        rows = load_conformance(name)
        for text, want, want10 in rows:
            if (e.encode(text) != want or e.encode_ordinary(text) != want
                    or e.encode_capped(text, 10).tokens != want10):
                raise AssertionError(f"{name}: single-text row {text!r} differs")
        log(f"{name}: {len(rows)} conformance rows equal through encode, encode_ordinary "
            f"and encode_capped on the native engine")
    launches, plain = scan.KERNEL_LAUNCHES, scan.PLAIN_CALLS
    if plain != 0 or launches <= 0:
        raise AssertionError(f"native routing: {launches} scan launches, {plain} plain")
    summary["slots"] = len(native._slots)
    return launches, summary


def phase_sharded(enc, results, card: str):
    """Data parallel on the card: a world-1 NCCL group (NCCL refuses two ranks
    on one device), the sharded count and encode against the single engine,
    timed in turns with it, and the collectives' times. The launches
    returned are those of the ShardedTokenizer's calls alone."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from jtokkit_tpu_torch.ops import scan
    from jtokkit_tpu_torch.parallel import mesh
    from jtokkit_tpu_torch.parallel.sharded import ShardedTokenizer

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    dev = mesh.initialize_distributed(f"tcp://localhost:{port}", 1, 0)
    if dev.type != "cuda" or dist.get_backend() != "nccl":
        raise AssertionError(f"group on {dev}, backend {dist.get_backend()}")
    engine = enc.device_engine()
    tok = ShardedTokenizer(engine)
    scan.KERNEL_LAUNCHES = 0
    scan.PLAIN_CALLS = 0
    summary = {"world_size": tok.n_dev, "backend": dist.get_backend()}
    launches = 0  # the sharded path's; the single engine's passes between are not

    def sharded(fn):
        nonlocal launches
        before = scan.KERNEL_LAUNCHES
        out = fn()
        launches += scan.KERNEL_LAUNCHES - before
        return out

    for name in ("english", "cjk"):
        docs, tokens, _counts, mb = results[name][:4]
        want_total = sum(len(t) for t in tokens)
        want = [np.asarray(t, np.int32) for t in tokens]
        plan = sharded(lambda: tok.preload_corpus(docs))
        single = engine.preload_corpus(docs)
        row = {"mb": mb}
        for label, fn in (
            ("count", lambda p: sharded(lambda: tok.count_tokens_corpus(None, plan=p))),
            ("single_count", lambda p: engine.count_tokens_corpus(None, plan=p)),
        ):
            p = plan if label == "count" else single
            cold, cold_s = timed(lambda: fn(p))
            first, first_s = timed(lambda: fn(p))  # captures the graphs
            warm = [timed(lambda: fn(p)) for _ in range(3)]
            if {cold, first, *[w[0] for w in warm]} != {want_total}:
                raise AssertionError(f"sharded {name}: {label} differs from the encode phase")
            row[label] = {"cold_mb_s": mb / cold_s, "capture_pass_s": first_s,
                          "warm_mb_s": [mb / w[1] for w in warm]}
        # encode: two passes over each plan (the sharded one's first gathers
        # the layout, its second captures the rank's encode graphs), then
        # warmed passes in turns, sharded first; each warmed sharded pass is
        # 1 host read and 1 all_gather, with no all_reduce
        def sharded_encode():
            return sharded(lambda: tok.encode_ordinary_batch_arrays(None, plan=plan))

        def single_encode():
            return engine.encode_ordinary_batch_arrays(None, plan=single)

        warmup = {}
        for label, fn in (("encode", sharded_encode), ("single_encode", single_encode)):
            warmup[label] = []
            for _ in range(2):
                arrays, sec = timed(fn)
                warmup[label].append(mb / sec)
                if len(arrays) != len(want) or any(
                        not np.array_equal(a, w) for a, w in zip(arrays, want)):
                    raise AssertionError(f"sharded {name}: {label} differs from the encode phase")
        turns = {"encode": [], "single_encode": []}
        for _ in range(4):
            for label, fn in (("encode", sharded_encode), ("single_encode", single_encode)):
                reads, coll = engine.host_reads, dict(tok.collectives)
                arrays, sec = timed(fn)
                turns[label].append(mb / sec)
                if len(arrays) != len(want) or any(
                        not np.array_equal(a, w) for a, w in zip(arrays, want)):
                    raise AssertionError(f"sharded {name}: warmed {label} differs from the "
                                         f"encode phase")
                made = {k: tok.collectives[k] - coll[k] for k in coll}
                if label == "encode" and (engine.host_reads - reads != 1 or made != {
                        "all_reduce": 0, "all_gather": 1}):
                    raise AssertionError(
                        f"sharded {name}: a warmed {label} pass made "
                        f"{engine.host_reads - reads} host reads and collectives {made}")
        row["encode_warmup_mb_s"] = warmup["encode"]
        row["single_encode_warmup_mb_s"] = warmup["single_encode"]
        row["encode_mb_s"] = turns["encode"]
        row["single_encode_mb_s"] = turns["single_encode"]
        row["gathered_bytes"] = plan.recv.numel() * plan.recv.element_size()
        row["encode_graphs"] = len(plan.plan.encode_graphs or [])
        row["routed_chunks"] = sum(c["kind"] != "ok" for c in plan.plan.chunk_cache)
        summary[name] = row
        c, sc = row["count"], row["single_count"]
        log(f"sharded {name} {mb:.2f} MB, world 1 (NCCL): count cold {c['cold_mb_s']:.2f}, "
            f"warmed {' / '.join(f'{x:.2f}' for x in c['warm_mb_s'])} MB/s; single engine "
            f"cold {sc['cold_mb_s']:.2f}, warmed {' / '.join(f'{x:.2f}' for x in sc['warm_mb_s'])}; "
            f"encode first two passes {' / '.join(f'{x:.2f}' for x in warmup['encode'])} "
            f"(single {' / '.join(f'{x:.2f}' for x in warmup['single_encode'])}), warmed in "
            f"turns sharded / single: "
            + ", ".join(f"{a:.2f} / {b:.2f}" for a, b in zip(turns["encode"],
                                                             turns["single_encode"]))
            + f" MB/s; each warmed sharded pass 1 host read, 1 all_gather of "
            f"{row['gathered_bytes']} bytes, 0 all_reduce ({row['encode_graphs']} encode "
            f"graphs, {row['routed_chunks']} host-routed chunks on the rank); totals and "
            f"arrays equal the single engine's [{card}]")
    plain = scan.PLAIN_CALLS
    if plain != 0 or launches <= 0:
        raise AssertionError(f"sharded: {launches} scan launches, {plain} plain calls")

    # the collectives alone, at this path's shapes: the count's one int64
    # and the english encode's gathered tokens (int32)
    def coll_ms(fn, n=20):
        times = []
        for _ in range(n):
            _out, sec = timed(fn)
            times.append(sec * 1e3)
        return sorted(times)[n // 2]

    one = torch.ones(1, dtype=torch.int64, device=dev)
    size = sum(len(t) for t in results["english"][1])
    payload = torch.zeros(size, dtype=torch.int32, device=dev)
    gathered = [torch.empty_like(payload)]
    summary["all_reduce_ms"] = coll_ms(lambda: dist.all_reduce(one))
    summary["all_gather_ms"] = coll_ms(lambda: dist.all_gather(gathered, payload))
    summary["all_gather_bytes"] = 4 * size
    summary["collectives"] = dict(tok.collectives)
    dist.destroy_process_group()
    log(f"sharded collectives (median of 20, host clock): all_reduce of 1 int64 "
        f"{summary['all_reduce_ms']:.3f} ms, all_gather of {4 * size} bytes "
        f"{summary['all_gather_ms']:.3f} ms; the tokenizer made {tok.collectives}; "
        f"{launches} scan kernel launches in the sharded calls (the single engine's "
        f"{scan.KERNEL_LAUNCHES - launches} apart); group destroyed [{card}]")
    return launches, summary


COUNTED = ("import json, sys\n"
           "from jtokkit_tpu_torch import {module}\n"
           "from jtokkit_tpu_torch.ops import scan\n"
           "{module}.main(sys.argv[1:])\n"
           "print(json.dumps({{'scan_launches': scan.KERNEL_LAUNCHES}}), file=sys.stderr)")


def start_counted(module: str, argv):
    """``python -m jtokkit_tpu_torch.<module> *argv`` as a subprocess: it calls
    the module's ``main`` as ``-m`` does, then prints its scan launch count on
    its last line of standard error."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-c", COUNTED.format(module=module), *argv], env=env,
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_counted(name: str, p, timeout: float):
    """(standard output, scan launches) of a :func:`start_counted` process;
    raises if it failed, and kills it on the timeout."""
    try:
        stdout, stderr = p.communicate(timeout=timeout)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    if p.returncode != 0:
        raise AssertionError(f"{name} exited {p.returncode}:\n{stderr[-2000:]}")
    last = [x for x in stderr.splitlines() if x.startswith('{"scan_launches"')]
    if not last:
        raise AssertionError(f"{name} printed no launch count:\n{stderr[-2000:]}")
    return stdout, json.loads(last[-1])["scan_launches"]


def phase_cli(enc, card: str):
    """The CLI as users run it: one subprocess per subcommand, all started
    together; outputs equal the oracle's. The decode and the count run
    without --device (the CUDA card by default). Each subprocess calls
    ``cli.main`` as ``python -m jtokkit_tpu_torch.cli`` does and then prints
    its scan launch count on its last line of standard error; returns their
    sum."""
    from jtokkit_tpu_torch import cli

    text = "Hello, world! 中文 🙂 <|endoftext|> twice"
    oracle = enc.oracle
    ids = oracle.encode_ordinary(text)[0]
    runs = {
        "info": ["info"],
        "encode": ["encode", "--ordinary", "--device", "cuda", text],
        "decode": ["decode"] + [str(i) for i in ids],
        "count": ["count", "--ordinary", text],
        "encode_r50k": ["encode", "--encoding", "r50k_base", "--device", "cuda:0", "I'm 42"],
    }
    t = time.time()
    procs = {k: start_counted("cli", argv) for k, argv in runs.items()}
    out, launches = {}, {}
    try:
        for k, p in procs.items():
            out[k], launches[k] = finish_counted(f"cli {k}", p, 300)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.time() - t
    info = json.loads(out["info"])
    if info["encodings"] != ["r50k_base", "p50k_base", "p50k_edit", "cl100k_base"]:
        raise AssertionError(f"cli info: {info['encodings']}")
    from jtokkit_tpu_torch import Encodings

    r50k = Encodings.new_lazy_encoding_registry().get_encoding("r50k_base")
    checks = {
        "encode": json.loads(out["encode"]) == ids,
        "decode": out["decode"] == text,
        "count": int(out["count"]) == len(ids),
        "encode_r50k": json.loads(out["encode_r50k"]) == r50k.oracle.encode_ordinary("I'm 42")[0],
    }
    if not all(checks.values()):
        raise AssertionError(f"cli outputs differ from the oracle: {checks}")
    default = cli._get_encoding("cl100k_base", None).device_engine().device
    if default.type != "cuda":
        raise AssertionError(f"the CLI's default registry is on {default}")
    log(f"cli: info, encode, decode, count and encode --encoding r50k_base as 5 "
        f"subprocesses in {seconds:.1f} s; outputs equal the oracle's; without --device "
        f"the registry is on {default}; scan kernel launches by subcommand {launches} [{card}]")
    return sum(launches.values()), {"seconds": seconds, "subcommands": sorted(runs),
                                    "scan_launches": launches}


def phase_entry(card: str):
    """The entry step (``entry.entry()``) on the card against the same step
    on the CPU, and ``entry.dryrun_multichip(1)``: one NCCL rank on the card
    in a child process, which prints its scan launches. Returns the launches
    of each."""
    import re

    import numpy as np

    from jtokkit_tpu_torch import entry
    from jtokkit_tpu_torch.ops import scan

    fn, args = entry.entry()
    if any(a.device.type != "cuda" for a in args):
        raise AssertionError("entry(): example arguments are not on the card")
    scan.KERNEL_LAUNCHES = 0
    scan.PLAIN_CALLS = 0
    got = [x.cpu().numpy() for x in fn(*args)]
    launches, plain = scan.KERNEL_LAUNCHES, scan.PLAIN_CALLS
    cpu_fn, cpu_args = entry.entry(device="cpu")
    want = [x.numpy() for x in cpu_fn(*cpu_args)]
    if len(got) != len(want) or not all(np.array_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("entry(): the step on the card differs from the CPU's")
    if launches != 5 or plain != 0:
        raise AssertionError(f"entry(): {launches} scan launches, {plain} plain calls")
    log(f"entry: Stage A v4 + merge_rows_t3 on the card equal the CPU step "
        f"(meta {got[0].tolist()}, {int(got[3].sum())} active ids); {launches} scan "
        f"kernel launches [{card}]")

    t = time.time()
    out = entry.dryrun_multichip(1, timeout=300)[0]
    found = re.search(r"rank 0: (\d+) scan kernel launches", out)
    if "on cuda:0" not in out or "all_gather encode ok" not in out or not found:
        raise AssertionError(f"dryrun_multichip(1): {out[-2000:]}")
    dry_launches = int(found.group(1))
    if dry_launches <= 0:
        raise AssertionError("dryrun_multichip(1) launched no scan kernel")
    log(f"entry: dryrun_multichip(1) on one NCCL rank in {time.time() - t:.1f} s: "
        f"count and encode equal the oracle; {dry_launches} scan kernel launches [{card}]")
    return launches, dry_launches


BENCH_MODES = ("device-lists", "device-count", "decode", "device-decode", "native",
               "native-mt", "sharded", "sharded-count")


def phase_bench(card: str):
    """The benchmark module (jtokkit_tpu_torch.bench) on the card: (a) ``python
    -m jtokkit_tpu_torch.bench`` as users run it, its line contract and its 7
    companions; (b) every other mode in this process at 4 MB of english (host
    at 0.25 MB beside device); (c) ``cli bench``; (d) ``run_scaling`` on one
    NCCL rank in a child process. Returns the scan launches of all of it
    (the subprocesses report their own)."""
    from jtokkit_tpu_torch import bench
    from jtokkit_tpu_torch.ops import scan

    launches, summary = {}, {}

    # (a) the module as users run it: headline first, companions, headline last
    t = time.time()
    stdout, launches["main"] = finish_counted(
        "bench", start_counted("bench", ["--mb", "16", "--budget", "240"]), 600)
    lines = stdout.splitlines()
    head, last = json.loads(lines[0]), json.loads(lines[-1])
    if head["metric"] != "cl100k_base encode throughput (device, 1 card)":
        raise AssertionError(f"bench headline: {head['metric']}")
    if (last["metric"], last["value"]) != (head["metric"], head["value"]):
        raise AssertionError("bench: the last line is not the headline")
    companions = last["detail"].get("companions", [])
    if len(companions) != len(bench.COMPANIONS) or any("error" in c for c in companions):
        raise AssertionError(f"bench companions: {companions}")
    skipped = [c["metric"] for c in companions if "skipped" in c]
    summary["main"] = {"seconds": time.time() - t, "headline": head["value"],
                       "tokens": head["detail"]["tokens"],
                       "corpus_mb": head["detail"]["corpus_mb"],
                       "companions": companions}
    log(f"bench main: headline {head['value']} MB/s over {head['detail']['corpus_mb']} MB "
        f"({head['detail']['tokens']} tokens, {head['detail']['card']}); companions "
        + "; ".join(f"{c['metric']} {c.get('value', c.get('skipped'))}" for c in companions)
        + f"; skipped by the budget: {skipped or 'none'}; {launches['main']} scan launches; "
        f"{summary['main']['seconds']:.1f} s [{card}]")

    # (b) every other mode in this process
    scan.KERNEL_LAUNCHES = 0
    scan.PLAIN_CALLS = 0
    rows = {}

    def run(mode, mb, **kw):
        before, t = scan.KERNEL_LAUNCHES, time.time()
        r = bench.run(mb=mb, mode=mode, **kw)
        n = scan.KERNEL_LAUNCHES - before
        log(f"bench {r['metric']}: {r['value']} MB/s over {r['detail']['corpus_mb']} MB "
            f"english, {r['detail']['tokens']} tokens, best of {kw.get('passes', 3)} "
            f"{r['detail']['seconds']} s, {n} scan launches; run {time.time() - t:.1f} s [{card}]")
        rows.setdefault(mode, []).append({"mb": r["detail"]["corpus_mb"], "value": r["value"],
                                          "tokens": r["detail"]["tokens"],
                                          "scan_launches": n})
        return r, n

    totals = {}
    for mode in BENCH_MODES:
        r, n = run(mode, 4, passes=3)
        totals[mode] = r["detail"]["tokens"]
        if (n == 0) != mode.startswith("native"):
            raise AssertionError(f"bench {mode}: {n} scan launches")
    if len(set(totals.values())) != 1:
        raise AssertionError(f"bench: totals differ across modes: {totals}")
    host, n_host = run("host", 0.25, passes=3)
    small, _n = run("device", 0.25, passes=3)
    if n_host != 0 or host["detail"]["tokens"] != small["detail"]["tokens"]:
        raise AssertionError("bench: device differs from the host oracle at 0.25 MB")

    # (c) the CLI's bench
    t = time.time()
    stdout, launches["cli"] = finish_counted(
        "cli bench", start_counted("cli", ["bench", "--mode", "device-count", "--mb", "4"]), 300)
    cli_row = json.loads(stdout)
    if cli_row["detail"]["tokens"] != totals["device-count"]:
        raise AssertionError(f"cli bench: {cli_row['detail']['tokens']} tokens")
    log(f"bench cli: {cli_row['metric']} {cli_row['value']} MB/s, tokens equal; "
        f"{launches['cli']} scan launches, {time.time() - t:.1f} s [{card}]")

    # (d) weak scaling on one NCCL rank in a child process
    t = time.time()
    (row,) = bench.run_scaling(mb_per_dev=4, sizes=[1])
    d = row["detail"]
    if (d["efficiency"], d["backend"], d["tokens"]) != (1.0, "nccl", totals["device-count"]):
        raise AssertionError(f"run_scaling: {row}")
    launches["scaling"] = d["scan_launches"]
    summary["scaling"] = row
    log(f"bench run_scaling(sizes=[1]): {row['value']} MB/s on {d['n_devices']} {d['backend']} "
        f"rank ({d['device']}), efficiency {d['efficiency']}, {d['scan_launches']} scan "
        f"launches, {time.time() - t:.1f} s [{card}]")

    launches["in_process"] = scan.KERNEL_LAUNCHES
    if scan.PLAIN_CALLS != 0:
        raise AssertionError(f"bench: {scan.PLAIN_CALLS} scans took the plain version")
    if min(launches.values()) <= 0:
        raise AssertionError(f"bench: a run launched no scan kernel: {launches}")
    summary["modes"] = rows
    summary["scan_launches"] = launches
    return sum(launches.values()), summary


def replay_passes(engine, fn, n: int):
    """``n`` passes of ``fn`` (a warmed count), each with the card's time
    split by CUDA events recorded around every graph replay of the mapped
    count (``engine._run_block``, wrapped for these passes only), and the
    card's clocks and power as nvidia-smi samples them every 10 ms
    meanwhile: per pass (host ms, ms inside the graphs, idle ms between
    them, the median SM MHz, memory MHz and W of the samples inside the
    pass, or None where none fell inside)."""
    import datetime
    import statistics

    import torch

    marks = []
    real = engine._run_block

    def marked(blk):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = real(blk)
        b.record()
        marks.append((a, b))
        return out

    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,clocks.mem,power.draw",
         "--format=csv,noheader,nounits",
         "-lms", "10"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    engine._run_block = marked
    rows, windows = [], []
    try:
        time.sleep(0.2)  # the sampler's first lines
        for _ in range(n):
            marks.clear()
            torch.cuda.synchronize()
            t0 = time.time()
            t = time.perf_counter()
            fn()
            host = time.perf_counter() - t
            windows.append((t0, time.time()))
            torch.cuda.synchronize()
            rows.append((host * 1e3, sum(a.elapsed_time(b) for a, b in marks),
                         sum(marks[i][1].elapsed_time(marks[i + 1][0])
                             for i in range(len(marks) - 1))))
        time.sleep(0.05)
    finally:
        del engine._run_block  # the class's method again
        smi.terminate()
        samples_out = smi.communicate(timeout=30)[0]
    samples = []
    for line in samples_out.splitlines():
        stamp, *values = line.split(",")
        try:
            when = datetime.datetime.strptime(stamp.strip(), "%Y/%m/%d %H:%M:%S.%f")
            samples.append((when.timestamp(), *map(float, values)))
        except ValueError:
            continue
    out = []
    for row, (lo, hi) in zip(rows, windows):
        inside = [v[1:] for v in samples if lo <= v[0] <= hi]
        out.append(row + (tuple(statistics.median(c) for c in zip(*inside))
                          if inside else None,))
    return out


def phase_bench_profile(card: str, out_dir):
    """The single engine's warmed count against the sharded one (world 1),
    on the bench's engine and one 16 MB english corpus, after every timed
    pass of the script: four plans in turns, each cold, captured, five passes
    split by CUDA events (time inside the graph replays, idle between them),
    then one pass under the bench's profiler (``bench.run``'s
    ``profile_dir``): device ms, busy share, graph replays, idle gaps. The
    traces are kept under ``out_dir/bench`` when a directory is given."""
    import tempfile

    from jtokkit_tpu_torch import bench
    from jtokkit_tpu_torch.ops import scan
    from jtokkit_tpu_torch.parallel.sharded import ShardedTokenizer

    engine = bench._device_engine("cl100k_base")
    docs = bench._load_corpus(16, None, "english")
    mb = sum(len(d.encode("utf-8")) for d in docs) / 1e6
    scan.KERNEL_LAUNCHES = 0
    plans = []
    with tempfile.TemporaryDirectory() as tmp, bench._data_group(engine.device):
        where = os.path.join(out_dir, "bench") if out_dir else tmp
        tok = ShardedTokenizer(engine)
        for k, mode in enumerate(("device-count", "sharded-count") * 2):
            counter = engine if mode == "device-count" else tok
            fn = functools.partial(counter.count_tokens_corpus, None,
                                   plan=counter.preload_corpus(docs))
            totals = {fn(), fn()}  # the cold pass, the pass that captures
            rows = replay_passes(engine, fn, 5)
            detail = {}
            with bench._profile(where, f"{mode}_{k}", engine.device, detail, engine):
                totals.add(fn())
            p = detail["profile"]
            if len(totals) != 1 or p["host_reads"] != 1 or p["graph_replays"] <= 0 \
                    or p["scan_launches"] != 0:
                raise AssertionError(f"bench plan {k} ({mode}): totals {totals}, {p}")
            best = min(r[0] for r in rows)
            plans.append({"mode": mode, "mb_s": mb / best * 1e3,
                          "passes_ms_mhz": rows, "traced": p})
            log(f"count plan {k} ({mode}, {mb:.2f} MB english): best {mb / best * 1e3:.2f} "
                f"MB/s; per pass host / inside the {p['graph_replays']} graphs / idle between "
                f"them, ms (SM MHz, memory MHz, W): "
                + ", ".join(f"{h:.2f} / {g:.2f} / {i:.3f} {c}" for h, g, i, c in rows)
                + f"; traced pass: wall {p['wall_ms']:.2f} ms, kernels {p['device_ms']:.2f} ms "
                f"({p['busy']:.1%} busy, {p['kernels']} kernels), device span "
                f"{p['span_ms']:.2f} ms, largest idle gap {p['max_gap_ms']:.3f} ms, "
                f"{p['gaps_over_0.1ms']} gaps over 0.1 ms [{card}]")
    return scan.KERNEL_LAUNCHES, plans


def profiled_kernels(fn):
    """Run ``fn`` inside a torch.profiler window on the card's activity.
    Returns (fn's result, launches of the scan kernel, all kernel launches),
    both counted from the device trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    scans = sum(e.count for e in device if "scan_lookback_kernel" in e.key)
    return out, scans, sum(e.count for e in device)


def wide_graphs(wide, result, narrow: dict, card: str):
    """A second native_long=False engine over the cjk corpus, whose buckets
    of 64 lanes and more the JAX package gives its wide-bucket merge, as
    graph replays: the cold encode, the pass that captures one
    encode graph per chunk, three replayed encodes, the count's capture
    pass and three replayed counts. Each replayed pass makes 1 host read and
    one replay per graph, with no scan launch by the wrapper, no merge
    round and no Stage A run; the ids equal the encode phase's and, chunk by
    chunk, the eager cached dispatch's, both dispatches under
    ``set_sync_debug_mode("error")``. Returns the summary, the plan under
    ``"plan"``."""
    import numpy as np
    import torch

    from jtokkit_tpu_torch.ops import merge, scan

    docs, tokens, _counts, mb = result[:4]
    want_total = sum(len(t) for t in tokens)

    def counters():
        return (wide.host_reads, wide.graph_replays, scan.KERNEL_LAUNCHES,
                merge.MERGE_ROUNDS, wide.stage_a_runs)

    def replayed(fn, units, what, check):
        """MB/s of three passes of ``fn``, each checked as a replayed pass
        (``check`` holds its result)."""
        rates = []
        for k in range(3):
            before = counters()
            out, sec = timed(fn)
            rates.append(mb / sec)
            made = [a - b for a, b in zip(counters(), before)]
            if made != [1, len(units), 0, 0, 0] or not check(out):
                raise AssertionError(
                    f"wide engine: replayed {what} pass {k} made (host reads, replays, "
                    f"scan launches, merge rounds, Stage A runs) {made} over "
                    f"{len(units)} graphs, or its result differs")
        return rates

    plan = wide.preload_corpus(docs)
    rounds0 = merge.MERGE_ROUNDS
    cold, cold_s = timed(lambda: wide.encode_ordinary_batch_arrays(None, plan=plan))
    cold_rounds = merge.MERGE_ROUNDS - rounds0
    if [a.tolist() for a in cold] != tokens:
        raise AssertionError("wide engine: cjk tokens differ from the encode phase")
    ok = [c for c in plan.chunk_cache if c["kind"] == "ok"]
    wide_buckets = sum(lanes >= 64 for c in ok for _b, lanes, _cap, _n in c["caps"])
    if len(ok) != len(plan) or not wide_buckets:
        raise AssertionError(f"wide engine: {len(ok)} of {len(plan)} chunks on the device, "
                             f"{wide_buckets} wide buckets")
    captured, capture_s = timed(lambda: wide.encode_ordinary_batch_arrays(None, plan=plan))
    graphs = plan.encode_graphs
    if not graphs or len(graphs) != len(ok) or any(g.graph is None for g in graphs):
        raise AssertionError("wide engine: the capture pass made no graph per chunk")
    if any(g.n_scans != 5 for g in graphs) or not all(
            np.array_equal(a, b) for a, b in zip(captured, cold)):
        raise AssertionError("wide engine: the capture pass differs or recorded "
                             f"{[g.n_scans for g in graphs]} scans")
    enc_rates = replayed(
        lambda: wide.encode_ordinary_batch_arrays(None, plan=plan), graphs, "encode",
        lambda arrays: all(np.array_equal(a, b) for a, b in zip(arrays, cold)))

    # the replayed and the eager cached dispatch, chunk by chunk, each with
    # every synchronising call an error
    def dispatched(fn):
        reads = wide.host_reads
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = fn(plan, True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if wide.host_reads != reads or not all(len(r) == 6 for r in res):
            raise AssertionError("wide engine: the cached dispatch read back")
        wide._wait_fetches()
        return [wide._consume_fetch(r[5], n) for r, n in zip(res, plan.n_tokens)]

    replay_ids = dispatched(wide._process_chunks_cached)
    eager_ids = dispatched(wide._dispatch_eager)
    for k, (g, n, r, e) in enumerate(zip(graphs, plan.n_tokens, replay_ids, eager_ids)):
        if not (np.array_equal(r, e) and np.array_equal(g.out[0][:n].cpu().numpy(), e)):
            raise AssertionError(f"wide engine: chunk {k}'s replay differs from the eager "
                                 f"dispatch")

    total, count_capture_s = timed(lambda: wide.count_tokens_corpus(None, plan=plan))
    blocks = plan.mapped_count
    if total != want_total or not blocks or any(b.graph is None for b in blocks):
        raise AssertionError(f"wide engine: count {total} ({want_total}) or no graphs")
    if sum(b.n_live for b in blocks) != len(ok):
        raise AssertionError("wide engine: the count's blocks do not hold every chunk once")
    count_rates = replayed(lambda: wide.count_tokens_corpus(None, plan=plan), blocks,
                           "count", lambda total: total == want_total)
    out = {
        "mb": mb, "chunks": len(plan), "wide_buckets": wide_buckets,
        "encode_cold_mb_s": mb / cold_s, "merge_rounds_cold": cold_rounds,
        "encode_capture_pass_s": capture_s,
        "encode_capture_s": plan.encode_capture_seconds,
        "encode_pool_bytes": plan.encode_pool_bytes,
        "encode_warm_mb_s": enc_rates,
        "encode_rounds_recorded": sum(g.n_rounds for g in graphs),
        "count_capture_pass_s": count_capture_s, "capture_s": plan.capture_seconds,
        "graph_pool_bytes": plan.graph_pool_bytes, "count_warm_mb_s": count_rates,
        "count_rounds_recorded": sum(b.n_rounds for b in blocks),
    }
    log(f"second engine (native_long=False) cjk {mb:.2f} MB, {len(plan)} "
        f"chunks, {wide_buckets} buckets of 64 lanes and more: encode cold {mb / cold_s:.2f} MB/s "
        f"({cold_rounds} merge rounds); capture pass {capture_s:.2f} s ({len(graphs)} "
        f"graphs, capture {plan.encode_capture_seconds:.2f} s, pool "
        f"{plan.encode_pool_bytes} bytes, {out['encode_rounds_recorded']} merge rounds "
        f"recorded); replayed {' / '.join(f'{x:.2f}' for x in enc_rates)} MB/s; count "
        f"capture pass {count_capture_s:.2f} s ({len(blocks)} graphs, capture "
        f"{plan.capture_seconds:.2f} s, pool {plan.graph_pool_bytes} bytes), replayed "
        f"{' / '.join(f'{x:.2f}' for x in count_rates)} MB/s; each replayed pass 1 host "
        f"read, one replay per graph, 0 scan launches by the wrapper, 0 merge rounds, 0 "
        f"Stage A runs; ids equal the encode phase's and the eager dispatch chunk by chunk "
        f"under set_sync_debug_mode('error'). First engine on the same corpus: encode "
        f"capture {narrow['encode_capture_s']:.2f} s, pool {narrow['encode_pool_bytes']} "
        f"bytes, replayed {' / '.join(f'{x:.2f}' for x in narrow['encode_warm_mb_s'])} "
        f"MB/s; count capture {narrow['capture_s']:.2f} s, pool "
        f"{narrow['graph_pool_bytes']} bytes, replayed "
        f"{' / '.join(f'{x:.2f}' for x in narrow['count_warm_mb_s'])} MB/s [{card}]")
    out["plan"] = plan
    return out


def phase_steady_state(engine, results, card: str):
    """The steady-state path over warmed corpus plans, at full width, on the
    native_long=False engine: the corpus-mapped count and the warmed encode
    as graph replays, the eager cached dispatch beside the replayed one, the
    fetch formats timed with the pack inside graphs, and a second engine
    over the buckets the JAX package gives its wide-bucket merge."""
    import numpy as np
    import torch

    from jtokkit_tpu_torch.engine.device import CorpusPlan, DeviceEngine
    from jtokkit_tpu_torch.ops import merge, scan
    from jtokkit_tpu_torch.scripts import fetch_formats

    dev = engine.device
    scan.KERNEL_LAUNCHES = 0
    scan.PLAIN_CALLS = 0
    scan.REPLAYED_SCANS = 0
    summary = {}
    plans = {}
    profiled_scans = 0  # scan kernel launches seen in the replayed windows

    def counters():
        return (engine.host_reads, scan.KERNEL_LAUNCHES, merge.MERGE_ROUNDS,
                engine.stage_a_runs, scan.REPLAYED_SCANS, engine.graph_replays)

    def delta(before):
        return tuple(a - b for a, b in zip(counters(), before))

    for name, (docs, tokens, _counts, mb, _e, _c) in results.items():
        want_total = sum(len(t) for t in tokens)
        plan = engine.preload_corpus(docs)
        if not isinstance(plan, CorpusPlan) or plan.chunk_cache is not None:
            raise AssertionError(f"{name}: preload_corpus gave no fresh CorpusPlan")
        plans[name] = plan

        # ---- count: cold, the pass that captures, three replays
        c0 = counters()
        cold_total, cold_s = timed(lambda: engine.count_tokens_corpus(docs, plan=plan))
        cold_reads, cold_launches, cold_rounds, cold_runs = delta(c0)[:4]
        c0 = counters()
        first_total, first_s = timed(lambda: engine.count_tokens_corpus(None, plan=plan))
        capture_launches = delta(c0)[1]
        blocks = plan.mapped_count
        if not blocks or any(b.graph is None for b in blocks):
            raise AssertionError(f"{name}: the mapped count holds no captured graphs")
        if sum(b.n_live for b in blocks) != len(plan):
            raise AssertionError(f"{name}: the blocks do not cover the plan")
        n_slots = sum(len(b.bufs) for b in blocks)
        recorded = sum(b.n_scans for b in blocks)  # counted while capturing
        rounds = sum(b.n_rounds for b in blocks)
        if recorded != 5 * n_slots:
            raise AssertionError(
                f"{name}: the graphs recorded {recorded} scans for {n_slots} chunk slots")
        warm_s = []
        for _ in range(3):
            c0 = counters()
            total, s = timed(lambda: engine.count_tokens_corpus(None, plan=plan))
            reads, launches, eager_rounds, runs, replayed, replays = delta(c0)
            warm_s.append(s)
            if total != cold_total:
                raise AssertionError(f"{name}: warmed count {total} != cold {cold_total}")
            if reads != 1:
                raise AssertionError(f"{name}: {reads} host reads in a warmed count pass")
            if (launches, eager_rounds, runs) != (0, 0, 0):
                raise AssertionError(
                    f"{name}: a replayed pass ran eagerly: {launches} scan launches of the "
                    f"wrapper, {eager_rounds} merge rounds, {runs} Stage A runs")
            if replays != len(blocks) or replayed != recorded:
                raise AssertionError(
                    f"{name}: {replays} replays of {len(blocks)} graphs, {replayed} scans")
        if not cold_total == first_total == want_total:
            raise AssertionError(
                f"{name}: count {cold_total} / {first_total}, encode phase {want_total}")
        log(f"steady count {name}: {mb:.2f} MB, {len(plan)} chunks in {len(blocks)} "
            f"graphs ({n_slots} chunk slots); cold {mb / cold_s:.2f} MB/s "
            f"({cold_reads} host reads, {cold_rounds} merge rounds, {cold_launches} scan "
            f"launches); capture pass {first_s:.2f} s (capture {plan.capture_seconds:.2f} s, "
            f"pool {plan.graph_pool_bytes} bytes, {capture_launches} launches); warmed "
            f"{' / '.join(f'{mb / s:.2f}' for s in warm_s)} MB/s (1 host read, "
            f"{len(blocks)} replays, no launch by the scan wrapper; the graphs recorded "
            f"{recorded} scans and {rounds} merge rounds) [{card}]")

        # ---- encode: cold (metas + packed fetch), the pass that captures one
        # graph per chunk, three replayed passes (one wait each)
        c0 = counters()
        cold_arrays, enc_cold_s = timed(
            lambda: engine.encode_ordinary_batch_arrays(None, plan=plan))
        enc_cold_reads = delta(c0)[0]
        if plan.n_tokens is None or plan.doc_counts is None or plan.encode_graphs is not None:
            raise AssertionError(f"{name}: the first encode pass did not fill the plan")
        if [a.tolist() for a in cold_arrays] != tokens:
            raise AssertionError(f"{name}: plan encode differs from the encode phase")
        c0 = counters()
        captured, enc_capture_s = timed(
            lambda: engine.encode_ordinary_batch_arrays(None, plan=plan))
        capture_reads, capture_launches = delta(c0)[:2]
        graphs = plan.encode_graphs
        if not graphs or len(graphs) != len(plan) or any(g.graph is None for g in graphs):
            raise AssertionError(f"{name}: the capture pass made no graph per chunk")
        enc_recorded = sum(g.n_scans for g in graphs)
        enc_rounds = sum(g.n_rounds for g in graphs)
        if enc_recorded != 5 * len(graphs):
            raise AssertionError(
                f"{name}: the encode graphs recorded {enc_recorded} scans for {len(graphs)} chunks")
        if capture_reads != 1 or not all(
                np.array_equal(a, b) for a, b in zip(captured, cold_arrays)):
            raise AssertionError(f"{name}: the capture pass differs or read back")
        enc_warm_s = []
        for _ in range(3):
            c0 = counters()
            arrays, s = timed(lambda: engine.encode_ordinary_batch_arrays(None, plan=plan))
            reads, launches, eager_rounds, runs, replayed, replays = delta(c0)
            enc_warm_s.append(s)
            if reads != 1:
                raise AssertionError(f"{name}: {reads} host reads in a warmed encode pass")
            if (launches, eager_rounds, runs) != (0, 0, 0):
                raise AssertionError(
                    f"{name}: a replayed encode ran eagerly: {launches} scan launches of "
                    f"the wrapper, {eager_rounds} merge rounds, {runs} Stage A runs")
            if replays != len(graphs) or replayed != enc_recorded:
                raise AssertionError(
                    f"{name}: {replays} replays of {len(graphs)} encode graphs, {replayed} scans")
            if len(arrays) != len(cold_arrays) or not all(
                    np.array_equal(a, b) for a, b in zip(arrays, cold_arrays)):
                raise AssertionError(f"{name}: warmed encode differs from the cold pass")

        # ---- the replayed and the eager cached dispatch, each with every
        # synchronising call an error, chunk by chunk
        def dispatched(fn):
            reads = engine.host_reads
            torch.cuda.set_sync_debug_mode("error")
            try:
                res = fn(plan, True)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            if engine.host_reads != reads or not all(len(r) == 6 for r in res):
                raise AssertionError(f"{name}: the cached dispatch read back before its fetch")
            engine._wait_fetches()
            return [(engine._consume_fetch(r[5], n), r[2][:n].cpu().numpy(), int(r[3]))
                    for r, n in zip(res, plan.n_tokens)]

        replay_ids = dispatched(engine._process_chunks_cached)
        eager_ids = dispatched(engine._dispatch_eager)
        for k, ((rf, rt, rn), (ef, et, en)) in enumerate(zip(replay_ids, eager_ids)):
            if not (rn == en == plan.n_tokens[k] and np.array_equal(rf, rt)
                    and np.array_equal(rf, ef) and np.array_equal(ef, et)):
                raise AssertionError(f"{name}: chunk {k}'s replay differs from the eager dispatch")
        summary_fetch = ""
        if name == "english":
            # ROADMAP item 19: the fetch formats with the pack inside graphs
            formats = fetch_formats.measure(engine, plan)
            summary_fetch = "; fetch formats (device ms a pass, host ms): " + ", ".join(
                f"{f} {formats[f]['device_ms']:.3f} / {min(formats[f]['host_ms']):.2f} "
                f"({formats[f]['bytes']} bytes)" for f in fetch_formats.FORMATS
            ) + (f", the reference's rule would take the 12-bit plane for "
                 f"{formats['rule_p12_chunks']} of {formats['chunks']} chunks")
        log(f"steady encode {name}: cold {mb / enc_cold_s:.2f} MB/s ({enc_cold_reads} host "
            f"reads); capture pass {enc_capture_s:.2f} s ({len(graphs)} graphs, capture "
            f"{plan.encode_capture_seconds:.2f} s, pool {plan.encode_pool_bytes} bytes, "
            f"{capture_launches} scan launches in its eager warm-up); replayed "
            f"{' / '.join(f'{mb / s:.2f}' for s in enc_warm_s)} MB/s (1 host read, "
            f"{len(graphs)} replays, no launch by the scan wrapper, no Stage A run; the graphs "
            f"recorded {enc_recorded} scans and {enc_rounds} merge rounds); ids equal the "
            f"eager cached dispatch chunk by chunk, both dispatches passed under "
            f"set_sync_debug_mode('error'){summary_fetch} [{card}]")
        summary[name] = {
            "mb": mb, "chunks": len(plan), "graphs": len(blocks),
            "count_cold_mb_s": mb / cold_s, "count_warm_mb_s": [mb / s for s in warm_s],
            "count_cold_host_reads": cold_reads, "count_cold_rounds": cold_rounds,
            "capture_s": plan.capture_seconds, "graph_pool_bytes": plan.graph_pool_bytes,
            "scans_recorded_per_count_pass": recorded,
            "merge_rounds_recorded_per_count_pass": rounds,
            "encode_cold_mb_s": mb / enc_cold_s,
            "encode_capture_pass_s": enc_capture_s,
            "encode_graphs": len(graphs),
            "encode_capture_s": plan.encode_capture_seconds,
            "encode_pool_bytes": plan.encode_pool_bytes,
            "encode_warm_mb_s": [mb / s for s in enc_warm_s],
            "scans_recorded_per_encode_pass": enc_recorded,
            "merge_rounds_recorded_per_encode_pass": enc_rounds,
            "encode_cold_host_reads": enc_cold_reads,
        }
        if name == "english":
            summary[name]["fetch_formats"] = formats

    # the scan's clear of its status words, due under a replay
    entry = scan.SCRATCH[(torch.cuda.current_device(), engine._capture_stream.cuda_stream)]
    entry.calls = scan.CLEAR_EVERY - 1
    plan = plans["english"]
    if engine.count_tokens_corpus(None, plan=plan) != sum(len(t) for t in results["english"][1]):
        raise AssertionError("count after the scratch's clear under replay differs")
    if entry.calls >= scan.CLEAR_EVERY // 2:
        raise AssertionError("the replay did not clear the scan's status words")
    log("scan: the clear of the status words fell due under a replay; the count is unchanged")

    # ---- a remainder block that pads: three equal chunks count as a block
    # of four, the fourth an all-zero chunk
    docs, tokens = results["english"][:2]
    pad_docs, size = [], 0
    while size < 5 << 19:  # 2.5 MiB: three 1 MiB chunks
        pad_docs.append(docs[len(pad_docs)])
        size += len(pad_docs[-1].encode("utf-8"))
    want_total = sum(len(t) for t in tokens[: len(pad_docs)])
    plan = plans["padded"] = engine.preload_corpus(pad_docs)
    totals = [engine.count_tokens_corpus(None, plan=plan) for _ in range(3)]
    blocks = plan.mapped_count
    if not any(len(b.bufs) > b.n_live for b in blocks) or any(b.graph is None for b in blocks):
        raise AssertionError(
            f"padded plan: blocks {[(b.n_live, len(b.bufs)) for b in blocks]} of "
            f"{len(plan)} chunks hold no all-zero chunk")
    if totals != [want_total] * 3:
        raise AssertionError(f"padded plan: counts {totals}, the encode phase's tokens "
                             f"{want_total}")
    if sum(b.n_scans for b in blocks) != 5 * sum(len(b.bufs) for b in blocks):
        raise AssertionError("padded plan: not 5 recorded scans a chunk slot")
    log(f"padded plan: {len(plan)} english chunks in blocks (live, slots) "
        f"{[(b.n_live, len(b.bufs)) for b in blocks]}; cold, capturing and replayed "
        f"count equal the encode phase's {want_total} tokens [{card}]")
    summary["padded"] = {
        "chunks": len(plan), "blocks": [[b.n_live, len(b.bufs)] for b in blocks],
    }

    # ---- a second engine over buckets of 64 lanes and more, which the JAX
    # package merges with its wide-bucket hybrid
    wide = DeviceEngine.from_oracle(engine.oracle, native_long=False)
    if wide.device.type != "cuda":
        raise AssertionError(f"wide engine on {wide.device}")
    wide_docs = [
        "今日はよい天気です" "東京都港区" * 12, "." * 200 + "!" * 90,
        "mixed 短い run with spaces and 漢字" * 6,
        "plain english words stay on the narrow engine.",
    ]
    want = [engine.oracle.encode_ordinary(t)[0] for t in wide_docs]
    small = wide.preload_corpus(wide_docs)
    for k in range(3):
        if [a.tolist() for a in wide.encode_ordinary_batch_arrays(None, plan=small)] != want:
            raise AssertionError(f"wide engine: pass {k} over the four documents differs")
        if wide.count_tokens_corpus(None, plan=small) != sum(len(w) for w in want):
            raise AssertionError(f"wide engine: count pass {k} over the four documents")
    summary["cjk_wide"] = wide_graphs(wide, results["cjk"], summary["cjk"], card)
    plans["cjk_wide"] = summary["cjk_wide"].pop("plan")
    launches, plain_calls = scan.KERNEL_LAUNCHES, scan.PLAIN_CALLS
    replayed = scan.REPLAYED_SCANS
    if plain_calls != 0 or launches <= 0 or replayed <= 0:
        raise AssertionError(f"steady state: {launches} scan launches, {replayed} replayed "
                             f"scans, {plain_calls} plain calls")

    # what a replayed pass really launches, from the device trace: one pass
    # per plan, after every timed pass (no rate is taken once a tracer has
    # been attached to the process)
    want_totals = {name: sum(len(t) for t in results[name][1]) for name in results}
    want_totals["padded"] = want_total
    want_totals["cjk_wide"] = want_totals["cjk"]
    for name, plan in plans.items():
        eng = wide if name == "cjk_wide" else engine
        recorded = sum(b.n_scans for b in plan.mapped_count)
        total, seen, pass_kernels = profiled_kernels(
            lambda: eng.count_tokens_corpus(None, plan=plan))
        if total != want_totals[name] or seen != recorded:
            raise AssertionError(
                f"{name}: the device trace of a replayed pass shows {seen} scan kernel "
                f"launches, the graphs recorded {recorded}; total {total}")
        profiled_scans += seen
        summary[name]["scan_kernels_traced_per_count_pass"] = seen
        summary[name]["kernels_traced_per_count_pass"] = pass_kernels
        log(f"replayed count {name}: the device trace of one pass shows {seen} scan kernel "
            f"launches = the {recorded} its graphs recorded, {pass_kernels} kernels in all")
        if plan.encode_graphs is None:
            continue
        recorded = sum(g.n_scans for g in plan.encode_graphs)
        launches0 = scan.KERNEL_LAUNCHES
        arrays, seen, pass_kernels = profiled_kernels(
            lambda: eng.encode_ordinary_batch_arrays(None, plan=plan))
        if [a.tolist() for a in arrays] != results[name.removesuffix("_wide")][1] or seen != recorded \
                or scan.KERNEL_LAUNCHES != launches0:
            raise AssertionError(
                f"{name}: the device trace of a replayed encode shows {seen} scan kernel "
                f"launches, the graphs recorded {recorded}")
        profiled_scans += seen
        summary[name]["scan_kernels_traced_per_encode_pass"] = seen
        summary[name]["kernels_traced_per_encode_pass"] = pass_kernels
        log(f"replayed encode {name}: the device trace of one pass shows {seen} scan kernel "
            f"launches = the {recorded} its {len(plan.encode_graphs)} graphs recorded, "
            f"{pass_kernels} kernels in all; ids equal the encode phase's")
    replayed = scan.REPLAYED_SCANS
    summary["empty_cache_s"] = engine.empty_cache_seconds
    log(f"steady state: _capture's torch.cuda.empty_cache() took "
        f"{engine.empty_cache_seconds:.3f} s over this engine's plan captures (the "
        f"un-planned path's captures make none) [{card}]")
    log(f"steady state: {launches} scan kernel launches by the wrapper (cold passes, "
        f"warm-ups before capture, eager dispatches), {replayed} more scans inside graph "
        f"replays by the graphs' recordings, of which {profiled_scans} were counted in "
        f"device traces of one pass per plan; 0 plain scan calls")
    return launches, {"recorded": replayed, "profiled": profiled_scans}, summary


def phase_profile(card: str, out_dir: str):
    """Profiler windows over 2 MB of english: the cold encode, a warmed
    encode over a plan (one graph replay per chunk, the copies of the
    packed tokens after each) and a warmed count (graph replays)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from jtokkit_tpu_torch import Encodings, EncodingType
    from jtokkit_tpu_torch.utils import corpus

    enc = Encodings.new_lazy_encoding_registry().get_encoding(EncodingType.CL100K_BASE)
    engine = enc.device_engine()
    docs = corpus.generate(2, seed=1, flavor="english")
    enc.encode_ordinary_batch(docs)
    plan = engine.preload_corpus(docs)
    for _ in range(2):  # cold passes, then the passes that capture
        engine.count_tokens_corpus(None, plan=plan)
        engine.encode_ordinary_batch_arrays(None, plan=plan)
    torch.cuda.synchronize()
    blocks = plan.mapped_count
    log(f"profile plan: {len(plan)} chunks; count in {len(blocks)} graphs, "
        f"{sum(len(b.bufs) for b in blocks)} chunk slots, "
        f"{sum(b.n_scans for b in blocks)} scans recorded; encode in "
        f"{len(plan.encode_graphs)} graphs, {sum(g.n_scans for g in plan.encode_graphs)} "
        f"scans recorded")

    def window(label, fn):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.time()
            fn()
            torch.cuda.synchronize()
            wall = time.time() - t
        events = prof.key_averages()
        table = events.table(sort_by="self_cuda_time_total", row_limit=60)
        device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        kernel_us = sum(e.self_device_time_total for e in device)
        scan_us = sum(
            e.self_device_time_total for e in device
            if "at::native" not in e.key
            and "scan_lookback_kernel" in e.key
        )
        line = (f"profile ({label}, 2 MB english): wall {wall * 1e3:.1f} ms, device "
                f"kernels {kernel_us / 1e3:.1f} ms ({kernel_us / 1e6 / wall:.1%} busy), "
                f"scan kernel {scan_us / 1e3:.3f} ms, "
                f"{sum(e.count for e in device)} kernel launches [{card}]")
        log(line)
        if out_dir:  # the table goes to the file, else to the log
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, f"profile_english_2mb_{label}.txt"), "w") as f:
                f.write(f"{line}\n{table}\n")
        else:
            log(table)

    window("cold_encode", lambda: enc.encode_ordinary_batch(docs))
    window("warmed_encode", lambda: engine.encode_ordinary_batch_arrays(None, plan=plan))
    window("warmed_count", lambda: engine.count_tokens_corpus(None, plan=plan))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", nargs="?", const="", default=None,
                        metavar="DIR", help="add a profiler window")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.time()
    sys.path.insert(0, ROOT)
    from jtokkit_tpu_torch.scripts.profile_gather import card_line

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from jtokkit_tpu_torch import native, pack
    from jtokkit_tpu_torch.ops import gather, merge, scan

    def timed_build(fn):
        t = time.time()
        fn()
        return time.time() - t

    t = time.time()
    libraries = [scan.LIBRARY, gather.LIBRARY, merge.LIBRARY]
    builds = [(lib.name, lib.build) for lib in libraries] + [
        ("native", native.build), ("pack", pack.build)]
    with ThreadPoolExecutor(len(builds)) as pool:  # one compiler each, together
        futures = [(name, pool.submit(timed_build, fn)) for name, fn in builds]
        build_s = {name: f.result() for name, f in futures}
    log(f"build: {len(libraries)} kernels, the native engine and the chunk packer in "
        f"{time.time() - t:.1f} s ({', '.join(f'{k} {v:.1f} s' for k, v in build_s.items())})")
    for lib in libraries:
        log(f"  {lib.name}: {lib.path()}")
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log("    " + line.strip())
    log(f"  native: {native.library_path()}")
    for line in native.BUILD_LOG.splitlines():
        log("    " + line.strip())
    log(f"  pack: {pack.library_path()}")
    for line in pack.BUILD_LOG.splitlines():
        log("    " + line.strip())

    rows, max_err = phase_kernel(scan)
    gather_row = phase_gather(gather)
    gather_launches = phase_profile_gather(gather)
    phase_s = {}

    def phase(name, fn, *fn_args):
        t = time.time()
        out = fn(*fn_args)
        phase_s[name] = time.time() - t
        return out

    enc, device_merge, launches, results, main_row = phase(
        "main_path", phase_main_path, card)
    loop_rows, loop_err = phase("loop", phase_loop, device_merge, card)
    decode_launches, decode_rates = phase("decode", phase_decode, enc, results, card)
    long_launches, long_row = phase("long_pieces", phase_long_pieces, device_merge, card)
    native_launches, native_row = phase(
        "native_routing", phase_native_routing, enc, results, card)
    native_row["build_s"] = build_s["native"]
    sharded_launches, sharded_row = phase("sharded", phase_sharded, enc, results, card)
    cli_launches, cli_row = phase("cli", phase_cli, enc, card)
    entry_launches, dryrun_launches = phase("entry", phase_entry, card)
    bench_launches, bench_row = phase("bench", phase_bench, card)
    steady_launches, steady_replayed, steady_row = phase(
        "steady_state", phase_steady_state, device_merge, results, card)
    profile_launches, bench_row["count_plans"] = phase(
        "bench_profile", phase_bench_profile, card, args.profile)
    bench_launches += profile_launches
    if args.profile is not None:
        phase("profile", phase_profile, card, args.profile)
    log("seconds by phase: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))

    head = rows[1]  # max,max,add at n = 2^20: the largest scan of Stage A
    kernels = [{
        "name": "scan_leaves",
        "route": "cuda",
        "source": "jtokkit_tpu_torch/csrc/scan.cu",
        "replaces": REPLACES_SCAN,
        "launches": (launches + decode_launches + long_launches + native_launches
                     + sharded_launches + cli_launches + entry_launches
                     + dryrun_launches + bench_launches + steady_launches),
        "launches_by_path": {"encode_count": launches, "decode": decode_launches,
                             "long_pieces": long_launches,
                             "native_routing": native_launches,
                             "sharded": sharded_launches, "cli": cli_launches,
                             "entry": entry_launches,
                             "dryrun_multichip": dryrun_launches,
                             "bench": bench_launches,
                             "steady_state": steady_launches},
        # scans inside CUDA graph replays pass through no wrapper and are in
        # no launch count above: "recorded" sums what the replayed graphs
        # hold, "profiled" is the scan kernel launches counted in the device
        # traces of one replayed pass per plan (equal to that pass's recording)
        "replayed_in_graphs": steady_replayed,
        "max_abs_err": max_err,
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": "bytes",
        "library_ms": head["library_ms"],
        "shape": {"kinds": head["kinds"], "n": head["n"]},
        "shapes": rows,
    }, {
        "name": "take_table",
        "route": "cuda",
        "source": "jtokkit_tpu_torch/csrc/gather.cu",
        "replaces": REPLACES_GATHER,
        "launches": gather_launches,
        "max_abs_err": gather_row["max_abs_err"],
        "ms": gather_row["ms"],
        "plain_ms": gather_row["plain_ms"],
        "bound_ms": gather_row["bound_ms"],
        "bound_by": "bytes",
        "library_ms": gather_row["library_ms"],
        "shape": gather_row["shape"],
        "shapes": gather_row["shapes"],
        "limit_table_ms": gather_row["limit_table_ms"],
    }, {
        "name": "merge_t3",
        "route": "cuda",
        "source": "jtokkit_tpu_torch/csrc/merge.cu",
        # not a Pallas kernel: it replaces the merge rounds that the JAX
        # package runs in a lax.while_loop around merge_rows_t3
        "replaces": REPLACES_LOOP,
        "does": "every piece of a Stage B bucket merged to its end in one launch",
        # bucket merges of the main path's cached engine: its launches and the
        # launches its graph replays hold (engine.merge_kernel_runs)
        "launches": main_row["merge_kernel_runs"],
        "max_abs_err": loop_err,
        "ms": loop_rows[0]["ms"],
        "plain_ms": loop_rows[0]["plain_ms"],
        "bound_ms": loop_rows[0]["bound_ms"],
        "bound_by": "latency: the longest piece's chain of dependent lookups",
        "library_ms": None,
        "shape": {k: loop_rows[0][k] for k in ("flavor", "lanes", "cap", "count", "rounds")},
        "shapes": loop_rows,
    }]
    summary = {name: {**main_row["corpora"][name], "decode_mb_s": decode_rates[name]}
               for name in results}
    log(json.dumps({"main_path": summary, "main_path_breakdown_ms": main_row["breakdown_ms"],
                    "loop": loop_rows, "long_pieces": long_row,
                    "native_routing": native_row, "sharded": sharded_row,
                    "cli": cli_row, "bench": bench_row, "steady_state": steady_row,
                    "card": card,
                    "build_s": build_s, "phase_s": phase_s,
                    "seconds": time.time() - t_start}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
