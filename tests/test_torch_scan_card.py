"""The CUDA kernels (prefix scan, table gather) against their plain PyTorch
versions, on the card. Values are int32: tolerance 0.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_scan_card.py

Without a CUDA card its tests skip.
"""

import pytest
import torch

from jtokkit_tpu_torch.ops import gather, scan


def _leaves(kinds, n, gen):
    idx = torch.arange(n, dtype=torch.int32, device="cuda")
    out = []
    for k in kinds:
        if k == "add":
            out.append(torch.randint(-5, 6, (n,), generator=gen, device="cuda",
                                     dtype=torch.int32))
        else:
            keep = torch.rand(n, generator=gen, device="cuda") < 0.05
            out.append(torch.where(keep, idx % 1000, -1))
    return out


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an H100")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    launches = scan.KERNEL_LAUNCHES
    calls = 0
    for n in (1, 2, 127, 129, 4095, 4096, 4097, 1 << 15, 1 << 20, 3 * 4096 * 1024 + 5):
        for reverse in (False, True):
            for kinds in (("max", "last", "add"), ("last",) * 4, ("add", "max")):
                leaves = _leaves(kinds, n, gen)
                got = scan.scan_leaves(leaves, kinds, reverse=reverse)
                want = scan.scan_leaves_plain(leaves, kinds, reverse=reverse)
                calls += 1
                torch.cuda.synchronize()
                for k, g, w in zip(kinds, got, want):
                    assert torch.equal(g, w), (n, reverse, kinds, k)
    assert scan.KERNEL_LAUNCHES - launches == calls
    empty = torch.empty(0, dtype=torch.int32, device="cuda")
    assert scan.scan_leaves([empty], ["max"])[0].shape == (0,)


@pytest.mark.gpu
def test_kernel_matches_plain_at_the_decode_shapes():
    """Decode scans one ``max`` leaf of the output capacity: -1, or a token
    ordinal at the token's first byte."""
    if not torch.cuda.is_available():
        pytest.skip("needs an H100")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    launches = scan.KERNEL_LAUNCHES
    shapes = (1 << 13, 1 << 20, 1 << 24)
    for n in shapes:
        starts = torch.rand(n, generator=gen, device="cuda") < 0.25
        ordinal = torch.cumsum(starts, 0, dtype=torch.int32) - 1
        marks = torch.where(starts, ordinal, -1)
        (got,) = scan.scan_leaves([marks], ["max"])
        (want,) = scan.scan_leaves_plain([marks], ["max"])
        assert torch.equal(got, want), n
    assert scan.KERNEL_LAUNCHES - launches == len(shapes)


def _same(got, want):
    return all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.gpu
def test_repeated_calls_on_one_scratch():
    """The scratch is persistent: a call must not see the status words of
    the one before, whether that had as many tiles, more or fewer."""
    if not torch.cuda.is_available():
        pytest.skip("needs an H100")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    cases = []
    for kinds, n, reverse in ((("max", "max", "add"), 1 << 20, False),
                              (("last",) * 4, (1 << 22) + 5, True),
                              (("add",), 5000, False)):
        leaves = _leaves(kinds, n, gen)
        cases.append((leaves, kinds, reverse,
                      scan.scan_leaves_plain(leaves, kinds, reverse=reverse)))
    first = cases[0]
    scan.scan_leaves(first[0], first[1])
    key = (torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream)
    words = scan.SCRATCH[key].words
    ok = torch.ones((), dtype=torch.bool, device="cuda")
    for _ in range(1000):  # back to back, no synchronise
        got = scan.scan_leaves(first[0], first[1])
        ok &= torch.stack([(g == w).all() for g, w in zip(got, first[3])]).all()
    assert bool(ok)
    for leaves, kinds, reverse, want in cases[1:] + cases:
        assert _same(scan.scan_leaves(leaves, kinds, reverse=reverse), want)
    assert scan.SCRATCH[key].words is words  # never allocated anew


@pytest.mark.gpu
def test_two_streams_at_once():
    if not torch.cuda.is_available():
        pytest.skip("needs an H100")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    cases = []
    for kinds, n, reverse in ((("max", "last", "add"), (1 << 22) + 3, False),
                              (("last", "add"), (1 << 21) + 1, True)):
        leaves = _leaves(kinds, n, gen)
        cases.append((leaves, kinds, reverse,
                      scan.scan_leaves_plain(leaves, kinds, reverse=reverse)))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    results = []
    for _ in range(20):
        for st, (leaves, kinds, reverse, want) in zip(streams, cases):
            with torch.cuda.stream(st):
                results.append((scan.scan_leaves(leaves, kinds, reverse=reverse), want))
    torch.cuda.synchronize()
    assert all(_same(got, want) for got, want in results)
    dev = torch.cuda.current_device()
    a, b = (scan.SCRATCH[(dev, st.cuda_stream)].words for st in streams)
    assert a.data_ptr() != b.data_ptr()


@pytest.mark.gpu
def test_more_tiles_than_resident_blocks():
    """n = 2^24 at four leaves is 8,192 tiles for a card that holds a few
    hundred blocks: the look-back must make progress in both directions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an H100")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    kinds = ("max", "last", "add", "last")
    leaves = _leaves(kinds, 1 << 24, gen)
    for reverse in (False, True):
        got = scan.scan_leaves(leaves, kinds, reverse=reverse)
        assert _same(got, scan.scan_leaves_plain(leaves, kinds, reverse=reverse))
    # and leaves that are views at an odd offset (4-byte loads)
    views = [x[1:] for x in leaves]
    assert all(v.data_ptr() % 16 for v in views)
    for reverse in (False, True):
        got = scan.scan_leaves(views, kinds, reverse=reverse)
        assert _same(got, scan.scan_leaves_plain(views, kinds, reverse=reverse))


@pytest.mark.gpu
def test_scan_under_graph_capture():
    """A recorded scan needs its stream's scratch made beforehand; replays
    give the plain version's result every time, also across the clear of the
    status words, and count through ``count_replay`` as replayed scans, not
    as launches of the wrapper."""
    if not torch.cuda.is_available():
        pytest.skip("needs an H100")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    kinds = ("max", "last", "add")
    leaves = _leaves(kinds, (1 << 20) + 3, gen)
    want = scan.scan_leaves_plain(leaves, kinds, reverse=True)
    stream = torch.cuda.Stream()
    key = (torch.cuda.current_device(), stream.cuda_stream)
    assert key not in scan.SCRATCH
    torch.cuda.synchronize()

    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="scratch"):
        with torch.cuda.graph(graph, stream=stream):
            scan.scan_leaves(leaves, kinds, reverse=True)

    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        scan.scan_leaves(leaves, kinds, reverse=True)  # makes the scratch
    stream.synchronize()
    launches, captured = scan.KERNEL_LAUNCHES, scan.CAPTURED_CALLS
    replayed = scan.REPLAYED_SCANS
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        got = scan.scan_leaves(leaves, kinds, reverse=True)
        got2 = scan.scan_leaves(got, kinds)
    assert scan.CAPTURED_CALLS - captured == 2
    assert scan.KERNEL_LAUNCHES == launches, "a recorded call counted as a launch"
    want2 = scan.scan_leaves_plain(want, kinds)
    entry = scan.SCRATCH[key]
    for k in range(6):
        if k == 3:
            entry.calls = scan.CLEAR_EVERY - 1  # the clear falls due
        for g in got + got2:
            g.fill_(-7)
        scan.count_replay(torch.device("cuda"), stream.cuda_stream, 2)
        graph.replay()
        torch.cuda.synchronize()
        assert _same(got, want) and _same(got2, want2), k
    assert scan.REPLAYED_SCANS - replayed == 12
    assert scan.KERNEL_LAUNCHES == launches
    assert entry.calls == 6  # cleared before the fourth replay


@pytest.mark.gpu
def test_gather_many_lookups_and_large_blocks():
    """2^24 lookups (every resident block makes several trips), and tables
    long enough for blocks of 512 and 1,024 threads, by the bulk copy and by
    plain loads."""
    if not torch.cuda.is_available():
        pytest.skip("needs an H100")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                             dtype=torch.int32)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    seen = set()
    for size in (2048, 14000, 28000, gather.MAX_BULK_TABLE, gather.MAX_TABLE):
        table = ints(-1000, 1000, (size,))
        for n in (1 << 24, 4096 * 128, 4):
            plan = gather.launch_plan(size, n, sms)
            seen.add((plan.threads, plan.bulk_bytes > 0))
            idx = ints(-5, size + 5, (n,))
            assert torch.equal(gather.take_table(table, idx),
                               gather.take_table_plain(table, idx)), (size, n)
        # a table at an odd offset goes by plain loads
        odd = ints(-1000, 1000, (size + 1,))[1:]
        idx = ints(0, size, (100_003,))
        assert torch.equal(gather.take_table(odd, idx), gather.take_table_plain(odd, idx))
    assert seen == {(256, True), (512, True), (1024, True), (1024, False)}


@pytest.mark.gpu
def test_gather_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an H100")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                             dtype=torch.int32)

    launches = gather.KERNEL_LAUNCHES
    calls = 0
    for size in (1, 256, 2048, gather.MAX_TABLE):
        table = ints(-1000, 1000, (size,))
        for shape in ((4096, 128), (1,), (127,), (1_000_003,), (3, 5, 11)):
            # indices past both ends of the table clamp into it
            for lo, hi in ((0, size), (-2 * size - 3, 3 * size + 3)):
                idx = ints(lo, hi, shape)
                got = gather.take_table(table, idx)
                calls += 1
                assert got.shape == idx.shape and got.dtype == torch.int32
                assert torch.equal(got, gather.take_table_plain(table, idx)), (
                    size, shape, lo)
    assert gather.KERNEL_LAUNCHES - launches == calls
    assert gather.take_table(table, ints(0, 9, (0, 128))).shape == (0, 128)
    assert gather.KERNEL_LAUNCHES - launches == calls  # nothing to launch
    with pytest.raises(ValueError):
        gather.take_table(ints(0, 9, (gather.MAX_TABLE + 1,)), ints(0, 9, (4,)))
