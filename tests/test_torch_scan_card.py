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
