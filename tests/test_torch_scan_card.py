"""The CUDA scan kernel against its plain PyTorch version, on the card.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_scan_card.py

Without a CUDA card its test skips.
"""

import pytest
import torch

from jtokkit_tpu_torch.ops import scan


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
