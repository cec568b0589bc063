"""The port's multi-leaf scan against the JAX package's.

On the CPU ``jtokkit_tpu_torch.ops.scan.scan_leaves`` takes its plain
PyTorch version; it is held exactly (int32) against the Pallas kernel run in
interpret mode and against ``jax.lax.associative_scan``. The CUDA kernel is
held against the plain version on the card in ``test_torch_scan_card.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jtokkit_tpu.ops import pallas_scan
from jtokkit_tpu_torch.ops import scan

# The suite runs in several worker processes at once; torch's own thread
# pool in each of them would oversubscribe the cores.
torch.set_num_threads(1)


def _leaves(n, seed):
    """Boundary-scan-like leaves: sparse set positions (else -1) and a
    dense 0/1 add leaf."""
    rng = np.random.default_rng(seed)
    idx = np.arange(n, dtype=np.int32)
    return [
        np.where(rng.random(n) < 0.1, idx * 2 + (idx % 2), -1).astype(np.int32),
        np.where(rng.random(n) < 0.01, rng.integers(0, 7, n), -1).astype(np.int32),
        rng.integers(0, 2, n).astype(np.int32),
    ]


def _associative(leaves, kinds, reverse):
    def comb(a, b):
        return tuple(
            pallas_scan._combine(k, x, y) for k, x, y in zip(kinds, a, b)
        )

    out = jax.lax.associative_scan(
        comb, tuple(jnp.asarray(x) for x in leaves), reverse=reverse
    )
    return [np.asarray(x) for x in out]


def _port(leaves, kinds, reverse):
    out = scan.scan_leaves(
        [torch.from_numpy(x) for x in leaves], kinds, reverse=reverse
    )
    return [x.numpy() for x in out]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", [1024, 32768, 131072])
def test_scan_matches_pallas_interpret(n, reverse):
    leaves = _leaves(n, n + reverse)
    kinds = ["max", "last", "add"]
    want = pallas_scan.scan_leaves(
        [jnp.asarray(x) for x in leaves], kinds,
        reverse=reverse, enabled=True, interpret=True,
    )
    for k, g, w in zip(kinds, _port(leaves, kinds, reverse), want):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=k)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", [1, 2, 127, 129, 1000, 4097])
def test_scan_ragged_matches_associative_scan(n, reverse):
    leaves = _leaves(n, 7 * n + reverse)
    for kinds in (["max", "last", "add"], ["last", "max", "max"],
                  ["add", "add", "last"]):
        want = _associative(leaves, kinds, reverse)
        for k, g, w in zip(kinds, _port(leaves, kinds, reverse), want):
            np.testing.assert_array_equal(g, w, err_msg=f"{kinds} {k}")


def test_scan_four_leaves_and_counters():
    leaves = _leaves(5000, 3) + [np.full(5000, -1, np.int32)]
    kinds = ["max", "last", "add", "last"]
    launches, plain = scan.KERNEL_LAUNCHES, scan.PLAIN_CALLS
    got = _port(leaves, kinds, True)
    want = _associative(leaves, kinds, True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert scan.PLAIN_CALLS == plain + 1
    assert scan.KERNEL_LAUNCHES == launches


@pytest.mark.parametrize("leaves,kinds,err", [
    ([torch.zeros(8, dtype=torch.int64)], ["max"], TypeError),
    ([torch.zeros(8, dtype=torch.int32)] * 5, ["max"] * 5, ValueError),
    ([torch.zeros(8, dtype=torch.int32)], ["min"], ValueError),
    ([torch.zeros(8, dtype=torch.int32), torch.zeros(9, dtype=torch.int32)],
     ["max", "max"], TypeError),
])
def test_scan_rejects_what_the_kernel_does_not_take(leaves, kinds, err):
    with pytest.raises(err):
        scan.scan_leaves(leaves, kinds)


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        scan.scan_leaves_cuda([torch.zeros(8, dtype=torch.int32)], ["max"])

