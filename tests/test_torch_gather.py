"""The port's table lookup against the JAX package's, exactly.

The TPU kernel (``pal`` in ``scripts/profile_gather.py``) is a closure inside
that script's ``main()`` and cannot be imported without running the TPU
sweep; its body is ``jnp.take(tbl, idx)``, which is the reference here. On
the CPU ``take_table`` takes its plain PyTorch version. Values are int32 and
compared with tolerance 0. The CUDA kernel is held against the plain version
on the card in ``test_torch_scan_card.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jtokkit_tpu_torch.ops import gather
from jtokkit_tpu_torch.scripts import profile_gather

# The suite runs in several worker processes at once; torch's own thread
# pool in each of them would oversubscribe the cores.
torch.set_num_threads(1)


def _case(table_len, shape, seed, lo=0, hi=None):
    rng = np.random.default_rng(seed)
    tbl = rng.integers(-1000, 1000, table_len, dtype=np.int32)
    idx = rng.integers(lo, table_len if hi is None else hi, shape, dtype=np.int32)
    return tbl, idx


@pytest.mark.parametrize("table_len,shape", [
    (2048, (32, 128)),   # the profiled case, fewer rows
    (256, (32, 128)),
    (1, (5, 7)),
    (2048, (1000,)),
    (256, (3, 5, 11)),
    (2048, (0,)),
    (256, (0, 128)),
])
def test_take_table_matches_jnp_take(table_len, shape):
    tbl, idx = _case(table_len, shape, seed=table_len + len(shape))
    plain = gather.PLAIN_CALLS
    got = gather.take_table(torch.from_numpy(tbl), torch.from_numpy(idx))
    want = np.asarray(jnp.take(jnp.asarray(tbl), jnp.asarray(idx), axis=0))
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert gather.PLAIN_CALLS == plain + 1


@pytest.mark.parametrize("table_len", [1, 256, 2048])
def test_out_of_range_indices_are_clamped(table_len):
    tbl, idx = _case(table_len, (64, 128), seed=5, lo=-3 * table_len - 5,
                     hi=4 * table_len + 5)
    idx[0, :4] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max, -1, table_len]
    got = gather.take_table(torch.from_numpy(tbl), torch.from_numpy(idx)).numpy()
    want = np.asarray(
        jnp.take(jnp.asarray(tbl), jnp.asarray(idx), axis=0, mode="clip")
    )
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tbl[np.clip(idx, 0, table_len - 1)])


def test_plain_and_wrapper_agree_and_launch_nothing_on_cpu():
    tbl, idx = _case(2048, (32, 128), seed=9)
    t, i = torch.from_numpy(tbl), torch.from_numpy(idx)
    launches = gather.KERNEL_LAUNCHES
    assert torch.equal(gather.take_table(t, i), gather.take_table_plain(t, i))
    assert gather.KERNEL_LAUNCHES == launches


@pytest.mark.parametrize("table,idx,err", [
    (torch.zeros(8, dtype=torch.int64), torch.zeros(4, dtype=torch.int32), TypeError),
    (torch.zeros(8, dtype=torch.int32), torch.zeros(4, dtype=torch.int64), TypeError),
    (torch.zeros((2, 4), dtype=torch.int32), torch.zeros(4, dtype=torch.int32), TypeError),
    (torch.zeros(0, dtype=torch.int32), torch.zeros(4, dtype=torch.int32), ValueError),
    (torch.zeros(gather.MAX_TABLE + 1, dtype=torch.int32),
     torch.zeros(4, dtype=torch.int32), ValueError),
])
def test_take_table_rejects_what_the_kernel_does_not_take(table, idx, err):
    with pytest.raises(err):
        gather.take_table(table, idx)
    with pytest.raises(err):
        gather.take_table_plain(table, idx)


def test_table_limit_is_one_blocks_shared_memory():
    assert gather.MAX_TABLE * 4 == 232448
    full = torch.arange(gather.MAX_TABLE, dtype=torch.int32)
    idx = torch.tensor([0, gather.MAX_TABLE - 1, gather.MAX_TABLE], dtype=torch.int32)
    assert gather.take_table(full, idx).tolist() == [
        0, gather.MAX_TABLE - 1, gather.MAX_TABLE - 1
    ]


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        gather.take_table_cuda(
            torch.zeros(8, dtype=torch.int32), torch.zeros(4, dtype=torch.int32)
        )


def test_profile_entry_point_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    launches = gather.KERNEL_LAUNCHES
    with pytest.raises(RuntimeError, match="CUDA"):
        profile_gather.main()
    assert gather.KERNEL_LAUNCHES == launches
