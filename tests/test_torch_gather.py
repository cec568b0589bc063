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


# ---- the launch the CUDA wrapper plans in Python (no card, no launch) -----

H100_SMS = 132


def _source_constant(name):
    import os
    import re

    path = os.path.join(os.path.dirname(gather.__file__), "..", "csrc", "gather.cu")
    with open(path) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);", f.read()).group(1))


def test_python_constants_match_the_source():
    assert _source_constant("kMaxSharedBytes") == gather.BLOCK_SHARED_BYTES
    assert _source_constant("kBarrierBytes") == gather.BARRIER_BYTES
    assert _source_constant("kMaxThreads") == 1024
    assert gather.MAX_BULK_TABLE == gather.MAX_TABLE - 4
    assert 1 <= gather.GRID_VECS_PER_THREAD <= _source_constant("kVecsPerTrip")


@pytest.mark.parametrize("table_len,n,want", [
    # the profiled shape: every lookup in flight at once, two vectors a thread
    (2048, 4096 * 128, gather.LaunchPlan(256, 256, 8192, 131072)),
    # many lookups: as many blocks as the card holds at once (8 an SM)
    (2048, 1 << 24, gather.LaunchPlan(256, 8 * H100_SMS, 8192, 1 << 22)),
    # the launch floor
    (2048, 4, gather.LaunchPlan(256, 1, 8192, 1)),
    # a table too short for a 16-byte bulk copy
    (3, 1000, gather.LaunchPlan(256, 1, 0, 250)),
    # two blocks an SM: 1,024 threads each
    (28000, 1 << 24, gather.LaunchPlan(1024, 2 * H100_SMS, 112000, 1 << 22)),
    # the longest bulk copy, and the limit, which has no room for the barrier
    (gather.MAX_BULK_TABLE, 4096 * 128,
     gather.LaunchPlan(1024, 128, 4 * gather.MAX_BULK_TABLE & ~15, 131072)),
    (gather.MAX_TABLE, 4096 * 128, gather.LaunchPlan(1024, 128, 0, 131072)),
    (gather.MAX_TABLE, 1 << 24, gather.LaunchPlan(1024, H100_SMS, 0, 1 << 22)),
])
def test_launch_plan_by_table_size(table_len, n, want):
    assert gather.launch_plan(table_len, n, H100_SMS) == want


def test_launch_plan_for_unaligned_pointers():
    # a table at an odd offset: no bulk copy; indices or output at one: no vectors
    assert gather.launch_plan(2048, 1000, H100_SMS, table_aligned=False).bulk_bytes == 0
    plan = gather.launch_plan(2048, 1_000_003, H100_SMS, vectors=False)
    assert plan.n_vec == 0 and plan.bulk_bytes == 8192
    assert plan.blocks == 8 * H100_SMS


@pytest.mark.parametrize("table_len", [1, 4, 5, 255, 2048, 6999, 7000, 9000, 14000,
                                       19000, 28000, 40000, gather.MAX_BULK_TABLE,
                                       gather.MAX_BULK_TABLE + 1, gather.MAX_TABLE])
def test_launch_plan_fits_the_card(table_len):
    for n in (1, 4, 1000, 4096 * 128, 1 << 24):
        plan = gather.launch_plan(table_len, n, H100_SMS)
        shared = 4 * table_len
        if plan.bulk_bytes:
            shared = ((shared + 15) & ~15) + gather.BARRIER_BYTES
            assert plan.bulk_bytes % 16 == 0 and 4 * table_len - plan.bulk_bytes < 16
        assert shared <= gather.BLOCK_SHARED_BYTES
        assert plan.threads in (256, 512, 1024)
        resident = plan.blocks / H100_SMS  # blocks an SM if all run at once
        assert resident * plan.threads <= gather.SM_THREADS
        assert resident * (shared + gather.BLOCK_RESERVED_BYTES) <= gather.SM_SHARED_BYTES
        assert 1 <= plan.blocks and 4 * plan.n_vec <= n
        # no thread is planned more than one block's worth of idle blocks
        assert (plan.blocks - 1) * plan.threads < max(plan.n_vec, n)
