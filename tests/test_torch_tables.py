"""The port's vocabulary tables and hashes against the JAX package's.

The port keeps its own copy of the packed-table builder and of the uint32
hashes (computed in int64 with a 32-bit mask); a wrong word hash would be
silent end to end, so the bits are held here directly.
"""

import numpy as np
import pytest
import torch

from jtokkit_tpu.engine.device import DeviceEngine as JaxEngine
from jtokkit_tpu.engine.oracle import OracleEngine as JaxOracle
from jtokkit_tpu.vocab import tables as jax_tables
from jtokkit_tpu.vocab.definitions import BUILTIN_DEFINITIONS
from jtokkit_tpu.vocab.loader import load_builtin_ranks
from jtokkit_tpu_torch.engine.tables import ARRAY_NAMES, DeviceTables
from jtokkit_tpu_torch.ops import merge, stage4
from jtokkit_tpu_torch.vocab import loader as port_loader
from jtokkit_tpu_torch.vocab import tables as port_tables

# The suite runs in several worker processes at once; torch's own thread
# pool in each of them would oversubscribe the cores.
torch.set_num_threads(1)


def _jax_engine(name):
    d = BUILTIN_DEFINITIONS[name]
    orc = JaxOracle(
        d.name, d.pattern, load_builtin_ranks(d.vocab_name), d.special_tokens
    )
    return JaxEngine.from_oracle(orc)


def _jax_arrays(eng):
    return {k: np.asarray(getattr(eng, "_" + k)) for k in ARRAY_NAMES}


@pytest.mark.parametrize("name", ["cl100k_base", "r50k_base"])
def test_device_tables_match_jax_engine(name):
    ranks = port_loader.load_builtin_ranks(name)
    packed = port_tables.load_packed(name, ranks, port_loader.asset_path(name))
    port = DeviceTables.from_packed(packed, "cpu")
    eng = _jax_engine(name)
    ref = DeviceTables.from_numpy(_jax_arrays(eng), "cpu")
    assert port.table_mask == ref.table_mask == eng.packed.table_mask
    assert port.word_mask == ref.word_mask == eng.packed.word_mask
    for k in ARRAY_NAMES:
        if k == "word_rows_cat":
            continue
        assert torch.equal(getattr(port, k), getattr(ref, k)), k
    for half_p, half_r, half_j in zip(port.word_rows, ref.word_rows,
                                      eng._word_rows_halves):
        assert torch.equal(half_p, half_r)
        np.testing.assert_array_equal(half_p.numpy(), np.asarray(half_j))


def test_loader_reads_the_shared_assets():
    assert port_loader.load_builtin_ranks("p50k_edit") == load_builtin_ranks(
        "p50k_edit"
    )


def _u32_samples(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    edge = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0xDEADBEEF],
                    dtype=np.uint32)
    x = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([edge, x])


@pytest.mark.parametrize("mask", [(1 << 17) - 1, (1 << 20) - 1, 0xFFFFFFFF])
def test_mix_matches_host_hash_bit_for_bit(mask):
    u = _u32_samples(seed=1)
    v = _u32_samples(seed=2)
    tu = torch.from_numpy(u.view(np.int32))
    tv = torch.from_numpy(v.view(np.int32))
    for consts, host in ((stage4._H1, jax_tables.pair_hash1),
                         (stage4._H2, jax_tables.pair_hash2)):
        got = stage4._mix(tu, tv, consts, mask).numpy()
        want = host(u.view(np.int32), v.view(np.int32), mask)
        np.testing.assert_array_equal(got, want)
    assert merge._H1 == stage4._H1 and merge._H2 == stage4._H2


def test_word_key_halves_match_host():
    """The stage-A probe hash folds (w0..w3, len) exactly like
    ``vocab.tables.word_key``."""
    w = [_u32_samples(seed=s).view(np.int32) for s in (3, 4, 5, 6)]
    lens = np.random.default_rng(7).integers(1, 17, w[0].shape[0]).astype(np.int32)
    hu_want, hv_want = jax_tables.word_key(*w, lens)
    t = [torch.from_numpy(x) for x in w]
    tl = torch.from_numpy(lens)
    u32 = stage4._u32
    hu = u32(t[0]) ^ ((u32(t[2]) * stage4._W2_MIX) & stage4._M32)
    hv = (u32(t[1]) ^ ((u32(tl) * stage4._LEN_MIX) & stage4._M32)
          ^ ((u32(t[3]) * stage4._W3_MIX) & stage4._M32))
    np.testing.assert_array_equal(hu.numpy(), hu_want.astype(np.int64))
    np.testing.assert_array_equal(hv.numpy(), hv_want.astype(np.int64))
    i32 = stage4._i32(hu).numpy()
    np.testing.assert_array_equal(i32, hu_want.view(np.int32))
