"""Batch decode of the port against the JAX package's, exactly.

``decode_tokens`` is held against ``jtokkit_tpu.ops.decode.decode_tokens`` on
the same numpy inputs (its scan runs as the JAX package's tests run it on the
CPU, and once more through the Pallas kernel in interpret mode); the engine's
three decode methods against the JAX engine's and against the source texts.
Outputs are bytes and int32 counts: tolerance 0.

The scan leaf of decode holds -1 or a token ordinal, never a value below -1,
so the CUDA kernel's INT32_MIN identity for ``max`` (the Pallas kernel uses
-1) changes nothing on this path; ``test_decode_marks_stay_above_the_identity``
pins that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jtokkit_tpu.ops import decode as jax_decode
from jtokkit_tpu_torch import Encodings, EncodingType, UnknownTokenError
from jtokkit_tpu_torch.ops import decode, scan

from .test_torch_engine import engines

# The suite runs in several worker processes at once; torch's own thread
# pool in each of them would oversubscribe the cores.
torch.set_num_threads(1)

TEXTS = ["Hello, world!", "日本語🙂テスト", "", "I'm 42.", "  spaces  "]


def _tables(name="cl100k_base"):
    packed = engines(name)[2].packed
    return packed.token_offsets, packed.token_bytes, packed.n_tokens


def _tokens(T, n_live, V, seed):
    """Ids with padding (-1), ids at and past V, and a run of repeats."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, V, T, dtype=np.int32)
    toks[rng.random(T) < 0.05] = -1
    toks[rng.random(T) < 0.05] = V
    toks[rng.random(T) < 0.02] = V + 12345
    toks[n_live:] = -1
    return toks


def _both(tokens, n_tokens, cap, name="cl100k_base"):
    offsets, pool, _V = _tables(name)
    want, want_n = jax_decode.decode_tokens(
        jnp.asarray(tokens), n_tokens, jnp.asarray(offsets), jnp.asarray(pool), cap
    )
    got, got_n = decode.decode_tokens(
        torch.from_numpy(tokens), n_tokens, torch.from_numpy(offsets),
        torch.from_numpy(pool), cap,
    )
    assert got.dtype == torch.uint8 and tuple(got.shape) == (cap,)
    return got.numpy(), int(got_n), np.asarray(want), int(want_n)


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("T,n_live,cap", [
    (1024, 1024, 8192), (1024, 700, 8192), (1024, 0, 8192), (1024, 1, 8192),
    (1024, 1024, 1024),  # capacity below the byte count: the tail is dropped
])
def test_decode_tokens_matches_jax(T, n_live, cap, pallas, monkeypatch):
    if pallas:
        monkeypatch.setenv("JTOKKIT_PALLAS_SCAN", "1")  # Pallas, interpret mode
    V = _tables()[2]
    tokens = _tokens(T, n_live, V, seed=T + n_live + cap)
    plain = scan.PLAIN_CALLS
    got, got_n, want, want_n = _both(tokens, n_live, cap)
    assert scan.PLAIN_CALLS == plain + 1  # one scan, one leaf
    assert got_n == want_n
    np.testing.assert_array_equal(got, want)
    if n_live and cap >= got_n:
        assert got_n > 0 and got[:got_n].any()


def test_decode_tokens_zero_length_spans_and_oracle_bytes():
    """Valid ids interleaved with zero-length ones decode to the valid ids'
    bytes in order."""
    orc, _jax, port = engines("cl100k_base")
    V = port.packed.n_tokens
    ids = orc.encode_ordinary("zero-length spans — 中文 between")[0]
    tokens = np.full(1024, -1, np.int32)
    mixed = []
    for t in ids:
        mixed += [t, V, -1, V + 7]
    tokens[: len(mixed)] = mixed
    got, got_n, want, want_n = _both(tokens, len(mixed), 8192)
    np.testing.assert_array_equal(got, want)
    assert got_n == want_n
    assert got[:got_n].tobytes() == orc.decode_bytes(ids)
    assert not got[got_n:].any()


def test_decode_tokens_with_no_tokens():
    offsets, pool, _V = _tables()
    out, n = decode.decode_tokens(
        torch.zeros(0, dtype=torch.int32), 0, torch.from_numpy(offsets),
        torch.from_numpy(pool), 64,
    )
    assert int(n) == 0 and tuple(out.shape) == (64,) and not out.any()


def test_decode_marks_stay_above_the_identity(monkeypatch):
    seen = []
    real = scan.scan_leaves

    def spy(leaves, kinds, **kw):
        seen.append((int(leaves[0].min()), list(kinds), len(leaves)))
        return real(leaves, kinds, **kw)

    monkeypatch.setattr(scan, "scan_leaves", spy)
    V = _tables()[2]
    _both(_tokens(1024, 900, V, seed=3), 900, 8192)
    assert seen == [(-1, ["max"], 1)]


def _token_lists(orc):
    return [orc.encode_ordinary(t)[0] for t in TEXTS]


@pytest.mark.parametrize("method", [
    "decode_bytes_batch", "decode_bytes_batch_device", "decode_bytes_batch_host",
])
def test_engine_decode_matches_jax_engine(enc_name, method):
    orc, jax_eng, port = engines(enc_name)
    lists = _token_lists(orc)
    lists += [np.asarray(lists[1], dtype=np.int32), [], tuple(lists[0])]
    want_bytes = [orc.decode_bytes(list(t)) for t in lists]
    launches = scan.KERNEL_LAUNCHES
    got = getattr(port, method)(lists)
    assert got == getattr(jax_eng, method)(lists)
    assert got == want_bytes
    assert scan.KERNEL_LAUNCHES == launches
    assert getattr(port, method)([]) == []
    assert getattr(port, method)([[], []]) == [b"", b""]


def test_engine_decode_scans_once_per_call_on_its_device():
    orc, _jax, port = engines("cl100k_base")
    lists = _token_lists(orc)
    plain = scan.PLAIN_CALLS
    port.decode_bytes_batch(lists)
    assert scan.PLAIN_CALLS == plain + 1
    port.decode_bytes_batch_host(lists)
    assert scan.PLAIN_CALLS == plain + 1


@pytest.mark.parametrize("method", [
    "decode_bytes_batch", "decode_bytes_batch_device", "decode_bytes_batch_host",
])
def test_engine_decode_special_and_unknown_ids(method):
    """A list with a special id decodes through the oracle; an id the
    vocabulary does not know raises as the oracle does."""
    orc, jax_eng, port = engines("cl100k_base")
    lists = [[100257], [9906], [9906, 100257, 9906]]
    got = getattr(port, method)(lists)
    assert got == [b"<|endoftext|>", b"Hello", b"Hello<|endoftext|>Hello"]
    assert got == getattr(jax_eng, method)(lists)
    for bad in ([[99_999_999]], [[9906], [-5]]):
        with pytest.raises(UnknownTokenError):
            getattr(port, method)(bad)


def test_engine_decode_larger_batch_round_trips():
    """A few thousand tokens over several documents, past the 1024-token and
    8192-byte floors."""
    from jtokkit_tpu_torch.utils import corpus

    orc, jax_eng, port = engines("cl100k_base")
    docs = corpus.generate(0.03, seed=5, flavor="mixed")
    lists = port.encode_ordinary_batch(docs)
    assert sum(len(t) for t in lists) > 4096
    got = port.decode_bytes_batch(lists)
    assert got == [d.encode("utf-8") for d in docs]
    assert got == port.decode_bytes_batch_host(lists)
    assert got == jax_eng.decode_bytes_batch_device(lists)


def test_decode_batch_through_the_facade():
    reg = Encodings.new_lazy_encoding_registry(device="cpu")
    enc = reg.get_encoding(EncodingType.CL100K_BASE)
    toks = [enc.encode(t) for t in TEXTS]
    plain = scan.PLAIN_CALLS
    assert enc.decode_batch(toks) == TEXTS
    assert scan.PLAIN_CALLS == plain + 1  # the engine decoded, not the oracle
    assert enc.decode_bytes_batch(toks) == [t.encode("utf-8") for t in TEXTS]
    assert enc.decode_batch([[100257], [9906]]) == ["<|endoftext|>", "Hello"]
    with pytest.raises(UnknownTokenError):
        enc.decode_batch([[99_999_999]])


def test_decode_timing_script_raises_without_a_card(monkeypatch):
    """``scripts/time_decode.py`` times the card's decode and nothing else."""
    import os

    from jtokkit_tpu_torch.scripts import time_decode

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.path", list(__import__("sys").path))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with pytest.raises(RuntimeError, match="CUDA"):
        time_decode.main(root, mb=0.01, repeats=1)
