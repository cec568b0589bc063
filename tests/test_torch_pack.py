"""The port's packed token fetch against the JAX engine's, byte for byte.

``_slice_tokens`` (2 bytes a token plus the 17th-bit plane) and
``_consume_fetch`` are held against the JAX engine's functions on the same
seeded ids, each side's packer is read by the other side's consumer, and the
format is checked over cold and warmed passes. The port's low halves are
int16 words with the bit pattern of the reference's uint16. The reference's
12-bit plane has no counterpart in the engine: the port fetches the low
halves in every pass, and keeps the 12-bit pack in
``jtokkit_tpu_torch/scripts/fetch_formats.py``, which times it on the card;
it is held against the JAX engine's here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jtokkit_tpu_torch.scripts import fetch_formats

from .test_torch_engine import engines
from .test_torch_steady import common_words

# The suite runs in several worker processes at once; torch's own thread
# pool in each of them would oversubscribe the cores.
torch.set_num_threads(1)


def _ids(seed: int, n: int, n_vocab: int, pad: int) -> np.ndarray:
    """``n`` ids in a zero buffer of ``pad``: half below 4094, the codes
    around the escape mark, and ids over 16 bits where the vocabulary has
    them."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, n_vocab, size=n).astype(np.int32)
    ids[: n // 2] = rng.randint(0, 4094, size=n // 2)
    ids[10:14] = (4094, 4093, min(99999, n_vocab - 1), 4095)
    buf = np.zeros(pad, np.int32)
    buf[:n] = ids
    return buf


def _np(x):
    return None if x is None else (
        x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    )


def _same_bytes(got, want, what):
    """Equal as raw bytes (int16 against uint16 words), or both absent."""
    got, want = _np(got), _np(want)
    assert (got is None) == (want is None), what
    if got is not None:
        assert got.nbytes == want.nbytes, what
        np.testing.assert_array_equal(
            got.reshape(-1).view(np.uint8), want.reshape(-1).view(np.uint8), err_msg=what
        )


@pytest.mark.parametrize("name", ["cl100k_base", "r50k_base"])
def test_slice_tokens_matches_jax(name):
    """cl100k ids need the 17th-bit plane; r50k ids fit 16 bits (hi is None)."""
    _orc, jax_eng, port = engines(name)
    n, pad = 5000, 8192
    buf = _ids(3, n, port.packed.n_tokens, 1 << 14)
    lo_j, hi_j = jax_eng._slice_tokens(pad)(jnp.asarray(buf))
    lo, hi = port._slice_tokens(torch.from_numpy(buf), pad)
    assert (hi is None) == (name == "r50k_base")
    _same_bytes(lo, lo_j, "lo")
    _same_bytes(hi, hi_j, "hi")
    for fetch in ((lo, hi), (_np(lo_j), _np(hi_j))):
        np.testing.assert_array_equal(port._consume_fetch(fetch, n), buf[:n])
    np.testing.assert_array_equal(jax_eng._consume_fetch((_np(lo).view(np.uint16), _np(hi)), n), buf[:n])
    assert port._consume_fetch((None, None), 0).shape == (0,)


@pytest.mark.parametrize("name,ecap", [
    ("cl100k_base", 4096), ("cl100k_base", 0), ("r50k_base", 4096),
])
def test_pack12_matches_jax(name, ecap):
    """The 12-bit plane that ``scripts/fetch_formats.py`` times against the
    port's format: plane, lo and hi byte for byte with the JAX engine's;
    each side's unpack reads both packers."""
    _orc, jax_eng, port = engines(name)
    n, pad = 5000, 8192
    buf = _ids(5, n, port.packed.n_tokens, 1 << 14)
    if ecap == 0:
        buf = np.minimum(buf, 4093)  # a chunk without escapes ships no side stream
    ec = int((buf[:n] >= 4094).sum())
    assert ec <= ecap
    want = jax_eng._pack12(pad, ecap)(jnp.asarray(buf))
    got = fetch_formats.pack12(port, torch.from_numpy(buf), pad, ecap)
    for g, w, what in zip(got, want, ("plane", "lo", "hi")):
        _same_bytes(g, w, what)
    assert got[0].dtype == torch.uint8 and got[0].shape == (pad * 3 // 2,)
    out = fetch_formats.unpack12(*got, n, ec)
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, buf[:n])
    np.testing.assert_array_equal(fetch_formats.unpack12(*map(_np, want), n, ec), buf[:n])
    lo16 = None if got[1] is None else _np(got[1]).view(np.uint16)
    np.testing.assert_array_equal(
        jax_eng._consume_fetch(("p12", pad, ec, _np(got[0]), lo16, _np(got[2])), n),
        buf[:n],
    )


def test_consume_fetch_escape_roundtrip():
    """The 12-bit pack and unpack pair on a synthetic id mix (escape
    capacity from the escape count, as the reference sizes it)."""
    _orc, _jax, port = engines("cl100k_base")
    n, pad = 5000, 8192
    buf = _ids(3, n, 100256, pad)
    ec = int((buf >= 4094).sum())
    ecap = 1 << (max(ec, 1024) - 1).bit_length()
    got = fetch_formats.pack12(port, torch.from_numpy(buf), pad, ecap)
    assert fetch_formats.unpack12(*got, n, ec).tolist() == buf[:n].tolist()


def test_fetch_formats_needs_a_card():
    """The format study measures on a card only: a CPU plan raises."""
    _orc, _jax, port = engines("cl100k_base")
    plan = port.preload_corpus([common_words(4, 200)])
    for _ in range(3):
        port.encode_ordinary_batch_arrays(None, plan=plan)
    with pytest.raises(RuntimeError, match="needs a plan with encode graphs on a card"):
        fetch_formats.measure(port, plan)


def test_pack12_steady_state_parity(monkeypatch):
    """Cold, first warmed and second warmed encode pass equal the oracle and
    the JAX engine. Every pass fetches every chunk as low halves: the port
    has no 12-bit plane (on the card its pack and unpack cost more than the
    bytes it saves), where the JAX engine takes it for the low-escape chunk
    and declines it for the escape-dense one."""
    orc, jax_eng, port = engines("cl100k_base")
    docs = [
        common_words(7, 30_000),  # ids below 4094: the reference's 12-bit case
        # escape-dense: rare words, unicode, digits (ids >= 4094 and >= 2^16)
        "Zyzzyva quixotic 😀 unfathomable „curly” 98765 " * 2200,
        "",
        "short tail",
    ]
    expect = [orc.encode_ordinary(t)[0] for t in docs]
    calls = []

    def spy(tokens, pad, _real=port._slice_tokens):
        calls.append(pad)
        return _real(tokens, pad)

    monkeypatch.setattr(port, "_slice_tokens", spy)
    plan = port.preload_corpus(docs)
    assert len(plan) >= 2, "the two long documents make a chunk each"
    for k in range(3):
        del calls[:]
        ak = port.encode_ordinary_batch_arrays(docs if k == 0 else None, plan=plan)
        assert len(calls) == len(plan), f"pass {k}: {calls}"
        for i, exp in enumerate(expect):
            assert ak[i].tolist() == exp, f"pass {k} doc {i}"

    jax_plan = jax_eng.preload_corpus(docs)
    for _ in range(2):
        want = jax_eng.encode_ordinary_batch_arrays(docs, plan=jax_plan)
        assert [w.tolist() for w in want] == expect
    assert jax_plan.n_tokens == plan.n_tokens
    esc, n_tok = jax_plan.esc_counts, jax_plan.n_tokens
    assert esc[0] * 20 < n_tok[0] and esc[1] * 3 > n_tok[1]
