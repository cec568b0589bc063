"""The port's native host engine and the device engine's long-piece routing,
against the JAX package's native engine and the host oracle, exactly.

Routed chunks skip the device merge, so the routing tests run on the CPU at
the test chunk size (``chunk_bytes=1<<17``); ``native_long=False`` keeps a
chunk of 90-byte CJK pieces on the device merge for comparison.
"""

import random

import numpy as np
import pytest
import torch

from jtokkit_tpu import native as jax_native
from jtokkit_tpu.engine.oracle import OracleEngine as JaxOracle
from jtokkit_tpu.vocab.definitions import BUILTIN_DEFINITIONS
from jtokkit_tpu.vocab.loader import load_builtin_ranks
from jtokkit_tpu.vocab.tables import load_packed as jax_load_packed
from jtokkit_tpu_torch import Encodings, GptBytePairEncodingParams, native
from jtokkit_tpu_torch.encoding_impl import GptBytePairEncoding
from jtokkit_tpu_torch.engine.device import DeviceEngine
from jtokkit_tpu_torch.engine.oracle import OracleEngine
from jtokkit_tpu_torch.vocab import loader as port_loader
from jtokkit_tpu_torch.vocab.tables import load_packed

from .conftest import load_conformance_rows

torch.set_num_threads(1)

_CACHE = {}

EDGE_CASES = [
    "", "a", "中文" * 300, "🙂" * 100, "   \t\n\r\n  x", "a" * 5000,
    "'s'T're 'ſ", "1234567890", "\x00\xff?",
]


def engines(name):
    """(JAX oracle, JAX native engine, port native engine, port oracle)."""
    if name not in _CACHE:
        d = BUILTIN_DEFINITIONS[name]
        ranks = load_builtin_ranks(d.vocab_name)
        orc = JaxOracle(d.name, d.pattern, ranks, d.special_tokens)
        jax_packed = jax_load_packed(
            d.vocab_name, ranks, port_loader.asset_path(d.vocab_name)
        )
        port_ranks = port_loader.load_builtin_ranks(d.vocab_name)
        packed = load_packed(
            d.vocab_name, port_ranks, port_loader.asset_path(d.vocab_name)
        )
        _CACHE[name] = (
            orc,
            jax_native.NativeEngine(jax_packed, d.pattern),
            native.NativeEngine(packed, d.pattern),
            OracleEngine(d.name, d.pattern, port_ranks, d.special_tokens),
        )
    return _CACHE[name]


def _fuzz(n):
    rng = random.Random(11)
    bits = ["ab", "'s", "'RE", "'ſ", "12", " ", "\t", "\n", "\r\n", "!", "—",
            "中", "🙂", "　", "\xa0", "$", "'"]
    return [
        "".join(rng.choice(bits) for _ in range(rng.randint(0, 16)))
        for _ in range(n)
    ]


@pytest.mark.parametrize("part", ["conformance", "edge", "fuzz"])
def test_native_matches_jax_native_and_oracle(enc_name, part):
    orc, jax_nat, nat, _port_orc = engines(enc_name)
    if part == "conformance":
        rows = load_conformance_rows(enc_name)
        texts = [t for t, _, _ in rows]
        for text, expected, _ in rows:
            assert nat.encode_ordinary(text) == expected, repr(text)
    else:
        texts = EDGE_CASES if part == "edge" else _fuzz(800)
    for text in texts:
        got = nat.encode_ordinary(text)
        assert got == jax_nat.encode_ordinary(text), repr(text)
        assert got == orc.encode_ordinary(text)[0], repr(text)
        assert np.array_equal(nat.split_ends(text), jax_nat.split_ends(text))


def test_native_capped_matches_oracle(enc_name):
    orc, jax_nat, nat, port_orc = engines(enc_name)
    for text, _expected, expected10 in load_conformance_rows(enc_name):
        for cap in (0, 1, 10):
            prefix = nat.encode_ordinary_capped_array(text, cap)
            assert np.array_equal(
                prefix, jax_nat.encode_ordinary_capped_array(text, cap)
            ), repr(text)
            tokens, truncated = port_orc._repair_truncation(text, prefix.tolist())
            assert (tokens, truncated) == orc.encode_ordinary(text, cap), repr(text)
            if cap == 10:
                assert tokens == expected10, repr(text)


def test_facade_single_text_uses_native(enc_name):
    enc = Encodings.new_lazy_encoding_registry(device="cpu").get_encoding(enc_name)
    assert isinstance(enc.native_engine(), native.NativeEngine)
    for text, expected, expected10 in load_conformance_rows(enc_name):
        assert enc.encode_ordinary(text) == expected, repr(text)
        assert enc.encode(text) == expected, repr(text)
        assert enc.encode_capped(text, 10).tokens == expected10, repr(text)


def test_facade_keeps_the_reference_exclusions():
    """Custom patterns and vocabularies without all 256 single bytes stay
    on the oracle, as in the reference facade."""
    ranks = {bytes([b]): b for b in range(256)}
    custom = GptBytePairEncoding(
        GptBytePairEncodingParams("custom", r"\S+|\s+", ranks, {}), device="cpu"
    )
    assert custom.native_engine() is None
    assert custom.encode("two words") == [116, 119, 111, 32, 119, 111, 114, 100, 115]
    partial = dict(list(ranks.items())[:200])
    incomplete = GptBytePairEncoding(
        GptBytePairEncodingParams("partial", "cl100k", partial, {}), device="cpu"
    )
    assert incomplete.native_engine() is None
    assert incomplete.encode("abc") == [97, 98, 99]
    # the device engine applies the same rule to its long-piece routing
    eng = DeviceEngine.from_oracle(incomplete.oracle, device="cpu", chunk_bytes=1 << 17)
    assert eng.native_long and eng._native_engine() is None


# --------------------------------------------------------------------------
# routing in the device engine
# --------------------------------------------------------------------------

def device_engine(native_long=True):
    _orc, _jn, _n, port_orc = engines("cl100k_base")
    return DeviceEngine.from_oracle(
        port_orc, device="cpu", chunk_bytes=1 << 17, native_long=native_long
    )


def expect(texts):
    orc = engines("cl100k_base")[0]
    return [orc.encode_ordinary(t)[0] if t else [] for t in texts]


def test_cjk_chunk_routes_to_native():
    """A chunk whose pieces over 64 bytes may cover more than a quarter of
    its bytes goes to the native engine, in encode and in count."""
    eng = device_engine()
    texts = ["中文" * n for n in (100, 300, 600)] + ["tail 中文", None, ""]
    before = (eng.fallback_chunks, eng.host_pieces, eng.stage_a_runs)
    got = eng.encode_ordinary_batch(texts)
    assert got == expect(texts)
    assert eng.native_chunks == 1
    assert eng.count_tokens_batch(texts) == [len(g) for g in got]
    assert eng.native_chunks == 2
    assert (eng.fallback_chunks, eng.host_pieces) == before[:2]
    assert eng.stage_a_runs == before[2] + 2  # Stage A still decides the route


def _spanning_doc():
    """About 130 KB of english lines, then 20 CJK lines of one 90-byte piece
    each: the only safe split points (an ASCII letter or digit before a line
    feed) are the english line ends, so the CJK lines fill the next chunk,
    an 8 KiB one, where their pieces pass the routing threshold."""
    english = "The quick brown fox jumps over 13 lazy dogs x1\n" * 2780
    cjk = ("中文" * 15 + "。\n") * 20
    return english + cjk


@pytest.mark.parametrize("native_long", [True, False])
def test_document_spanning_a_device_and_a_native_chunk(native_long):
    eng = device_engine(native_long)
    texts = ["first doc", _spanning_doc(), "last 中文 doc"]
    want = expect(texts)
    plan = eng.preload_corpus(texts)
    assert len(plan) == 2 and plan[0][3] and not plan[1][3]
    assert plan[0][2] == [0, 1] and plan[1][2] == [1, 2]
    routed = 1 if native_long else 0
    got = eng.encode_ordinary_batch(texts)
    assert got == want
    assert eng.native_chunks == routed
    assert eng.count_tokens_batch(texts) == [len(w) for w in want]
    # a plan: cold and warmed count (the warmed one is the mapped count),
    # cold and warmed encode
    total = sum(len(w) for w in want)
    for k in range(3):
        assert eng.count_tokens_corpus(texts if k == 0 else None, plan=plan) == total
    kinds = [c["kind"] for c in plan.chunk_cache]
    assert kinds == ["ok", "native" if native_long else "ok"]
    for _ in range(2):
        arrays = eng.encode_ordinary_batch_arrays(None, plan=plan)
        assert [a.tolist() for a in arrays] == want
    assert eng.native_chunks == routed * 7
    assert eng.fallback_chunks == 0


def test_native_engines_share_a_table_slot():
    a, b = device_engine(), device_engine()
    texts = ["中文" * 600]
    assert a.encode_ordinary_batch(texts) == b.encode_ordinary_batch(texts) == expect(texts)
    slots = len(native._slots)
    enc = Encodings.new_lazy_encoding_registry(device="cpu").get_encoding("cl100k_base")
    assert a._native_engine()._handle == b._native_engine()._handle
    assert enc.native_engine()._handle == a._native_engine()._handle
    assert len(native._slots) == slots
    # one engine per (vocabulary, pattern), from the one rule in native.py
    assert a._native_engine() is b._native_engine() is enc.native_engine()
    assert native.engine_for(a.packed, "cl100k") is a._native_engine()
    assert native.engine_for(a.packed, r"\S+") is None
    assert device_engine(native_long=False)._native_engine() is None


@pytest.mark.parametrize("fault", ["missing compiler", "broken source"])
def test_failed_build_raises(monkeypatch, tmp_path, fault):
    """A build that fails raises with the compiler's output everywhere the
    native engine is asked for; nothing returns None."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_engines", {})
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    if fault == "missing compiler":
        monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
        match = "failed to build"
    else:
        bad = tmp_path / "broken.cc"
        bad.write_text("int broken( {\n")
        monkeypatch.setattr(native, "SOURCE", str(bad))
        match = "error"
    with pytest.raises(RuntimeError, match=match):
        native.build()
    with pytest.raises(RuntimeError, match=match):
        native.available()
    _orc, _jn, _n, port_orc = engines("cl100k_base")
    eng = DeviceEngine.from_oracle(port_orc, device="cpu", chunk_bytes=1 << 17)
    with pytest.raises(RuntimeError, match=match):
        eng.encode_ordinary_batch(["中文" * 600])
    enc = GptBytePairEncoding(
        GptBytePairEncodingParams(
            "cl100k_base", "cl100k", port_orc.ranks, {}
        ),
        device="cpu",
    )
    with pytest.raises(RuntimeError, match=match):
        enc.encode("hello")
    assert not list(tmp_path.glob("*.so"))
