"""The port's spans (``jtokkit_tpu_torch/utils/spans.py``) on its batch
calls: which ``<span>_ns`` counters of the engine each call advances, how
the spans nest, how much of a call they cover, the ``jtokkit.<span>`` ranges
in a profiler's trace, that no range is entered without a profiler, that a
call that raises closes its span, and that ``cold_capture_seconds`` is the
``capture`` span's total.

Engines run on the CPU (``device="cpu"``); nothing here needs a card or
JAX.
"""

import json
import time
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import profiler
from torch.profiler import ProfilerActivity, profile, record_function

from jtokkit_tpu_torch import Encodings, EncodingType, SpecialTokenError
from jtokkit_tpu_torch.engine.device import SPANS, ColdUnit, DeviceEngine

# The suite runs in several worker processes at once; torch's own thread
# pool in each of them would oversubscribe the cores.
torch.set_num_threads(1)

DOCS = ["The quick brown fox jumps over 13 lazy dogs.\n" * 40,
        "I'm 42 — ĄĘ中🙂 ", "", None, "short"]
# one piece of 600 bytes in a 604-byte chunk: routed to the native engine
NATIVE_DOCS = ["中文" * 100 + " end"]

# span -> its parent inside a batch call (the call spans have none)
PARENT = {
    "plan": "call", "upload": "call", "stage_a": "call", "metas_read": "stage_a",
    "stages_b_c": "call", "counts_read": "call", "fetch": "encode",
    "host_chunks": "call", "native_wait": "host_chunks", "fetch_wait": "encode",
    "unpack_split": "encode",
}
CALL_STAGES = [s for s, p in PARENT.items() if p in ("call", "encode")]


@pytest.fixture(scope="module")
def enc():
    return Encodings.new_lazy_encoding_registry(device="cpu").get_encoding(
        EncodingType.CL100K_BASE)


def totals(engine):
    return {name: getattr(engine, f"{name}_ns") for name in SPANS}


def advanced(engine, fn):
    """The spans whose counters ``fn()`` advanced, with their ns."""
    before = totals(engine)
    fn()
    return {k: v - before[k] for k, v in totals(engine).items() if v != before[k]}


def _encode(enc):
    return enc.device_engine().encode_ordinary_batch_arrays(DOCS)


def _count(enc):
    return enc.count_tokens_batch(DOCS)


def _native(enc):
    return enc.device_engine().encode_ordinary_batch_arrays(NATIVE_DOCS)


def _warmed(enc):
    engine = enc.device_engine()
    plan = engine.preload_corpus(DOCS)
    engine.encode_ordinary_batch_arrays(None, plan=plan)
    return lambda: engine.encode_ordinary_batch_arrays(None, plan=plan)


CASES = {
    "encode": (_encode, {"encode", "plan", "upload", "stage_a", "metas_read",
                         "stages_b_c", "counts_read", "fetch", "fetch_wait",
                         "unpack_split"}),
    "count": (_count, {"special_check", "count", "plan", "upload", "stage_a",
                       "metas_read", "stages_b_c", "counts_read"}),
    # no chunk on the device: no counts to read and no copy to wait on
    "native": (_native, {"encode", "plan", "upload", "stage_a", "metas_read",
                         "stages_b_c", "fetch", "host_chunks", "native_wait",
                         "unpack_split"}),
    "warmed_plan": (None, {"encode", "cached_dispatch", "fetch", "fetch_wait",
                           "unpack_split"}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_a_call_advances_exactly_its_spans(enc, case):
    fn, want = CASES[case]
    call = _warmed(enc) if fn is None else (lambda: fn(enc))
    engine = enc.device_engine()
    native = engine.native_chunks
    got = advanced(engine, call)
    assert set(got) == want
    assert all(v > 0 for v in got.values())
    assert (engine.native_chunks > native) == (case == "native")
    # nothing was captured on the CPU, and the capture seconds say so
    assert engine.capture_ns == 0 and engine.cold_capture_seconds == 0.0


@pytest.mark.parametrize("case", ["encode", "count", "native"])
def test_children_no_larger_than_parents_and_stages_cover_the_call(enc, case):
    fn, _want = CASES[case]
    got = advanced(enc.device_engine(), lambda: fn(enc))
    call = "count" if case == "count" else "encode"
    for child, parent in PARENT.items():
        if child in got:
            assert got[child] <= got[call if parent == "call" else parent], child
    stages = sum(got.get(s, 0) for s in CALL_STAGES)
    assert stages <= got[call]
    assert stages >= 0.5 * got[call]


def _annotations(trace_path):
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"]


def _inside(child, parent):
    return (parent["ts"] <= child["ts"]
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"])


def test_profiler_trace_holds_the_ranges_nested(enc, tmp_path):
    path = str(tmp_path / "trace.json")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for name in ("encode", "count", "native"):
            with record_function(f"test.{name}"):
                CASES[name][0](enc)
    prof.export_chrome_trace(path)
    events = _annotations(path)
    outer = {e["name"][len("test."):]: e for e in events
             if e["name"].startswith("test.")}
    assert set(outer) == {"encode", "count", "native"}
    for case, test_range in outer.items():
        mine = {e["name"][len("jtokkit."):]: e for e in events
                if e["name"].startswith("jtokkit.") and _inside(e, test_range)}
        assert set(mine) == CASES[case][1], case
        call = "count" if case == "count" else "encode"
        for name, e in mine.items():
            # on the caller's thread, inside its parent
            assert e["tid"] == test_range["tid"], name
            parent = PARENT.get(name)
            if parent is not None:
                assert _inside(e, mine[call if parent == "call" else parent]), name


def test_no_range_is_entered_without_a_profiler(enc, monkeypatch):
    entered = []
    real = profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(profiler, "record_function", counting)
    assert not profiler._is_profiler_enabled
    got = advanced(enc.device_engine(), lambda: (_encode(enc), _count(enc)))
    assert got and entered == []
    # the same calls under a profiler enter one range a span
    with profile(activities=[ProfilerActivity.CPU]):
        _count(enc)
    assert sorted(entered) == sorted(f"jtokkit.{s}" for s in CASES["count"][1])


def test_a_call_that_raises_in_the_special_check_closes_its_span(enc, tmp_path):
    engine = enc.device_engine()
    bad = ["fine", "a <|endoftext|>"]
    got = {}

    def failing():
        with pytest.raises(SpecialTokenError):
            enc.count_tokens_batch(bad)

    got["off"] = advanced(engine, failing)
    path = str(tmp_path / "trace.json")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got["on"] = advanced(engine, failing)
        _count(enc)
    prof.export_chrome_trace(path)
    for g in got.values():
        assert set(g) == {"special_check"}
    events = {}
    for e in _annotations(path):
        events.setdefault(e["name"], []).append(e)
    failed, after = sorted(events["jtokkit.special_check"], key=lambda e: e["ts"])
    # the failed call's range closed before the next call began
    assert failed["ts"] + failed["dur"] <= after["ts"]
    assert not any(_inside(e, failed) for name, es in events.items()
                   for e in es if name != "jtokkit.special_check")
    assert len(events["jtokkit.count"]) == 1


def test_cold_capture_seconds_is_the_capture_span(enc, monkeypatch):
    """A unit met for the first time is captured inside the ``capture``
    span, and the engine's and the unit's capture seconds are that span's
    time, not another clock's. The capture itself needs a card: here the
    engine is made to take the card's branch with the capture and the
    replay stood in for."""
    engine = DeviceEngine.from_oracle(enc.oracle, device="cpu", chunk_bytes=1 << 17)
    key = ("test", 4)
    engine._cold["stage_a"][key] = unit = ColdUnit(key, [torch.zeros(4)])

    def fake_capture(warm, units, record, shared_pool=True):
        warm()
        for u in units:
            u.out = record(u)
            u.graph = object()
        time.sleep(0.002)
        return 123.0, 4096

    monkeypatch.setattr(engine, "device", SimpleNamespace(type="cuda"))
    monkeypatch.setattr(engine, "_capture", fake_capture)
    monkeypatch.setattr(engine, "_replay", lambda u: u.out)

    def run():
        return engine._cold_run("stage_a", key, [torch.ones(4)],
                                lambda u: (u.inputs[0] * 2,), lambda u: None)

    out = run()
    assert torch.equal(out[0], torch.full((4,), 2.0))
    assert engine.cold_captures == 1 and engine.capture_ns >= 2_000_000
    assert unit.capture_seconds == engine.capture_ns / 1e9
    assert engine.cold_capture_seconds == engine.capture_ns / 1e9
    assert engine.cold_cache_stats()["capture_seconds"] == engine.capture_ns / 1e9
    assert unit.pool_bytes == 4096
    # a replay captures nothing more
    ns = engine.capture_ns
    run()
    assert engine.cold_captures == 1 and engine.capture_ns == ns
