"""What the window keeps of its answers, and how the check judges them: a
share of the answers whole, and the first to each script's longest
document, the sizes of every call; the reference's sample holds a document
of each script."""

import os

import numpy as np
import pytest

from tokbench import check
from tokbench.reference import Reference
from tokbench.ring import Ring

from .conftest import REPO

VOCAB = os.path.join(REPO, "jtokkit_tpu", "vocab", "assets", "r50k_base.tiktoken")
PATTERN = "gpt2"


@pytest.fixture(scope="module")
def ref():
    return Reference(VOCAB, PATTERN)


def _ring():
    batches = [["Hello world.", "A longer document, with more words in it."],
               ["It was the best of times.", "x"],
               ["你好。", "Short."]]
    scripts = [["english", "english"], ["english", "english"], ["cjk", "english"]]
    sizes = [np.array([len(d.encode()) for d in b]) for b in batches]
    return Ring(batches, [int(s.sum()) for s in sizes], sizes, scripts)


def _answers(ring, ref, calls, seed=7, change=None):
    """The window's answers to ``calls`` (ring indices), each the
    reference's ids; ``change(c, ans)`` alters call ``c``'s."""
    a = check.Answers("encode", seed, check.longest_batches(ring))
    for c, b in enumerate(calls):
        ans = [np.asarray(ref.encode(t), np.int32) for t in ring.batches[b]]
        a.add(b, change(c, ans) if change else ans)
    return a


def test_keeps_a_share_whole_the_longest_first_and_every_size(ref):
    r = _ring()
    calls = [0, 1, 2] * 200
    a = _answers(r, ref, calls)
    assert {a.first[b] for b in range(3)} == {0, 1, 2}
    assert check.longest_batches(r) == {0, 2}
    assert 0 in a.kept and 2 in a.kept
    assert 0.06 * 600 < len(a.kept) < 0.2 * 600
    assert len(a.digests) == len(calls)
    assert a.digests[3] == tuple(len(ref.encode(t)) for t in r.batches[0])
    assert a.tokens(3) == sum(a.digests[3])
    # the same seed keeps the same calls
    assert _answers(r, ref, calls).kept.keys() == a.kept.keys()
    res = check.check(r, calls, a, 7, VOCAB, PATTERN)
    assert res.passed and res.failed_calls == 0, res.numbers


def test_a_later_answer_of_other_sizes_is_caught_unkept(ref):
    r = _ring()
    calls = [0, 1, 2] * 20
    keep = _answers(r, ref, calls).kept
    c_bad = next(c for c in range(3, len(calls)) if c not in keep)
    a = _answers(r, ref, calls, change=lambda c, ans: ans[:1] + [ans[1][:-1]]
                 if c == c_bad else ans)
    assert c_bad not in a.kept
    res = check.check(r, calls, a, 7, VOCAB, PATTERN)
    assert res.numbers["repeat_mismatch"][0] == 1 and res.failed_calls == 1


def test_a_later_answer_with_an_id_altered_is_caught_kept(ref):
    r = _ring()
    calls = [0, 1, 2] * 20
    keep = _answers(r, ref, calls).kept
    # a kept answer to a batch with an earlier kept answer
    c_bad = next(c for c in keep if any(k < c and calls[k] == calls[c] for k in keep))

    def alter(c, ans):
        if c == c_bad:
            ans[0] = ans[0].copy()
            ans[0][0] += 1
        return ans
    res = check.check(r, calls, _answers(r, ref, calls, change=alter), 7, VOCAB, PATTERN)
    assert res.numbers["repeat_mismatch"][0] == 1 and not res.passed


def test_an_exception_is_malformed_and_kept(ref):
    r = _ring()
    a = check.Answers("encode", 1)
    a.add(0, [np.asarray(ref.encode(t), np.int32) for t in r.batches[0]])
    a.add(0, RuntimeError("lost"))
    assert isinstance(a.kept[1], RuntimeError) and a.digests[1] is None
    res = check.check(r, [0, 0], a, 1, VOCAB, PATTERN)
    assert res.numbers["malformed"][0] == 1 and not res.passed


def test_the_sample_holds_each_scripts_longest_document():
    r = _ring()
    batches = [0, 1, 2, 0, 1, 2]
    picked = check.sample(r, batches, [1, 2, 3, 4], seed=3)
    # english's longest (batch 0, first kept at call 3), the only cjk
    # (batch 2, call 2), and the one batch left (1, first kept at call 1)
    assert picked == [1, 2, 3]
    assert check.sample(r, batches, [1, 2, 3, 4], seed=3) == picked


def test_reference_scripts_must_reach_the_rings(ref):
    r = _ring()
    res = check.check(r, [0, 1], _answers(r, ref, [0, 1]), 7, VOCAB, PATTERN)
    assert res.numbers["reference_scripts"] == (1, "min", 2)
    assert not res.passed
