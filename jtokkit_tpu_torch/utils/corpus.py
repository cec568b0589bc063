"""Deterministic synthetic benchmark corpus.

The reference benchmarks over 400 Project Gutenberg books preloaded in RAM
(reference ``benchmark/README.md:9-11``; the books themselves are not in the
repo — ``benchmark/data`` ships empty). This generator produces a seeded,
Gutenberg-like English corpus with realistic word/punctuation/number/
contraction statistics, plus optional Unicode/CJK sections for the
long-piece stress config (BASELINE.json config 3).
"""

from __future__ import annotations

import numpy as np

_WORDS = (
    "the of and a to in is was he that it his her she which on at by not "
    "with this but had you were their all we him been has when who will "
    "more no if out so said what up its about into than them can only "
    "other new some could time these two may then do first any my now such "
    "like our over man me even most made after also did many before must "
    "through years where much your way well down should because each just "
    "those people how too little state good very make world still own see "
    "men work long get here between both life being under never day same "
    "another know while last might us great old year off come since against "
    "go came right used take three house whispered carriage evening candle "
    "library garden window morrow shoulders remarkable circumstance"
).split()

_PUNCT_SENT = [". ", ". ", ". ", "! ", "? ", "; ", ", "]
_CONTRACTIONS = ["'s", "'t", "'re", "'ve", "'m", "'ll", "'d"]

_CJK = "的一是不了人我在有他这为之大来以个中上们到说国和地也子时道出而要于就下得可你年生"
_EMOJI = ["🙂", "🚀", "🌍", "✨", "🦊"]


def generate(mb: float, seed: int = 0, flavor: str = "english") -> list:
    """Generate ~``mb`` megabytes of corpus as a list of documents (str).

    Flavors: "english" (Gutenberg-like), "mixed" (English + Unicode/emoji),
    "cjk" (continuous CJK — long-piece merge stress).
    """
    rng = np.random.RandomState(seed)
    target = int(mb * 1e6)
    docs = []
    total = 0
    doc_target = 64 * 1024  # ~64KB documents, like small book chapters

    while total < target:
        out = []
        size = 0
        while size < doc_target:
            if flavor == "cjk":
                n = int(rng.randint(40, 200))
                chars = rng.randint(0, len(_CJK), n)
                frag = "".join(_CJK[c] for c in chars) + ("。" if rng.rand() < 0.7 else "\n")
            else:
                n = int(rng.randint(4, 14))
                ws = rng.randint(0, len(_WORDS), n)
                words = [_WORDS[w] for w in ws]
                if rng.rand() < 0.25:
                    words[0] = words[0].capitalize()
                if rng.rand() < 0.12:
                    k = int(rng.randint(0, n))
                    words[k] += _CONTRACTIONS[int(rng.randint(0, 7))]
                if rng.rand() < 0.15:
                    k = int(rng.randint(0, n))
                    words[k] = str(int(rng.randint(0, 100000)))
                frag = " ".join(words) + _PUNCT_SENT[int(rng.randint(0, 7))]
                if flavor == "mixed" and rng.rand() < 0.08:
                    frag += rng.choice(_EMOJI) + " "
                if flavor == "mixed" and rng.rand() < 0.05:
                    chars = rng.randint(0, len(_CJK), int(rng.randint(4, 20)))
                    frag += "".join(_CJK[c] for c in chars) + " "
                if rng.rand() < 0.08:
                    frag += "\n"
                if rng.rand() < 0.02:
                    frag += "\n\n"
            out.append(frag)
            size += len(frag)
        doc = "".join(out)
        docs.append(doc)
        total += len(doc.encode("utf-8"))
    return docs
