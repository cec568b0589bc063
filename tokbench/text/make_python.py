"""Write the two text files of Python source, ``python-stdlib.json`` and
``python-stdlib-nonascii.json``, from the standard library of the Python
that runs this script.

    python3 tokbench/text/make_python.py [--lib DIR] [--seed N] [--out DIR]

The files are kept as Codex (Chen et al., arXiv:2107.03374, sec. 3.1)
filtered GitHub's Python files: an average line length of at most 100, a
longest line of at most 1,000, an alphanumeric share of at least 0.25, and
not generated: no comment or docstring-opening line among the first ten
says ``generated from``, ``generated by``, ``generated and used by``,
``autogenerated`` or ``auto-generated`` (the ``encodings`` gencodec tables,
``_sysconfigdata_*``, ``pydoc_data/topics.py``), save the files in
:data:`HAND_WRITTEN`. Test directories and ``site-packages`` are left out.
Each text file is a ``sentences`` script whose words are whole lines, as
they stand with their indentation and without their newline, repeats kept:
the generator joins them with newlines (the configuration's ``wrap_rate``
1.0), so a phrase is 1-16 lines of code. The first file samples lines of the
files that are ASCII only, the second lines of the others.

``source_stats`` in each file are the plain reference's figures
(``tokbench/reference``, p50k_base) over the files the lines came from:
the text a ring draws from them is held to these by the benchmark's tests.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import sysconfig

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
VOCAB = os.path.join(ROOT, "jtokkit_tpu", "vocab", "assets", "p50k_base.tiktoken")
SKIP_DIRS = ("test", "tests", "idle_test", "site-packages", "__pycache__")
GENERATED = ("generated from", "generated by", "generated and used by",
             "autogenerated", "auto-generated")
# what a comment or a docstring opens with
OPENERS = ("#", '"""', "'''", 'r"""')
# hand-written modules whose header names something else as generated,
# checked by hand ("the grammar tables generated by pgen")
HAND_WRITTEN = ("lib2to3/pgen2/parse.py",)
ASCII_LINES = 40_000
NONASCII_LINES = 10_000
# the generator's other keys: phrases of 1-16 lines, each line closed by a
# newline, nothing else drawn (it needs one contraction, never drawn)
SENTENCES = {
    "sentence_words": [1, 16], "capital_rate": 0.0, "contraction_rate": 0.0,
    "contractions": ["#"], "number_rate": 0.0, "number_below": 1,
    "punctuation": ["\n"], "emoji_rate": 0.0, "emoji": [], "cjk_rate": 0.0,
    "cjk_chars": "", "cjk_run": [1, 1], "newline_rate": 0.0,
    "blank_line_rate": 0.0,
}
# the word table's rows hold tokens of at most this many bytes
# (jtokkit_tpu_torch/engine/tables.py): a longer piece or a piece that is
# no token goes to the merge
WORD_BYTES = 16


def library_files(lib: str):
    """Relative paths of the library's ``.py`` files, sorted, outside the
    test directories and ``site-packages``."""
    out = []
    for dirpath, dirnames, filenames in os.walk(lib):
        rel = os.path.relpath(dirpath, lib)
        dirnames[:] = sorted(d for d in dirnames if d not in SKIP_DIRS)
        out += [os.path.normpath(os.path.join(rel, f)) for f in filenames
                if f.endswith(".py")]
    return sorted(out)


def codex_filter(rel: str, text: str):
    """Why Codex's filters drop the file ``rel`` of text ``text``, or None
    where they keep it."""
    lines = text.split("\n")
    lengths = [len(x) for x in lines]
    if sum(lengths) / len(lines) > 100:
        return "average line length over 100"
    if max(lengths) > 1000:
        return "longest line over 1000"
    if sum(ch.isalnum() for ch in text) / max(1, len(text)) < 0.25:
        return "alphanumeric share under 0.25"
    for line in lines[:10]:
        head = line.lstrip().lower()
        if (head.startswith(OPENERS) and any(g in head for g in GENERATED)
                and rel not in HAND_WRITTEN):
            return "generated"
    return None


def source_lines(text: str):
    """The file's lines without their newlines (a final newline ends the
    last line and opens none)."""
    lines = text.split("\n")
    return lines[:-1] if lines and lines[-1] == "" else lines


def stats(texts, reference) -> dict:
    """The reference's figures over ``texts``: bytes a token and a piece,
    the share of pieces that are one token, pieces sent to the merge (not a
    token of at most 16 bytes) a MiB, the share of whitespace pieces and
    the longest piece."""
    n_bytes = tokens = pieces = one = misses = space = longest = 0
    ranks = reference.ranks
    for t in texts:
        n_bytes += len(t.encode("utf-8"))
        tokens += len(reference.encode(t))
        for a, b in reference.split(t):
            p = t[a:b].encode("utf-8")
            pieces += 1
            one += p in ranks
            misses += not (len(p) <= WORD_BYTES and p in ranks)
            space += t[a:b].isspace()
            longest = max(longest, len(p))
    return {"bytes": n_bytes,
            "bytes_per_token": round(n_bytes / tokens, 4),
            "bytes_per_piece": round(n_bytes / pieces, 4),
            "one_token_pieces": round(one / pieces, 4),
            "misses_per_mib": round(misses / n_bytes * (1 << 20), 1),
            "whitespace_pieces": round(space / pieces, 4),
            "longest_piece": longest}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--lib", default=sysconfig.get_paths()["stdlib"])
    p.add_argument("--seed", type=int, default=210703374)
    p.add_argument("--out", default=HERE)
    args = p.parse_args(argv)

    sys.path.insert(0, ROOT)
    from tokbench.reference import Reference

    version = sys.version.split()[0]
    kept, dropped = {True: {}, False: {}}, {}
    for rel in library_files(args.lib):
        with open(os.path.join(args.lib, rel), "rb") as f:
            raw = f.read()
        try:
            text = raw.decode("utf-8")
        except UnicodeDecodeError:
            dropped[rel] = "not UTF-8"
            continue
        why = codex_filter(rel, text)
        if why:
            dropped[rel] = why
        else:
            kept[text.isascii()][rel] = text
    rng = np.random.default_rng(args.seed)
    reference = Reference(VOCAB, "gpt2")
    n_kept = len(kept[True]) + len(kept[False])
    drops = "; ".join(f"{k} ({v})" for k, v in sorted(dropped.items()))
    for ascii_only, name, want in ((True, "python-stdlib", ASCII_LINES),
                                   (False, "python-stdlib-nonascii", NONASCII_LINES)):
        files = kept[ascii_only]
        lines = [x for rel in sorted(files) for x in source_lines(files[rel])]
        if len(lines) > want:
            pick = np.sort(rng.choice(len(lines), want, replace=False))
            lines = [lines[i] for i in pick.tolist()]
        which = "with no non-ASCII character" if ascii_only else "with a non-ASCII character"
        about = (
            f"Python source: lines of CPython {version}'s standard library (Lib; "
            f"the Python Software Foundation License), made by "
            f"tokbench/text/make_python.py with seed {args.seed}. Left out: test/, "
            f"*/tests/, idlelib/idle_test/ and site-packages. Kept as Codex "
            f"(arXiv:2107.03374, sec. 3.1) filtered GitHub: average line length "
            f"<= 100, longest line <= 1000, alphanumeric share >= 0.25, and not "
            f"generated (no comment or docstring-opening line of the first ten "
            f"says 'generated from', 'generated by', 'generated and used by', "
            f"'autogenerated' or 'auto-generated'; {', '.join(HAND_WRITTEN)} says "
            f"it of pgen's tables and is kept). {n_kept} files kept ({len(kept[True])} ASCII "
            f"only, {len(kept[False])} not), {len(dropped)} dropped: {drops}. "
            f"This file: {len(lines)} lines, "
            + ("a seeded uniform sample" if len(lines) == want else "every line")
            + f" of the {len(files)} kept files {which}, each as it stands with its "
            f"indentation and trailing whitespace and without its newline, "
            f"repeats kept. Each word is a line and the one punctuation a newline, "
            f"so a phrase is 1-16 lines; the one contraction is never drawn "
            f"(contraction_rate 0): the generator needs one entry. source_stats: "
            f"the plain reference (p50k_base) over those files."
        )
        spec = {"kind": "sentences", "about": about, "words": lines, **SENTENCES,
                "source_stats": stats(list(files.values()), reference)}
        path = os.path.join(args.out, f"{name}.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(spec, f, ensure_ascii=False, indent=0)
            f.write("\n")
        print(f"{path}: {len(lines)} lines of {len(files)} files; "
              f"{spec['source_stats']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
