"""The control of ``correct``: the plain reference put in the program's
place, with one guarantee broken.

The configurations state exact byte-pair encoding. The step that would
tempt a later change is a fixed number of merge rounds (the warmed plans
already replay the rounds a cold pass counted), so the control merges
every piece that is not itself a token for at most :data:`MERGE_LIMIT`
rounds. Its ids still decode to the document, so only the comparison with
the reference can catch it, and it has to.

    python3 tokbench/control.py --workload <cell> --seeds 1 2 3 --seconds 5

runs each seed as a run of the cell does (ring, window, check; it has no
shapes to warm) with the control in place of the entry, in one process,
and prints one JSON line per seed. The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import numpy as np

MERGE_LIMIT = 4


class Control:
    """A callable in the entry's place: a batch in, the capped reference's
    answers out."""

    def __init__(self, kind: str, vocab_file: str, pattern: str):
        from tokbench.reference import Reference

        self.kind = kind
        self.ref = Reference(vocab_file, pattern)

    def __call__(self, batch):
        out = [self.ref.encode(t, merge_limit=MERGE_LIMIT) for t in batch]
        if self.kind == "count":
            return [len(ids) for ids in out]
        return [np.asarray(ids, np.int32) for ids in out]


def run(name: str, seeds, seconds: float, device: str = "cuda", root: Optional[str] = None,
        log=lambda line: None):
    """The control's result for each seed of cell ``name``."""
    from tokbench import harness

    from tokbench import check

    root = root or harness.ROOT
    cell = harness.load_cell(name, root)
    control = Control(cell.kind, os.path.join(root, cell.config["vocab_file"]),
                      cell.config["pattern"])
    # the control's window holds a few calls of seconds each: every answer
    # is kept whole, so that the reference compares some
    share, check.KEEP_SHARE = check.KEEP_SHARE, 1.0
    try:
        return [harness.run_cell(name, seed, seconds, False, device=device, root=root,
                                 wrap=lambda _call: control, warm=False, log=log)
                for seed in seeds]
    finally:
        check.KEEP_SHARE = share


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the control of a cell's check")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    for seed, r in zip(args.seeds, run(args.workload, args.seeds, args.seconds,
                                       log=lambda line: print(line, file=sys.stderr))):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": r["correct"], "attempted": r["attempted"],
                          "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main())
