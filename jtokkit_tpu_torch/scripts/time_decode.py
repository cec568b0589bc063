"""Repeated batch decode of one corpus on the card: how far one host-clock
reading of decode MB/s can be trusted.

    python3 jtokkit_tpu_torch/scripts/time_decode.py [--root DIR] [--mb 16] [--repeats 8]

``decode_bytes_batch`` is bound by the host (Python ints into one array,
bytes into per-document objects), so a single timing, as ``chip_smoke.py``
takes it, is one draw from a wide spread. This script encodes ``--mb`` MB of
the seeded english corpus with cl100k_base, then times ``--repeats`` decodes
of all its tokens three times over: with the garbage collector as it is,
with the heap frozen (``gc.freeze()``), and with the collector off. Every
decode is checked against the documents' bytes. ``--root`` names another
checkout whose ``jtokkit_tpu_torch`` is timed instead of this one's, so two
commits can be compared inside one call on one card (run the script as a
file, as above, for that). Each line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import gc
import os
import sys
import time
from typing import Dict, List


def main(root: str, mb: float = 16, repeats: int = 8) -> Dict[str, List[float]]:
    """MB/s of every decode, by collector mode."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from jtokkit_tpu_torch import Encodings, EncodingType
    from jtokkit_tpu_torch.scripts.profile_gather import card_line
    from jtokkit_tpu_torch.utils import corpus

    enc = Encodings.new_default_encoding_registry().get_encoding(EncodingType.CL100K_BASE)
    card = card_line()
    docs = corpus.generate(mb, flavor="english")
    want = [d.encode("utf-8") for d in docs]
    size = sum(len(b) for b in want) / 1e6
    tokens = enc.encode_ordinary_batch(docs)
    enc.decode_bytes_batch(tokens[:16])  # warm-up
    torch.cuda.synchronize()

    def timed() -> List[float]:
        rates = []
        for _ in range(repeats):
            t = time.time()
            got = enc.decode_bytes_batch(tokens)
            rates.append(size / (time.time() - t))
            if got != want:
                raise AssertionError("decode differs from the documents")
        return rates

    out = {}
    for mode in ("gc on", "gc frozen", "gc off"):
        if mode == "gc frozen":
            gc.collect()
            gc.freeze()
        elif mode == "gc off":
            gc.disable()
        out[mode] = timed()
        print(f"decode english {size:.2f} MB, {mode}: "
              + " ".join(f"{r:.1f}" for r in out[mode])
              + f" MB/s, median {sorted(out[mode])[repeats // 2]:.1f} "
              f"[{os.path.abspath(root)}; {card}]", flush=True)
    gc.enable()
    gc.unfreeze()
    return out


if __name__ == "__main__":
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=here, help="checkout to time")
    parser.add_argument("--mb", type=float, default=16)
    parser.add_argument("--repeats", type=int, default=8)
    args = parser.parse_args()
    main(args.root, args.mb, args.repeats)
