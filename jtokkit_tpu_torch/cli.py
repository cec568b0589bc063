"""Command-line interface: encode / decode / count / info / bench.

A copy of ``jtokkit_tpu/cli.py`` over the port. ``--device`` names the
device of the registry's batch engines, or of the benchmark's (default: the
CUDA card, and without one the command raises; ``--device cpu`` runs on the
CPU). The JAX CLI's ``bench --device`` picks a mode; here ``bench --mode``
does (``--host`` is ``--mode host``). Usage::

    python -m jtokkit_tpu_torch.cli encode --encoding cl100k_base "Hello world"
    python -m jtokkit_tpu_torch.cli decode --encoding cl100k_base 9906 11 1917 0
    python -m jtokkit_tpu_torch.cli count  --encoding cl100k_base --file corpus.txt
    python -m jtokkit_tpu_torch.cli info
    python -m jtokkit_tpu_torch.cli bench  --mb 16 --mode device-count
"""

from __future__ import annotations

import argparse
import json
import sys


def _get_encoding(name: str, device):
    from jtokkit_tpu_torch import Encodings

    enc = Encodings.new_lazy_encoding_registry(device=device).get_encoding(name)
    if enc is None:
        sys.exit(f"error: unknown encoding {name!r}")
    return enc


def cmd_encode(args) -> None:
    enc = _get_encoding(args.encoding, args.device)
    text = args.text if args.text is not None else sys.stdin.read()
    fn = enc.encode_ordinary if args.ordinary else enc.encode
    print(json.dumps(fn(text)))


def cmd_decode(args) -> None:
    enc = _get_encoding(args.encoding, args.device)
    tokens = [int(t) for t in args.tokens] or [
        int(t) for t in sys.stdin.read().replace(",", " ").split()
    ]
    sys.stdout.write(enc.decode(tokens))


def cmd_count(args) -> None:
    enc = _get_encoding(args.encoding, args.device)
    if args.file:
        with open(args.file, "r", encoding="utf-8") as f:
            text = f.read()
    else:
        text = args.text if args.text is not None else sys.stdin.read()
    fn = enc.count_tokens_ordinary if args.ordinary else enc.count_tokens
    print(fn(text))


def cmd_info(_args) -> None:
    from jtokkit_tpu_torch import EncodingType, ModelType, __version__

    info = {
        "version": __version__,
        "encodings": [t.value for t in EncodingType],
        "models": {
            m.model_name: {
                "encoding": m.encoding_type.value,
                "max_context_length": m.max_context_length,
            }
            for m in ModelType
        },
    }
    print(json.dumps(info, indent=2))


def cmd_bench(args) -> None:
    from . import bench as bench_mod

    result = bench_mod.run(
        mb=args.mb,
        encoding=args.encoding,
        mode=args.mode,
        corpus=args.corpus,
        device=args.device,
    )
    print(json.dumps(result))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="jtokkit_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    enc_arg = dict(default="cl100k_base", help="encoding name")
    dev_arg = dict(default=None,
                   help="device of the batch engines (default: the CUDA card)")

    pe = sub.add_parser("encode", help="encode text to token ids")
    pe.add_argument("text", nargs="?", default=None)
    pe.add_argument("--encoding", **enc_arg)
    pe.add_argument("--device", **dev_arg)
    pe.add_argument("--ordinary", action="store_true",
                    help="treat special-token literals as plain text")
    pe.set_defaults(fn=cmd_encode)

    pd = sub.add_parser("decode", help="decode token ids to text")
    pd.add_argument("tokens", nargs="*")
    pd.add_argument("--encoding", **enc_arg)
    pd.add_argument("--device", **dev_arg)
    pd.set_defaults(fn=cmd_decode)

    pc = sub.add_parser("count", help="count tokens")
    pc.add_argument("text", nargs="?", default=None)
    pc.add_argument("--file")
    pc.add_argument("--encoding", **enc_arg)
    pc.add_argument("--device", **dev_arg)
    pc.add_argument("--ordinary", action="store_true")
    pc.set_defaults(fn=cmd_count)

    pi = sub.add_parser("info", help="encodings + model table")
    pi.set_defaults(fn=cmd_info)

    from .bench import MODES

    pb = sub.add_parser("bench", help="throughput benchmark")
    pb.add_argument("--mb", type=float, default=16)
    pb.add_argument("--encoding", **enc_arg)
    pb.add_argument("--mode", default="device", choices=MODES)
    pb.add_argument("--host", dest="mode", action="store_const", const="host",
                    help="the host oracle: --mode host")
    pb.add_argument("--device", **dev_arg)
    pb.add_argument("--corpus", default=None, help="path to a corpus file")
    pb.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
