"""Entry points of the port: a single-device step and a multi-rank dry
run. Counterpart of the root ``__graft_entry__.py``.

    from jtokkit_tpu_torch import entry
    fn, args = entry.entry()          # on the CUDA card; device="cpu" too
    fn(*args)
    entry.dryrun_multichip(1)         # one NCCL rank per CUDA card
    entry.dryrun_multichip(2, device="cpu")  # two gloo ranks on the CPU
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cl100k_device_engine(device=None, **kwargs):
    from jtokkit_tpu_torch.engine.device import DeviceEngine
    from jtokkit_tpu_torch.engine.oracle import OracleEngine
    from jtokkit_tpu_torch.vocab.definitions import BUILTIN_DEFINITIONS
    from jtokkit_tpu_torch.vocab.loader import load_builtin_ranks

    d = BUILTIN_DEFINITIONS["cl100k_base"]
    orc = OracleEngine(
        d.name, d.pattern, load_builtin_ranks(d.vocab_name), d.special_tokens
    )
    return DeviceEngine.from_oracle(orc, device=device, **kwargs)


def entry(device=None):
    """(fn, example_args): one device encode step on cl100k_base.

    The step runs the pipeline's two compute stages on the engine's device
    (``None`` means the CUDA card): Stage A v4 (classify, the scan kernel's
    piece boundaries, word-table hits) and the exact transposed byte-pair
    merge over a miss bucket (``merge_rows_t3``).
    """
    import torch

    from jtokkit_tpu_torch.ops import merge, stage4

    eng = _cl100k_device_engine(device)
    t = eng.tables

    def step(buf, doc_ends, mat_t, lens):
        table, meta = stage4.stage_a_v4(
            buf, doc_ends, t.class_table, eng.pattern, t.word_rows,
            t.word_mask, variant="ascii", piece_div=4, miss_div=8,
        )
        ids, active, _rounds = merge.merge_rows_t3(
            mat_t, lens, t.byte_to_id, t.byte_pair_id, t.pair_rows_cat,
            t.table_mask,
        )
        return meta, table.hit.sum(), ids, active

    text = ("Attention is all you need. " * 80).encode("utf-8")
    buf = np.zeros(8192, dtype=np.uint8)
    buf[: len(text)] = np.frombuffer(text, dtype=np.uint8)
    doc_ends = np.full(64, len(text), dtype=np.int32)
    mat_t = np.zeros((16, 128), dtype=np.uint8)
    words = b"Hello world tokens merge fast "
    for r in range(128):
        w = words[(r * 3) % 24 : (r * 3) % 24 + 8]
        mat_t[: len(w), r] = np.frombuffer(w, dtype=np.uint8)
    lens = np.full((128,), 8, dtype=np.int32)

    example_args = tuple(
        torch.from_numpy(a).to(eng.device) for a in (buf, doc_ends, mat_t, lens)
    )
    return step, example_args


def _dryrun_rank(rank: int, n_ranks: int, port: int, device: str) -> None:
    """One rank of :func:`dryrun_multichip` (run in a child process)."""
    import torch
    import torch.distributed as dist

    from jtokkit_tpu_torch.ops import scan
    from jtokkit_tpu_torch.parallel.mesh import initialize_distributed
    from jtokkit_tpu_torch.parallel.sharded import ShardedTokenizer

    torch.set_num_threads(1)
    dev = initialize_distributed(f"tcp://localhost:{port}", n_ranks, rank, device=device)
    try:
        eng = _cl100k_device_engine(dev, chunk_bytes=1 << 17)
        tok = ShardedTokenizer(eng)
        texts = [
            f"shard {i}: the quick brown fox 🦊 jumps {i * 1234567} times.\n"
            for i in range(n_ranks * 3)
        ] + ["中文" * 600, ""]  # the CJK document routes to the native engine
        expect = [eng.oracle.encode_ordinary(t)[0] for t in texts]
        total = tok.count_tokens_corpus(texts)
        if total != sum(len(e) for e in expect):
            raise RuntimeError(f"rank {rank}: sharded count {total} differs")
        print(f"rank {rank}: all_reduce count ok ({total}) on {dev}", flush=True)
        if tok.encode_ordinary_batch(texts) != expect:
            raise RuntimeError(f"rank {rank}: sharded encode differs from the oracle")
        print(f"rank {rank}: all_gather encode ok ({len(texts)} documents, "
              f"{eng.native_chunks} native chunks on this rank)", flush=True)
        # three passes over a plan: the first gathers the layout, the later
        # ones gather the rank's tokens from the device; a plan of one
        # document leaves every other rank empty
        for docs in (texts, texts[:1]):
            plan = tok.preload_corpus(docs)
            gathers = []
            for _ in range(3):
                before = tok.collectives["all_gather"]
                arrays = tok.encode_ordinary_batch_arrays(None, plan=plan)
                gathers.append(tok.collectives["all_gather"] - before)
                if [a.tolist() for a in arrays] != expect[: len(docs)]:
                    raise RuntimeError(f"rank {rank}: warmed encode differs")
            empty = [r for r, a in enumerate(plan.assign) if not a]
            print(f"rank {rank}: warmed encode of {len(docs)} documents ok "
                  f"(all_gathers {' '.join(map(str, gathers))}; empty ranks "
                  f"{empty})", flush=True)
        print(f"rank {rank}: {scan.KERNEL_LAUNCHES} scan kernel launches", flush=True)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(code: str, n_ranks: int, args, timeout: float) -> list:
    """Run ``python -c code RANK N_RANKS PORT *args`` in ``n_ranks`` child
    processes, one per rank, all started together from the repository with
    it on ``PYTHONPATH`` and a free localhost port for the group. Returns
    each rank's output (standard error merged in); raises if a rank fails,
    and kills every child on the timeout."""
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", code, str(rank), str(n_ranks), str(port),
             *map(str, args)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=_REPO,
        )
        for rank in range(n_ranks)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()  # only the children started here
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {rank} failed:\n{out[-3000:]}")
    return outs


def check_cards(kind: str, n_ranks: int) -> None:
    """Raise unless there is one CUDA card for each of ``n_ranks`` NCCL
    ranks (``kind`` is the device type the ranks run on)."""
    import torch

    if kind == "cuda" and n_ranks > torch.cuda.device_count():
        raise RuntimeError(
            f"{n_ranks} ranks need {n_ranks} CUDA cards;"
            f" {torch.cuda.device_count()} visible"
        )


def dryrun_multichip(n_devices: int, timeout: float = 300, device=None) -> list:
    """The data-parallel path over ``n_devices`` ranks, one child process
    each, on small inputs: the sharded count (its all_reduce) and encode
    (its all_gathers), checked against the host oracle on every rank.

    ``device``: ``None`` means the CUDA cards, one NCCL rank per card (raises
    without a card, or with fewer cards than ``n_devices``); ``"cpu"`` runs
    gloo ranks on the CPU. Returns each rank's output; raises if a rank
    fails, and kills every child on the timeout."""
    from jtokkit_tpu_torch.engine.device import resolve_device

    kind = resolve_device(device).type
    check_cards(kind, n_devices)
    code = "import sys; from jtokkit_tpu_torch.entry import _dryrun_rank; " \
           "_dryrun_rank(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])"
    return run_ranks(code, n_devices, [kind], timeout)
