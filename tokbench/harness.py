"""One run of one cell: set-up, the measured window, the check, the line.

A cell of ``BENCHMARK.json`` names a configuration (a file under
``configs/``: the encoding, its rank file and pattern for the reference,
the documents' lengths) and a traffic mix (a file under ``traffic/``: the
entry the window drives, the batch size, the ring and the scripts). Set-up
builds the ring of fresh batches from the seed (``ring.py``), loads the
port and warms the shapes of the cell's own traffic. The window is a
closed loop of one caller over the ring. Per-layer metrics are read by the
readers under ``metrics/``, one file per quantity, from the program's
counters and from a profiler trace of the window's first calls.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from . import trace as trace_mod
from . import yardstick
from .check import Answers, check, longest_batches
from .ring import Ring, build_ring

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PACKAGE = os.path.basename(HERE)
# calls the traced run profiles at the start of its window, after one
# call that the profiler warms up on and drops
TRACE_CALLS = 8
BANNED = ("jax", "jaxlib", "flax", "jtokkit_tpu")
# kernel names in the breakdown are cut to this length (templates run long)
NAME_CHARS = 160


# ----------------------------------------------------------------------
# files
# ----------------------------------------------------------------------

def load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict

    @property
    def kind(self) -> str:
        return ENTRIES[self.traffic["entry"]][0]


def load_cell(name: str, root: str = ROOT, bench: Optional[dict] = None) -> Cell:
    """The workload ``name`` of ``BENCHMARK.json`` with its configuration
    and traffic files."""
    bench = bench or load_json(os.path.join(root, "BENCHMARK.json"))
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    return cell_from(by_name[name], bench, root)


def cell_from(workload: dict, bench: dict, root: str = ROOT) -> Cell:
    """A workload entry (name, config, traffic, chips) with its files."""
    cfg = {c["name"]: c for c in bench["configs"]}[workload["config"]]
    config = load_json(os.path.join(root, cfg["file"]))
    traffic = load_json(os.path.join(root, PACKAGE, "traffic",
                                     f"{workload['traffic']}.json"))
    return Cell(workload["name"], workload, config, traffic)


# ----------------------------------------------------------------------
# the program
# ----------------------------------------------------------------------

def _encode_arrays(enc):
    return enc.device_engine().encode_ordinary_batch_arrays


def _count(enc):
    return enc.count_tokens_batch


# entry name -> (kind of answer, the call it drives given the encoding)
ENTRIES: Dict[str, tuple] = {
    "encode_arrays": ("encode", _encode_arrays),
    "count": ("count", _count),
}


def make_program(cell: Cell, device: str):
    """(encoding, its device engine, the entry's call) from the port's
    public registry."""
    from jtokkit_tpu_torch import Encodings

    enc = Encodings.new_default_encoding_registry(device=device).get_encoding(
        cell.config["encoding"])
    return enc, enc.device_engine(), ENTRIES[cell.traffic["entry"]][1](enc)


def counters(engine) -> Dict[str, float]:
    """Every number the engine keeps, and its graph cache's, by name."""
    out = {k: v for k, v in vars(engine).items()
           if isinstance(v, (int, float)) and not isinstance(v, bool)}
    for k, v in engine.cold_cache_stats().items():
        if isinstance(v, (int, float)):
            out[f"cold.{k}"] = v
    return out


def banned_modules() -> List[str]:
    """JAX and the JAX package among the loaded modules, by whole top-level
    name (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them (copied
    from ``jtokkit_tpu_torch/scripts/profile_gather.py``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


# ----------------------------------------------------------------------
# set-up and window
# ----------------------------------------------------------------------

def warm_up(call, engine, ring: Ring, sync) -> int:
    """Every batch of the ring once, in order: the window cycles the same
    ring, so this captures every shape the window will replay. Returns the
    graphs captured."""
    before = engine.cold_cache_stats()["captures"]
    for batch in ring.batches:
        call(batch)
        sync()
    return engine.cold_cache_stats()["captures"] - before


@dataclass
class Window:
    answers: Answers
    batches: List[int] = field(default_factory=list)   # ring index of each call
    latency_s: List[float] = field(default_factory=list)
    returned: List[float] = field(default_factory=list)  # clock at each return
    start: float = 0.0
    end: float = 0.0
    trace_path: Optional[str] = None


def run_window(call, ring: Ring, seconds: float, answers: Answers,
               trace_dir: Optional[str]) -> Window:
    """A closed loop of one caller cycling the ring for ``seconds``: every
    call is issued when the last returned, and the window closes at the
    first return past its length. ``answers`` keeps what the check needs
    of each answer. With ``trace_dir`` the first calls run under
    torch.profiler."""
    w = Window(answers)
    prof = None
    if trace_dir is not None:
        from torch.profiler import (ProfilerActivity, profile, record_function,
                                    schedule)

        w.trace_path = os.path.join(trace_dir, "trace.json")
        prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=TRACE_CALLS, repeat=1),
            on_trace_ready=lambda p: p.export_chrome_trace(w.trace_path),
        )
        prof.start()
    i = 0
    w.start = time.perf_counter()
    deadline = w.start + seconds
    while True:
        b = i % len(ring)
        t0 = time.perf_counter()
        try:
            if prof is not None:
                with record_function(trace_mod.CALL):
                    ans = call(ring.batches[b])
            else:
                ans = call(ring.batches[b])
        except Exception as e:  # a call that raises is a failed call
            ans = e
        t1 = time.perf_counter()
        w.batches.append(b)
        w.latency_s.append(t1 - t0)
        w.returned.append(t1)
        answers.add(b, ans)
        del ans
        i += 1
        if prof is not None:
            prof.step()
            if i == TRACE_CALLS + 1:
                prof.stop()
                prof = None
        if t1 >= deadline:
            break
    w.end = t1
    if prof is not None:
        prof.stop()
    return w


# ----------------------------------------------------------------------
# metrics
# ----------------------------------------------------------------------

@dataclass
class Context:
    """What a per-layer reader reads."""
    kind: str                      # "encode" or "count"
    calls: int                     # calls in the window
    before: Dict[str, float]       # the engine's counters at the window's start
    after: Dict[str, float]        # and at its close
    activity: Optional[trace_mod.Activity] = None  # the traced calls (card only)
    traced_bytes: int = 0          # bytes the traced calls had to move
    card: str = ""

    def delta(self, name: str) -> float:
        return self.after[name] - self.before[name]


def end_to_end(kind: str, setup_s: float, ring: Ring, w: Window) -> Dict[str, float]:
    """Every end-to-end quantity the run can give; BENCHMARK.json picks."""
    done = sum(ring.batch_bytes[b] for b in w.batches)
    return {
        "setup_s": setup_s,
        f"{kind}_MBps": done / (w.end - w.start) / 1e6,
        f"{kind}_p95_ms": float(np.percentile(np.array(w.latency_s) * 1e3, 95)),
    }


def prefixes(ring: Ring, w: Window, step: float) -> List[tuple]:
    """(MB/s, p95 ms) of the calls that returned within the window's first
    ``step``, ``2 * step``, ... seconds: how the metrics settle with the
    window's length (a log line, no metric)."""
    ends = np.array(w.returned)
    done = np.cumsum([ring.batch_bytes[b] for b in w.batches])
    out = []
    for k in range(1, int((w.end - w.start) // step) + 1):
        n = int(np.searchsorted(ends, w.start + k * step, side="right"))
        if n:
            out.append((float(done[n - 1]) / (ends[n - 1] - w.start) / 1e6,
                        float(np.percentile(np.array(w.latency_s[:n]) * 1e3, 95))))
    return out


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def quantity(name: str) -> str:
    """What a metric measures: its name up to the first dot. A quantity
    split by the end-to-end metric it moves (``graph_captures.encode``,
    ``graph_captures.count``) is read alike in every cell."""
    return name.split(".")[0]


def read_metric(name: str, ctx: Context, root: str):
    """The value of the reader ``metrics/<quantity>.py``, or None where it
    finds nothing to read."""
    base = quantity(name)
    path = os.path.join(root, PACKAGE, "metrics", f"{base}.py")
    spec = importlib.util.spec_from_file_location(f"{PACKAGE}_metric_{base}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


# ----------------------------------------------------------------------
# one run
# ----------------------------------------------------------------------

def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", root: str = ROOT, bench: Optional[dict] = None,
             process_age: Callable[[], float] = lambda: 0.0,
             wrap: Optional[Callable] = None, warm: bool = True, log=print) -> dict:
    """Run one cell and return its result line as a dict. ``wrap`` wraps
    the entry's call, to plant a fault under the timed path or put the
    control in its place (which has no shapes to warm: ``warm=False``);
    the command passes neither."""
    import torch

    bench = bench or load_json(os.path.join(root, "BENCHMARK.json"))
    cell = load_cell(name, root, bench)
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    ring = build_ring(cell.config, cell.traffic, seed, os.path.join(root, PACKAGE))
    log(f"ring: {len(ring)} batches, {sum(ring.batch_bytes)} bytes, "
        f"{sum(len(b) for b in ring.batches)} documents")
    enc, engine, call = make_program(cell, device)
    if wrap is not None:
        call = wrap(call)
    captured = warm_up(call, engine, ring, sync) if warm else 0
    log(f"warm-up: {len(ring)} batches, {captured} graphs captured; cache "
        f"{engine.cold_cache_stats()}")

    trace_dir = tempfile.mkdtemp() if trace and on_card else None
    kind = cell.kind
    # what set-up made stays out of the collector's rounds in the window
    gc.collect()
    gc.freeze()
    try:
        before = counters(engine)
        setup_s = process_age()
        w = run_window(call, ring, seconds,
                       Answers(kind, seed, longest_batches(ring)), trace_dir)
        after = counters(engine)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        activity = (trace_mod.read_trace(w.trace_path)
                    if trace_dir is not None else None)
    finally:
        if trace_dir is not None:
            shutil.rmtree(trace_dir, ignore_errors=True)
    log(f"calls in the window: {len(w.batches)} in {w.end - w.start:.6f} s")
    log("median call ms by tenth of the window: " + " ".join(
        f"{np.median(part) * 1e3:.2f}" for part in np.array_split(
            np.array(w.latency_s), min(10, len(w.latency_s))) if len(part)))
    log("MB/s and p95 ms over the window's first 10, 20, ... s: " + " ".join(
        f"{r:.3f}/{p:.3f}" for r, p in prefixes(ring, w, 10.0)))
    errors = [a for a in w.answers.kept.values() if isinstance(a, BaseException)]
    if errors:
        log(f"calls that raised: {len(errors)}; the first:\n"
            + "".join(traceback.format_exception(errors[0])))
    del enc, engine, call
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    found = banned_modules()
    if found:
        raise RuntimeError(f"loaded in the measuring process: {', '.join(found)}")

    card = torch.cuda.get_device_name(0) if on_card else "cpu"
    device_out = {"platform": "gpu" if on_card else "cpu", "kind": card,
                  "count": cell.workload["chips"] if on_card else 0,
                  "memory_peak_bytes": int(peak)}
    metrics = {}
    result = {}
    if not trace:
        values = end_to_end(kind, setup_s, ring, w)
        for m in bench["end_to_end"]:
            if applies(m, name):
                metrics[m["name"]] = {"value": values[quantity(m["name"])],
                                      "unit": m["unit"]}
    else:
        traced = range(1, min(TRACE_CALLS + 1, len(w.batches)))
        ctx = Context(kind, len(w.batches), before, after, activity,
                      sum(yardstick.required_bytes(
                          kind, ring.batch_bytes[w.batches[c]],
                          len(ring.batches[w.batches[c]]), w.answers.tokens(c))
                          for c in traced if w.answers.digests[c] is not None),
                      card)
        for m in bench["per_layer"]:
            if applies(m, name):
                v = read_metric(m["name"], ctx, root)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if activity is not None:
            device_out["busy_s"] = activity.busy_s
            device_out["window_s"] = activity.span_s
            result["breakdown"] = {
                "device_ops": [[n[:NAME_CHARS], s] for n, s in activity.device_ops],
                "idle_gaps": [[n, s] for n, s in activity.idle_gaps],
            }
    if on_card:
        log(f"card: {card_line()}")

    checks = check(ring, w.batches, w.answers, seed,
                   os.path.join(root, cell.config["vocab_file"]), cell.config["pattern"])
    out = {"correct": checks.passed and checks.failed_calls == 0,
           "attempted": len(w.batches), "failed": checks.failed_calls,
           "metrics": metrics, "device": device_out}
    out.update(result)
    out["checks"] = checks.as_json()
    for line in checks.lines():
        log(line)
    return out
