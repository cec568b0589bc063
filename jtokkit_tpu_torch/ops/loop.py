"""Loops that run to their end on the device: the counterpart of the JAX
package's ``lax.while_loop`` around the merge rounds.

``while_loop(more, body, state)`` runs ``state = body(*state)`` while
``more(*state)`` (a 0-d bool tensor) holds and returns the final state and
the rounds it ran as a 0-d int32 tensor on the state's device.

- On CUDA it is recorded into the CUDA graph that the current stream is
  capturing, as ONE conditional WHILE node (``csrc/loop.cu``): the first
  test and the node are captured on that stream; the body (one round, the
  state written back in place, the next test, and the step kernel that
  counts the round and sets the node's condition) is captured by PyTorch as
  a graph of its own, on a side stream and into its own memory pool, and
  goes into the node's body as a child graph. A replay runs the loop on the
  card with no read by the host. Outside a capture it raises: the loop
  exists only inside a graph, and nothing gives way to another form.
- On the CPU (the plain version) it is the loop that reads the test back
  after every round (:data:`.merge.EXIT_TESTS` counts those reads).

The body's graph owns the memory pool that its temporaries live in, so the
outer graph must keep it: :func:`take_bodies` hands the bodies recorded
since its last call to whoever owns the outer graph. A body must not hold a
prefix scan (``ops/scan.py``): the scan's epoch is counted per replay of the
outer graph, not per round, so a recorded scan inside a body raises.

:data:`RECORDED` counts the loops recorded. The step kernel runs once when a
loop starts and once per round; those runs are on the card, and the caller
learns them from the round counters it reads back (:data:`STEP_RUNS`, added
to by :func:`count_steps`).

The library is built and loaded by :mod:`._build` at first use.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import KernelLibrary, cuda_device_index

# loops recorded into CUDA graphs
RECORDED = 0
# step-kernel runs on the card (one per loop run + one per round), counted
# by callers from the round counters they read back
STEP_RUNS = 0


def _declare(lib: ctypes.CDLL) -> None:
    vp = ctypes.c_void_p
    lib.jt_loop_runtime_version.argtypes = []
    lib.jt_loop_runtime_version.restype = ctypes.c_int
    lib.jt_loop_init.argtypes = [ctypes.c_int]
    lib.jt_loop_init.restype = ctypes.c_int
    lib.jt_loop_begin.argtypes = [vp, ctypes.POINTER(ctypes.c_ulonglong)]
    lib.jt_loop_begin.restype = ctypes.c_int
    lib.jt_loop_step.argtypes = [ctypes.c_ulonglong, vp, vp, ctypes.c_int, vp]
    lib.jt_loop_step.restype = ctypes.c_int
    lib.jt_loop_end.argtypes = [vp, ctypes.c_ulonglong, vp]
    lib.jt_loop_end.restype = ctypes.c_int


LIBRARY = KernelLibrary("loop", _declare)

_READY = set()      # device indices whose step kernel is loaded
_SIDE = {}          # device index -> the side stream bodies are captured on
_BODIES = []        # body graphs recorded since the last take_bodies()


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"device loop: {what} failed with CUDA error {rc}")


def prepare(device: torch.device) -> None:
    """Build and load the library and the step kernel for ``device``; call
    before a capture that records loops (loading during a capture is not
    relied on)."""
    if device.type != "cuda":
        return
    index = cuda_device_index(device)
    if index not in _READY:
        _check(LIBRARY.load().jt_loop_init(index), "loading the step kernel")
        _READY.add(index)


def take_bodies() -> list:
    """The body graphs recorded since the last call (the caller keeps them
    as long as the graph that holds their loops)."""
    out = list(_BODIES)
    _BODIES.clear()
    return out


def count_steps(rounds) -> None:
    """Account the step-kernel runs of loops whose round counts were read
    back: one per loop run and one per round."""
    global STEP_RUNS
    STEP_RUNS += sum(1 + int(r) for r in rounds)


def while_loop(more, body, state, read_flag):
    """Run ``state = body(*state)`` while ``more(*state)`` holds.

    ``state`` is a tuple of tensors of one device; ``read_flag(flag)``
    brings a 0-d bool tensor to the host (the plain version's exit test).
    Returns (state, rounds int32 0-d tensor).
    """
    state = tuple(state)
    dev = state[0].device
    if dev.type == "cuda":
        return _device_while(more, body, state)
    ran = 0
    while read_flag(more(*state)):
        state = tuple(body(*state))
        ran += 1
    return state, torch.tensor(ran, dtype=torch.int32, device=dev)


def _device_while(more, body, state):
    global RECORDED
    from . import scan

    dev = state[0].device
    if not torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "a device loop is recorded into a CUDA graph: the current stream"
            " is not capturing"
        )
    index = cuda_device_index(dev)
    if index not in _READY:
        raise RuntimeError("device loop: prepare() was not called before the capture")
    lib = LIBRARY.load()
    stream = torch.cuda.current_stream(dev)
    # the loop's own copy of the state: every round writes it in place
    state = tuple(x.clone() for x in state)
    rounds = torch.empty((), dtype=torch.int32, device=dev)
    handle = ctypes.c_ulonglong(0)
    _check(lib.jt_loop_begin(stream.cuda_stream, ctypes.byref(handle)),
           "making the conditional handle")
    first = more(*state)
    _check(lib.jt_loop_step(handle.value, first.data_ptr(), rounds.data_ptr(),
                            0, stream.cuda_stream), "the first test")
    side = _SIDE.get(index)
    if side is None:
        side = _SIDE[index] = torch.cuda.Stream(dev)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    scans = scan.CAPTURED_CALLS
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            new = body(*state)
            for s, n in zip(state, new):
                s.copy_(n)
            flag = more(*state)
            _check(lib.jt_loop_step(handle.value, flag.data_ptr(),
                                    rounds.data_ptr(), 1, side.cuda_stream),
                   "the round's test")
        finally:
            graph.capture_end()
    if scan.CAPTURED_CALLS != scans:
        raise RuntimeError("device loop: a prefix scan was recorded inside a loop body")
    _check(lib.jt_loop_end(stream.cuda_stream, handle.value, graph.raw_cuda_graph()),
           "adding the WHILE node")
    _BODIES.append(graph)
    RECORDED += 1
    return state, rounds
