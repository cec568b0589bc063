"""Build and load the hand-written CUDA kernels.

Each kernel is one source in ``csrc/`` with a plain C interface. It is
compiled with ``nvcc`` for ``sm_90a`` at first use into ``_build/`` (the
library is named by the hash of the source and the flags, so an edited
source rebuilds) and loaded with ctypes. Nothing is built when a module is
imported, and a failed build raises: no caller gives way to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


class KernelLibrary:
    """One ``csrc/<name>.cu`` source and the shared library built from it.

    ``declare(lib)`` sets ``argtypes`` and ``restype`` of the library's
    functions once it is loaded.
    """

    def __init__(self, name: str, declare: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = os.path.join(_PKG_DIR, "csrc", f"{name}.cu")
        self.build_log = ""  # nvcc's output (-Xptxas -v) of this process's build
        self._declare = declare
        self._lib = None
        self._lock = threading.Lock()

    def path(self) -> str:
        with open(self.source, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
        return os.path.join(
            BUILD_DIR, f"libjtokkit_{self.name}_{digest.hexdigest()[:16]}.so"
        )

    def build(self) -> str:
        """Compile the library if this source has no build yet; returns its
        path."""
        path = self.path()
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, self.source],
                capture_output=True, text=True,
            )
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build the {self.name} kernel:\n{self.build_log}"
                )
            os.replace(tmp, path)
        return path

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            with self._lock:
                if self._lib is None:
                    lib = ctypes.CDLL(self.build())
                    self._declare(lib)
                    self._lib = lib
        return self._lib


def build_all(libraries: Sequence[KernelLibrary]) -> None:
    """Build several libraries at once, one ``nvcc`` process each."""
    with ThreadPoolExecutor(max(len(libraries), 1)) as pool:
        for result in [pool.submit(lib.build) for lib in libraries]:
            result.result()


def cuda_device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()
