"""In a fresh interpreter with ``jax``, ``jaxlib``, ``flax`` and
``jtokkit_tpu`` blocked (by whole top-level name: ``jtokkit_tpu_torch``
begins with ``jtokkit_tpu`` and must still load), every module of the
benchmark and the port imports; with the port blocked too, the reference
does."""

import os
import subprocess
import sys

from .conftest import REPO

BLOCKER = r"""
import importlib.abc, os, sys
BLOCKED = set(sys.argv[1].split(","))

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[2])
import importlib, importlib.util, pkgutil
for mod in sys.argv[3].split(","):
    importlib.import_module(mod)
if sys.argv[4] == "all":
    import tokbench
    for m in pkgutil.walk_packages(tokbench.__path__, "tokbench."):
        if ".tests" not in m.name:
            importlib.import_module(m.name)
    metrics = os.path.join(os.path.dirname(tokbench.__file__), "metrics")
    for f in sorted(os.listdir(metrics)):
        spec = importlib.util.spec_from_file_location("m_" + f, os.path.join(metrics, f))
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
    import jtokkit_tpu_torch.engine.device, jtokkit_tpu_torch.encoding_impl
found = sorted({m.split(".")[0] for m in sys.modules} & BLOCKED)
assert not found, found
print("ok")
"""


def _run(blocked, modules, everything):
    r = subprocess.run(
        [sys.executable, "-c", BLOCKER, ",".join(blocked), REPO, ",".join(modules),
         "all" if everything else "some"],
        capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
    )
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr[-3000:]


def test_benchmark_and_port_import_without_jax():
    _run(["jax", "jaxlib", "flax", "jtokkit_tpu"],
         ["tokbench.harness", "tokbench.run", "jtokkit_tpu_torch"], True)


def test_reference_imports_without_the_port():
    _run(["jax", "jaxlib", "flax", "jtokkit_tpu", "jtokkit_tpu_torch", "torch"],
         ["tokbench.reference", "tokbench.check"], False)


def test_banned_modules_compares_whole_top_level_names():
    from tokbench import harness

    saved = dict(sys.modules)
    try:
        sys.modules["jtokkit_tpu_torch_x"] = object()
        assert "jtokkit_tpu" not in harness.banned_modules()
        sys.modules["jtokkit_tpu.ops"] = object()
        assert "jtokkit_tpu" in harness.banned_modules()
    finally:
        for k in set(sys.modules) - set(saved):
            del sys.modules[k]
