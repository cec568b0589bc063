"""tokbench: the benchmark of jtokkit_tpu_torch, the PyTorch and CUDA port.

``python3 tokbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on a CUDA card and
prints one JSON line. Configurations, traffic mixes, text statistics and
per-layer metric readers are files found by name under this directory.
"""
