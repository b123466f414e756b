"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` serves one cell of ``BENCHMARK.json`` on one card and
prints one JSON line.  Everything that belongs to one configuration,
traffic mix, cell or per-layer metric is a file of its own, found by its
name: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``cells/<cell>.json``, ``metrics/<metric>.py``.  Nothing here imports
JAX or the JAX package ``repro``; ``reference/`` imports nothing of the
port either.
"""
