"""Benchmark harness of the PyTorch/CUDA port (``repro_torch``).

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) and prints one JSON result line; see ``portbench/run.py``.
Everything a cell needs is found by name: ``configs/<config>.json``,
``mixes/<traffic>.json`` (which names its driver, ``drivers/<driver>.py``)
and ``metrics/<metric>.py`` for each per-layer metric.
"""
