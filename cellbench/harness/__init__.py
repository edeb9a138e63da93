"""The benchmark's harness: one cell of ``BENCHMARK.json`` run once.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own under the benchmark's directory, found by its
name (``manifest.py``); the code here is the same for every cell.
"""
