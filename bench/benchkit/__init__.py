"""The benchmark harness of the PyTorch/CUDA port (``repro_torch``).

One run measures one cell of ``BENCHMARK.json`` (``bench/run.py``). What
belongs to one configuration, traffic mix or per-layer metric lives in a
file of its own under ``bench/`` and is found by its name: see
``bench/README.md``.
"""
