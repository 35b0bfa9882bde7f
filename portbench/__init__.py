"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

One command runs one cell once (``python3 -m portbench.run --help``). The
cells, metrics and bounds are listed in ``BENCHMARK.json`` at the root of
the checkout; each configuration, traffic mix, limit set and metric is a
file of its own here, found by its name there.
"""
