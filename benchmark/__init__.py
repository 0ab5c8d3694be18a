"""The benchmark of ``nbody_tpu_torch``, the PyTorch and CUDA port.

One command runs one cell once::

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the repository root lists the cells and metrics. Each
configuration, mix, cell and metric is a file of its own under this folder
(``configs/``, ``mixes/``, ``workloads/``, ``end_to_end/``, ``metrics/``),
found by the name ``BENCHMARK.json`` gives it (:mod:`benchmark.catalog`).
``inputs``, ``reference``, ``check``, ``roofline`` and ``tracing`` are the
yardstick: they import nothing of the port.
"""
