"""The benchmark of the PyTorch and CUDA port (``audiocraft_tpu_torch``).

One command runs one cell once::

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: ``BENCHMARK.json`` at the checkout's root lists
the cells and metrics; ``configs/<config>.json`` holds a configuration,
``workloads/<cell>.json`` a cell (its configuration, driver, traffic and
check limits), ``drivers/<driver>.py`` a kind of traffic,
``layer_metrics/<metric>.py`` the reader of a per-layer metric, ``counts/``
the operations and bytes of kernels and model steps, ``reference/`` the plain
references that decide ``correct``.  Nothing here imports ``jax``,
``jaxlib``, ``flax`` or the JAX package ``audiocraft_tpu``; the reference
imports nothing of the port.
"""
