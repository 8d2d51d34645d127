"""PyTorch and CUDA port of ``audiocraft_tpu`` for NVIDIA Hopper (H100).

It mirrors the JAX package's layout (``nn/``, ``quant/``, ``codec/``,
``ops/``, ``ckpt/``, ``builders.py``) and imports nothing of it.  Kernels
written by hand in CUDA C++ live in ``csrc/`` and are built at first use
(``ops/_build.py``).  Importing the package imports no submodule.
"""
