"""PyTorch/CUDA port of the ``repro`` LM stack for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports
nothing of it (or of JAX) and keeps its own copies of what it needs.
Hot spots that ``repro`` wrote as Pallas TPU kernels are CUDA C++
kernels here (``csrc/``), built with ``nvcc`` for ``sm_90a`` at first
use and bound through ``ctypes`` (``kernels/_build.py``).
"""
