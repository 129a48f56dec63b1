"""PyTorch/CUDA port of the lameness clip engine for one NVIDIA H100.

A second package beside ``lameness_tpu`` (the JAX reference, which it never
imports).  Layout and names mirror the JAX package; the Pallas TPU kernels
on the engine's path are CUDA C++ kernels under ``csrc/``, built with nvcc
at first use (``ops/_cuda.py``).
"""
