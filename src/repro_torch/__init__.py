"""PyTorch + CUDA port of the rhizome / diffusion graph engine.

Mirrors the JAX reference package module for module (same relative
paths, public names and config fields) without importing it or JAX.
The engine's relax phase runs as a hand-written CUDA kernel on an NVIDIA
Hopper GPU (``kernels/csrc``), with a plain PyTorch version beside it
that the CPU runs.
"""
