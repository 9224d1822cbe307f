"""Hand-written CUDA kernels for the engine's compute hot-spots.

``fused_relax_reduce`` — the per-round relax phase (frontier gather +
semiring relax + active mask + blocked segment reduction) as one kernel,
built from ``csrc/`` by ``_build`` on first use.  ``ops`` holds the
wrappers the engine calls, ``ref`` the plain PyTorch oracles.
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
