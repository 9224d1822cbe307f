"""Hand-written CUDA kernels for the engine's compute hot-spots.

``fused_relax_reduce`` — the per-round relax phase (frontier gather +
semiring relax + active mask + blocked segment reduction) as one kernel,
over (V,) tables (K1 dense, K2 worklist) or (V, Q) query-lane tables (K3
dense, K4 worklist).  ``rhizome_segment_reduce`` — the standalone blocked
segment reduce of given messages (K9, ``pallas_mode='reduce'``).  The
kernels are built from ``csrc/`` by ``_build`` on first use.  ``ops``
holds the wrappers the engine calls, ``ref`` the plain PyTorch oracles.
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
