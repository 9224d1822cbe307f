"""Gradient compression for data-parallel reduction.

int8 block-quantized gradients with error feedback: each leaf is
quantized per block of ``BLOCK`` values, dequantized, and the
quantization residual is carried to the next step.  The reference
places the pair around its cross-pod reduction; on one card there is
no reduction between them, so the pair changes the gradient exactly as
the reference's does and nothing else.

``compress_decompress(grads, residuals)`` takes and returns trees
(nested dicts) of tensors.  Rounding is half-to-even, as ``jnp.round``
is, so ``q`` and the scales equal the reference's, except in a block
where float32 rounding puts a dequantized value more than half a step
from its input (about one vector of 500 values in 1,300): there the
reference misses its own bound, and the port steps ``q`` toward the
value or, where both neighbours miss, quantizes that block again with
a scale larger by 2**-20.  A ``DTensor`` leaf (sharded training) is
quantized whole, as the reference's global array is, and each rank
keeps its shard of the result.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding.specs import gathered, is_dtensor

BLOCK = 256


def _round_steps(blocks, scale):
    """Half-to-even ``q`` for ``blocks / scale``, and where ``q * scale``
    still misses the value by more than half a step."""
    q = torch.clamp(torch.round(blocks / scale), -127, 127)
    # float32 division can carry a value just inside half a step onto the
    # tie, and half-to-even then rounds it away from the value: step such
    # a q back toward it
    miss = q * scale - blocks
    q = torch.where(miss.abs() > scale / 2, q - torch.sign(miss), q)
    return q, ((q * scale - blocks).abs() > scale / 2).any(dim=1,
                                                           keepdim=True)


def _quantize(g):
    """Per-block symmetric int8. Returns (q, scale). g: any shape."""
    flat = g.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q, over = _round_steps(blocks, scale)
    # a value within an ulp of a midpoint can be more than half a step
    # from both rounded products q * scale: only such a block is quantized
    # again, with a scale larger by 2**-20, which moves every midpoint
    # clear of it
    rows = over[:, 0].nonzero()[:, 0]
    if rows.numel():
        scale[rows] = scale[rows] * (1 + 2.0 ** -20)
        q[rows] = _round_steps(blocks[rows], scale[rows])[0]
    return q.to(torch.int8), scale


def _dequantize(q, scale, shape, size):
    flat = (q.float() * scale).reshape(-1)[:size]
    return flat.reshape(shape)


def compress_decompress(grads, residuals=None):
    """Quantize->dequantize each grad leaf with error feedback.

    Returns (new_grads, new_residuals). residuals=None disables feedback.
    """
    if isinstance(grads, dict):
        pairs = {k: compress_decompress(
            g, None if residuals is None else residuals[k])
            for k, g in grads.items()}
        return ({k: g for k, (g, _) in pairs.items()},
                None if residuals is None
                else {k: r for k, (_, r) in pairs.items()})
    if is_dtensor(grads):
        # the blocks run over the whole flattened leaf, across shards
        out, res = compress_decompress(
            gathered(grads),
            None if residuals is None else gathered(residuals))
        from torch.distributed.tensor import distribute_tensor
        mesh, pl = grads.device_mesh, grads.placements
        place = lambda t: distribute_tensor(t, mesh, pl, src_data_rank=None)
        return place(out), (None if res is None else place(res))
    gf = grads.float()
    if residuals is not None:
        gf = gf + residuals
    q, s = _quantize(gf)
    deq = _dequantize(q, s, gf.shape, gf.numel())
    return deq.to(grads.dtype), (gf - deq if residuals is not None else None)


def init_residuals(params):
    if isinstance(params, dict):
        return {k: init_residuals(v) for k, v in params.items()}
    return torch.zeros_like(params, dtype=torch.float32,
                            memory_format=torch.contiguous_format)
