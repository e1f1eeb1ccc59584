"""Symmetric per-row int8 quantization of K/V rows, bit-equal to
``repro/kernels/quant.py``: ``scale = absmax(row) / 127`` in fp32 (a
division, not a multiply by the reciprocal), ``q = round(row / scale)``
with round-half-to-even (``torch.round`` and ``jnp.round`` agree), clipped
to [-127, 127]; an all-zero row gets scale 1.0."""
from __future__ import annotations

import torch

INT8_MAX = 127.0


def quantize_kv(x, axis: int = -1):
    """Returns ``(q, scales)``: ``q`` int8 of ``x``'s shape, ``scales``
    float32 without ``axis``."""
    xf = x.float()
    bound = xf.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(bound > 0.0, bound / INT8_MAX,
                        torch.ones_like(bound))
    q = torch.clamp(torch.round(xf / scale), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale.squeeze(axis)


def dequantize_kv(q, scales, axis: int = -1, dtype=torch.float32):
    """Inverse of ``quantize_kv``: broadcast the scale row back over
    ``axis``, in fp32 unless ``dtype`` says otherwise."""
    return (q.float() * scales.float().unsqueeze(axis)).to(dtype)
