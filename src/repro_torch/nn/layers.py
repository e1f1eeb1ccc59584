"""Rotary position embeddings, in fp32 and in the JAX package's order of
operations (``repro/nn/layers.py:97-111``)."""
from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, max_len: int, theta: float = 10000.0,
                     dtype=torch.float32, device=None):
    """(cos, sin) tables ``[max_len, head_dim // 2]``."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    inv = 1.0 / (theta ** exps)
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)  # [T, head_dim//2]
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def apply_rope(x, cos, sin, positions):
    """x: [..., T, H, D]; positions: [..., T] integer."""
    c = cos[positions][..., None, :]  # [..., T, 1, D/2]
    s = sin[positions][..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)
