"""Layer building blocks (ports of ``repro/nn/layers.py``): the linear and
rmsnorm spec constructors with their apply functions, and rotary position
embeddings in fp32 in the JAX package's order of operations
(``repro/nn/layers.py:97-111``).

Activations flow in the caller's dtype with params cast at the use site;
``apply_rmsnorm`` runs the fused RMSNorm kernel on the card (its plain
version on the CPU), accumulating in fp32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm import rmsnorm as fused_rmsnorm
from repro_torch.nn.spec import TensorSpec


def linear(d_in: int, d_out: int, axes=("embed", "mlp"), bias: bool = False,
           scale: float | None = None):
    """Spec of ``x @ w (+ b)``: w [d_in, d_out], b [d_out]."""
    p = {"w": TensorSpec((d_in, d_out), axes, "normal", scale)}
    if bias:
        p["b"] = TensorSpec((d_out,), (axes[1],), "zeros")
    return p


def rmsnorm(dim: int, axes=("embed",)):
    """Spec of an RMS norm's scale [dim] (ones)."""
    return {"scale": TensorSpec((dim,), axes, "ones")}


def apply_linear(p, x):
    """``x @ w (+ b)`` in x's dtype, params cast at the use site."""
    dt = x.dtype
    y = x @ p["w"].to(dt)
    if "b" in p:
        y = y + p["b"].to(dt)
    return y


def apply_rmsnorm(p, x, eps: float = 1e-6, zero_centered: bool = False):
    """RMS norm of x [..., d] with ``p["scale"]`` [d], through the fused
    RMSNorm kernel; fp32 accumulation, output in x's type."""
    return fused_rmsnorm(x, p["scale"], eps=eps, zero_centered=zero_centered)


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
