"""Mamba2 (SSD) layer (port of ``repro/models/mamba2.py``): the chunked
scan over a whole prompt and the one-token recurrence of decode.

Shapes: x [B, S, d] with d_in = expand * d, heads nh = d_in / headdim,
state N, one B/C group.  ``mamba2_forward`` runs the scan through
``ops.ssd_scan`` (the hand-written CUDA SSD-scan kernel on the card, its
plain chunked version ``kernels.ssd_scan.ssd_scan_ref`` on the CPU; the
JAX package calls the jnp ``ssd_chunked`` there).  ``ssd_decode_step``
has no kernel in either package.  The layer's pre-norm and its gated RMS
norm run through ``ops.rmsnorm``: fp32 statistics and scale, then one
cast, the inline jnp norm's arithmetic.  In training the scan is
differentiated by its hand-written backward (``kernels/ssd_scan.py``
``SSDScan``; the backward kernels on the card).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.nn.spec import TensorSpec


def mamba2_spec(n_layers: int, d: int, d_in: int, n_state: int, headdim: int,
                conv_width: int):
    """The layer's weights stacked over ``n_layers``."""
    nh = d_in // headdim
    conv_ch = d_in + 2 * n_state  # x, B, C all pass through the causal conv
    proj_out = 2 * d_in + 2 * n_state + nh  # z, x, B, C, dt
    L = n_layers
    return {
        "pre_norm": TensorSpec((L, d), ("layers", "embed"), "ones"),
        "in_proj": TensorSpec((L, d, proj_out), ("layers", "embed", "mlp"),
                              "normal", scale=d ** -0.5),
        "conv_w": TensorSpec((L, conv_width, conv_ch), ("layers", None, "mlp"),
                             "normal", scale=conv_width ** -0.5),
        "conv_b": TensorSpec((L, conv_ch), ("layers", "mlp"), "zeros"),
        "a_log": TensorSpec((L, nh), ("layers", None), "ones"),
        "dt_bias": TensorSpec((L, nh), ("layers", None), "zeros"),
        "d_skip": TensorSpec((L, nh), ("layers", None), "ones"),
        "norm": TensorSpec((L, d_in), ("layers", "mlp"), "ones"),
        "out_proj": TensorSpec((L, d_in, d), ("layers", "mlp", "embed"),
                               "normal", scale=d_in ** -0.5),
    }


def ssd_reference(x, dt, a_neg, B, C, init_state=None):
    """Sequential per-token oracle (tests only)."""
    b, S, h, p = x.shape
    n = B.shape[-1]
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for t in range(S):
        y, state = ssd_decode_step(state, x[:, t], dt[:, t], a_neg, B[:, t],
                                   C[:, t])
        ys.append(y)
    return torch.stack(ys, 1), state


def ssd_decode_step(state, x_t, dt_t, a_neg, B_t, C_t):
    """One-token recurrence. state [b,h,p,n]; x_t [b,h,p]; dt_t [b,h];
    B_t, C_t [b,n]."""
    dec = torch.exp(dt_t * a_neg[None, :])
    upd = torch.einsum("bhp,bn->bhpn", (x_t * dt_t[..., None]).float(),
                       B_t.float())
    state = state * dec[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state, C_t.float())
    return y, state


def causal_conv(x, w, b):
    """Depthwise causal conv. x [B, S, Ch]; w [W, Ch]; returns [B, S, Ch]."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = sum(xp[:, i:i + S] * w[i][None, None] for i in range(W))
    return out + b[None, None]


def causal_conv_step(conv_state, x_t, w, b):
    """conv_state [B, W-1, Ch] (previous inputs); x_t [B, Ch].  The window
    takes the promoted type of the two, as ``jnp.concatenate`` does."""
    dt = torch.promote_types(conv_state.dtype, x_t.dtype)
    window = torch.cat([conv_state.to(dt), x_t[:, None].to(dt)], 1)
    y = torch.einsum("bwc,wc->bc", window, w) + b[None]
    return y, window[:, 1:]


def _gated_out(p, y, xh, z, dtype):
    """Skip term in fp32, one cast, the gate, the gated RMS norm and the
    output projection (shared by prefill and decode)."""
    d_in = p["out_proj"].shape[0]
    y = y + xh.float() * p["d_skip"].float()[..., :, None]
    y = y.reshape(y.shape[:-2] + (d_in,)).to(dtype) * F.silu(z)
    y = ops.rmsnorm(y.contiguous(), p["norm"], eps=1e-6)
    return y @ p["out_proj"].to(dtype)


def _in_proj(p, x, n_state: int):
    """Pre-norm and input projection, split into z, the conv input
    (x, B, C) and dt."""
    d_in = p["out_proj"].shape[0]
    nh = p["a_log"].shape[0]
    xn = ops.rmsnorm(x, p["pre_norm"], eps=1e-6)
    proj = xn @ p["in_proj"].to(x.dtype)
    z, conv_in, dt = torch.split(proj, [d_in, d_in + 2 * n_state, nh], -1)
    return z, conv_in, dt


def mamba2_forward(p, x, *, n_state: int, headdim: int, chunk: int = 256,
                   init=None):
    """One mamba2 layer (p has no leading L dim). x [B, S, d] -> [B, S, d].

    init: None or (conv_state [B, W-1, Ch], ssm_state [B,h,p,n]) for
    chunked continuation.  Returns (y, (conv_state, ssm_state)); S past
    ``chunk`` must be a multiple of it (ValueError otherwise).
    """
    Bsz, S, _ = x.shape
    d_in = p["out_proj"].shape[0]
    nh = p["a_log"].shape[0]
    z, conv_in, dt = _in_proj(p, x, n_state)
    W = p["conv_w"].shape[0]
    w, b = p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype)
    if init is None:
        conv_out = causal_conv(conv_in, w, b)
        conv_state = conv_in[:, -(W - 1):]
    else:  # exact continuation from a carried conv window
        padded = torch.cat([init[0].to(x.dtype), conv_in], 1)
        conv_out = sum(padded[:, i:i + S] * w[i][None, None]
                       for i in range(W)) + b[None, None]
        conv_state = padded[:, -(W - 1):]
    conv_out = F.silu(conv_out)
    xi, Bc, Cc = torch.split(conv_out, [d_in, n_state, n_state], -1)
    dt = F.softplus(dt.float() + p["dt_bias"].float()[None, None])
    a_neg = -torch.exp(p["a_log"].float())
    xh = xi.reshape(Bsz, S, nh, headdim)
    y, ssm_state = ops.ssd_scan(
        xh.contiguous(), dt.contiguous(), a_neg, Bc.contiguous(),
        Cc.contiguous(), chunk=min(chunk, S),
        init_state=None if init is None else init[1].float().contiguous())
    return _gated_out(p, y, xh, z, x.dtype), (conv_state, ssm_state)


def mamba2_decode(p, x_t, conv_state, ssm_state, *, n_state: int,
                  headdim: int):
    """One-token step. x_t [B, d] -> (y [B, d], new states)."""
    Bsz, _ = x_t.shape
    d_in = p["out_proj"].shape[0]
    nh = p["a_log"].shape[0]
    z, conv_in, dt = _in_proj(p, x_t, n_state)
    conv_out, conv_state = causal_conv_step(
        conv_state, conv_in, p["conv_w"].to(x_t.dtype),
        p["conv_b"].to(x_t.dtype))
    conv_out = F.silu(conv_out)
    xi, Bc, Cc = torch.split(conv_out, [d_in, n_state, n_state], -1)
    dt = F.softplus(dt.float() + p["dt_bias"].float()[None])
    a_neg = -torch.exp(p["a_log"].float())
    xh = xi.reshape(Bsz, nh, headdim)
    y, ssm_state = ssd_decode_step(ssm_state, xh, dt, a_neg, Bc, Cc)
    return _gated_out(p, y, xh, z, x_t.dtype), conv_state, ssm_state
