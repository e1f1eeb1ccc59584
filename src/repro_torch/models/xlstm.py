"""xLSTM blocks (port of ``repro/models/xlstm.py``): the mLSTM (matrix
memory, chunkwise-parallel over a prompt, one recurrence step a decode
token) and the sLSTM (scalar memory, a recurrent scan over time).

Per-head dims: dk = dv = d_in / nh for the mLSTM, d / nh for the sLSTM.
Gates and the recurrent states (the mLSTM's ``C``, ``n``, ``m``, the
sLSTM's ``c``, ``n``, ``m``, ``h``) are fp32; q, k and v stay in the
activation type, and every product of the cell takes them widened to fp32
(the JAX package's ``preferred_element_type=float32`` on bf16 operands:
bf16 values are exact in fp32, so with TF32 off the products are the
same).  The mLSTM state is stored max-stabilized: C_tilde = C_true *
exp(-m).  Every RMS norm of the blocks runs through ``ops.rmsnorm`` (the
RMSNorm kernel on the card, its plain version on the CPU) with eps 1e-6.
Neither package has a kernel for the cells themselves: they are plain
torch here as they are plain jnp there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.mamba2 import causal_conv, causal_conv_step
from repro_torch.nn.spec import TensorSpec

NEG_INF = -1e30


# --------------------------------------------------------------------- specs


def mlstm_spec(n_stack: tuple, d: int, d_in: int, nh: int, conv_width: int):
    """mLSTM weights under the leading stack dims ``n_stack`` (e.g.
    (groups, per_group))."""
    L = tuple(n_stack)
    ax = tuple(["layers"] + [None] * (len(L) - 1))

    def t(shape, axes, init="normal", scale=None):
        return TensorSpec(L + shape, ax + axes, init, scale)

    return {
        "norm": t((d,), ("embed",), "ones"),
        "up_x": t((d, d_in), ("embed", "mlp"), scale=d ** -0.5),
        "up_z": t((d, d_in), ("embed", "mlp"), scale=d ** -0.5),
        "conv_w": t((conv_width, d_in), (None, "mlp"),
                    scale=conv_width ** -0.5),
        "conv_b": t((d_in,), ("mlp",), "zeros"),
        "wq": t((d_in, d_in), ("mlp", "heads"), scale=d_in ** -0.5),
        "wk": t((d_in, d_in), ("mlp", "heads"), scale=d_in ** -0.5),
        "wv": t((d_in, d_in), ("mlp", "heads"), scale=d_in ** -0.5),
        "w_i": t((d_in, nh), ("mlp", None), scale=d_in ** -0.5),
        "w_f": t((d_in, nh), ("mlp", None), scale=d_in ** -0.5),
        "b_i": t((nh,), (None,), "zeros"),
        "b_f": t((nh,), (None,), "ones"),  # bias toward remembering
        "out_norm": t((d_in,), ("mlp",), "ones"),
        "down": t((d_in, d), ("mlp", "embed"), scale=d_in ** -0.5),
    }


def slstm_spec(n_stack: tuple, d: int, nh: int):
    """sLSTM weights (cell, out norm and the gated FFN of pf 4/3) under the
    leading stack dims ``n_stack``."""
    L = tuple(n_stack)
    ax = tuple(["layers"] + [None] * (len(L) - 1))
    dh = d // nh
    ff = int(d * 4 / 3)

    def t(shape, axes, init="normal", scale=None):
        return TensorSpec(L + shape, ax + axes, init, scale)

    return {
        "norm": t((d,), ("embed",), "ones"),
        "w": t((d, 4 * d), ("embed", "mlp"), scale=d ** -0.5),  # z,i,f,o
        "r": t((nh, dh, 4 * dh), (None, "heads", "mlp"), scale=dh ** -0.5),
        "b": t((4 * d,), ("mlp",), "zeros"),
        "out_norm": t((d,), ("embed",), "ones"),
        "up_gate": t((d, ff), ("embed", "mlp"), scale=d ** -0.5),
        "up": t((d, ff), ("embed", "mlp"), scale=d ** -0.5),
        "down": t((ff, d), ("mlp", "embed"), scale=(d * 4 / 3) ** -0.5),
    }


# --------------------------------------------------------------------- mLSTM


def _rms(x, scale):
    """The blocks' RMS norm (eps 1e-6): fp32 statistics and scale, one
    cast back to x's type."""
    return ops.rmsnorm(x.contiguous(), scale, eps=1e-6)


def _zero_state(b, h, dk, dv, device):
    return (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=device),
            torch.zeros((b, h, dk), dtype=torch.float32, device=device),
            torch.zeros((b, h), dtype=torch.float32, device=device))


def mlstm_chunkwise(q, k, v, ilog, flog, *, chunk: int, init=None):
    """Stabilized chunkwise mLSTM.

    q, k, v [b, S, h, dk]; ilog, flog [b, S, h] (log input gate, log
    forget gate).  Returns (h [b, S, h, dv] in q's type, (C [b, h, dk,
    dv], n [b, h, dk], m [b, h]) fp32).  S must be a multiple of
    ``chunk`` (ValueError otherwise; the JAX package asserts it).  Within
    a chunk the masked log-decay matrix takes ``NEG_INF`` (-1e30, not
    -inf) above the diagonal; the denominator is max(|q.n|, exp(-m)).
    """
    b, S, h, dk = q.shape
    dv = v.shape[-1]
    if chunk < 1 or S % chunk:
        raise ValueError(f"mlstm_chunkwise: {S} tokens do not split into "
                         f"whole chunks of {chunk}")
    nc = S // chunk
    scale = dk ** -0.5
    qc, kc, vc = (t.float().reshape(b, nc, chunk, h, -1) for t in (q, k, v))
    ic = ilog.float().reshape(b, nc, chunk, h).transpose(2, 3)  # [b,nc,h,Q]
    fc = flog.float().reshape(b, nc, chunk, h).transpose(2, 3)
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                device=q.device))
    C, n, m = (_zero_state(b, h, dk, dv, q.device) if init is None
               else init)
    outs = []
    for c in range(nc):
        q_k, k_k, v_k = qc[:, c], kc[:, c], vc[:, c]  # [b,Q,h,d]
        i_k, f_k = ic[:, c], fc[:, c]  # [b,h,Q]
        bcum = torch.cumsum(f_k, -1)
        # log decay matrix D[t, j] = bcum[t] - bcum[j] + i[j], j <= t
        Dlog = torch.where(tri, bcum[..., :, None] - bcum[..., None, :]
                           + i_k[..., None, :], NEG_INF)  # [b,h,Q,Q]
        inter_log = bcum + m[..., None]  # [b,h,Q]
        m_t = torch.maximum(Dlog.amax(-1), inter_log)  # stabilizer
        W = torch.exp(Dlog - m_t[..., None])  # decay weights
        S_mat = torch.einsum("bqhd,bkhd->bhqk", q_k, k_k) * scale * W
        inter_w = torch.exp(inter_log - m_t)  # [b,h,Q]
        iw_q = inter_w.transpose(1, 2)  # [b,Q,h]
        num = torch.einsum("bhqk,bkhd->bqhd", S_mat, v_k)
        num = num + torch.einsum("bqhd,bhde->bqhe", q_k, C) \
            * iw_q[..., None] * scale
        # stabilized normalizer vector (decayed sum of k's)
        n_t = torch.einsum("bhqk,bkhd->bqhd", W, k_k)
        n_t = n_t + n[:, None] * iw_q[..., None]
        qn = torch.einsum("bqhd,bqhd->bqh", q_k, n_t) * scale
        denom = torch.maximum(qn.abs(), torch.exp(-m_t.transpose(1, 2)))
        outs.append(num / denom[..., None])
        # end-of-chunk state update
        b_Q = bcum[..., -1:]  # [b,h,1]
        decay = b_Q - bcum + i_k  # [b,h,Q] log weight of each key at the end
        m_new = torch.maximum(b_Q[..., 0] + m, decay.amax(-1))
        carry_w = torch.exp(b_Q[..., 0] + m - m_new)  # [b,h]
        in_w = torch.exp(decay - m_new[..., None]).transpose(1, 2)  # [b,Q,h]
        C = C * carry_w[..., None, None] + torch.einsum(
            "bqhd,bqhe->bhde", k_k * in_w[..., None], v_k)
        n = n * carry_w[..., None] + torch.einsum("bqhd,bqh->bhd", k_k, in_w)
        m = m_new
    h_out = torch.stack(outs, 1).reshape(b, S, h, dv)
    return h_out.to(q.dtype), (C, n, m)


def mlstm_decode_step(state, q_t, k_t, v_t, ilog_t, flog_t):
    """One token. q/k/v [b, h, d]; gates [b, h]; state = (C, n, m)
    stabilized.  Returns (h [b, h, dv] in q's type, new state)."""
    C, n, m = state
    scale = q_t.shape[-1] ** -0.5
    qf, kf, vf = q_t.float(), k_t.float(), v_t.float()
    m_new = torch.maximum(flog_t + m, ilog_t)
    fw = torch.exp(flog_t + m - m_new)
    iw = torch.exp(ilog_t - m_new)
    C = C * fw[..., None, None] + iw[..., None, None] * torch.einsum(
        "bhd,bhe->bhde", kf, vf)
    n = n * fw[..., None] + iw[..., None] * kf
    num = torch.einsum("bhd,bhde->bhe", qf, C) * scale
    qn = torch.einsum("bhd,bhd->bh", qf, n) * scale
    denom = torch.maximum(qn.abs(), torch.exp(-m_new))
    return (num / denom[..., None]).to(q_t.dtype), (C, n, m_new)


def mlstm_reference(q, k, v, ilog, flog, init=None):
    """Sequential oracle (tests only): ``mlstm_decode_step`` token by
    token."""
    b, S, h, dk = q.shape
    state = (_zero_state(b, h, dk, v.shape[-1], q.device) if init is None
             else init)
    outs = []
    for t in range(S):
        o, state = mlstm_decode_step(state, q[:, t], k[:, t], v[:, t],
                                     ilog[:, t], flog[:, t])
        outs.append(o)
    return torch.stack(outs, 1), state


# --------------------------------------------------------------------- block
# applies (params WITHOUT leading stack dims)


def _gates(p, c):
    """fp32 log input and log forget gates [.., nh] from the conv output."""
    cf = c.float()
    ilog = cf @ p["w_i"].float() + p["b_i"].float()
    flog = F.logsigmoid(cf @ p["w_f"].float() + p["b_f"].float())
    return ilog, flog


def mlstm_block(p, x, *, nh: int, chunk: int = 256, init=None,
                gather_qkv: bool = False):
    """x [B, S, d] -> (x + y, (conv_state [B, min(S, W-1), d_in],
    (C, n, m))).  Pre-norm residual block: up-projections, causal conv
    (from zeros, or continuing ``init``'s conv window), q/k/v, gates, the
    chunkwise cell over chunks of min(chunk, S), the out norm gated by
    silu(z), the down-projection.  ``gather_qkv`` is a sharding
    constraint in the JAX package (replicate the conv output before the
    q/k/v projections); on one device it changes nothing, and it is
    accepted for the config's sake."""
    B, S, d = x.shape
    dt = x.dtype
    d_in = p["up_x"].shape[-1]
    dh = d_in // nh
    xn = _rms(x, p["norm"])
    u = xn @ p["up_x"].to(dt)
    z = xn @ p["up_z"].to(dt)
    W = p["conv_w"].shape[0]
    w, bias = p["conv_w"].to(dt), p["conv_b"].to(dt)
    if init is None:
        c = causal_conv(u, w, bias)
        conv_state = u[:, -(W - 1):]
    else:
        padded = torch.cat([init[0].to(dt), u], 1)
        c = sum(padded[:, i:i + S] * w[i][None, None]
                for i in range(W)) + bias[None, None]
        conv_state = padded[:, -(W - 1):]
    c = F.silu(c)
    q = (c @ p["wq"].to(dt)).reshape(B, S, nh, dh)
    k = (c @ p["wk"].to(dt)).reshape(B, S, nh, dh)
    v = (u @ p["wv"].to(dt)).reshape(B, S, nh, dh)
    ilog, flog = _gates(p, c)
    h, mstate = mlstm_chunkwise(q, k, v, ilog, flog, chunk=min(chunk, S),
                                init=None if init is None else init[1])
    h = _rms(h.reshape(B, S, d_in), p["out_norm"]) * F.silu(z)
    return x + h @ p["down"].to(dt), (conv_state, mstate)


def mlstm_block_decode(p, x_t, state, *, nh: int):
    """x_t [B, d]; state = (conv_state [B, W-1, d_in], (C, n, m)).  The
    conv window comes back in the promoted type of the state and x_t, as
    ``causal_conv_step`` returns it."""
    B, d = x_t.shape
    dt = x_t.dtype
    d_in = p["up_x"].shape[-1]
    dh = d_in // nh
    conv_state, mstate = state
    xn = _rms(x_t, p["norm"])
    u = xn @ p["up_x"].to(dt)
    z = xn @ p["up_z"].to(dt)
    c, conv_state = causal_conv_step(conv_state, u, p["conv_w"].to(dt),
                                     p["conv_b"].to(dt))
    c = F.silu(c)
    q = (c @ p["wq"].to(dt)).reshape(B, nh, dh)
    k = (c @ p["wk"].to(dt)).reshape(B, nh, dh)
    v = (u @ p["wv"].to(dt)).reshape(B, nh, dh)
    ilog, flog = _gates(p, c)
    h, mstate = mlstm_decode_step(mstate, q, k, v, ilog, flog)
    h = _rms(h.reshape(B, d_in), p["out_norm"]) * F.silu(z)
    return x_t + h @ p["down"].to(dt), (conv_state, mstate)


# --------------------------------------------------------------------- sLSTM


def slstm_cell_step(state, gates, nh: int):
    """state = (c, n, m, h) each [B, d] fp32; gates [B, 4d] pre-activation
    (W x + R h_prev + b), split z, i, f, o.  ``nh`` is unused, as in the
    JAX cell."""
    c, n, m, _ = state
    zr, ir, fr, orr = gates.float().chunk(4, -1)
    z = torch.tanh(zr)
    o = torch.sigmoid(orr)
    flog = F.logsigmoid(fr)
    m_new = torch.maximum(flog + m, ir)
    fw = torch.exp(flog + m - m_new)
    iw = torch.exp(ir - m_new)
    c = fw * c + iw * z
    n = fw * n + iw
    return (c, n, m_new, o * (c / n.clamp(min=1e-6)))


def _recurrent(p, h, nh: int):
    """R h_prev, block-diagonal per head, reordered to the gates' (z, i,
    f, o) layout: h [B, d] fp32 -> [B, 4d] fp32."""
    B, d = h.shape
    dh = d // nh
    rec = torch.einsum("bhd,hde->bhe", h.reshape(B, nh, dh),
                       p["r"].float())  # [B, nh, 4dh]
    return rec.reshape(B, nh, 4, dh).transpose(1, 2).reshape(B, 4 * d)


def slstm_scan(p, x, *, nh: int, init=None):
    """Sequential sLSTM over time. x [B, S, d] -> (h [B, S, d] fp32,
    state).  ``x @ w + b`` is formed in x's type, then widened to fp32
    before the recurrent term is added."""
    B, S, d = x.shape
    wx = x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)  # [B, S, 4d]
    if init is None:
        zero = torch.zeros((B, d), dtype=torch.float32, device=x.device)
        init = (zero, zero, zero, zero)
    state = init
    hs = []
    for t in range(S):
        state = slstm_cell_step(
            state, wx[:, t].float() + _recurrent(p, state[3], nh), nh)
        hs.append(state[3])
    return torch.stack(hs, 1), state


def _slstm_out(p, x, h):
    """Out norm and residual, then the gated FFN (pf 4/3), whose pre-norm
    reuses ``p["norm"]`` (the JAX block has no second norm leaf)."""
    dt = x.dtype
    y = x + _rms(h.to(dt), p["out_norm"])
    yn = _rms(y, p["norm"])
    g = F.silu(yn @ p["up_gate"].to(dt)) * (yn @ p["up"].to(dt))
    return y + g @ p["down"].to(dt)


def slstm_block(p, x, *, nh: int, init=None):
    """x [B, S, d] -> (y, (c, n, m, h) [B, d] fp32)."""
    h, state = slstm_scan(p, _rms(x, p["norm"]), nh=nh, init=init)
    return _slstm_out(p, x, h), state


def slstm_block_decode(p, x_t, state, *, nh: int):
    """x_t [B, d]; state = (c, n, m, h) [B, d] fp32."""
    xn = _rms(x_t, p["norm"])
    wx = xn @ p["w"].to(x_t.dtype) + p["b"].to(x_t.dtype)
    state = slstm_cell_step(state, wx.float() + _recurrent(p, state[3], nh),
                            nh)
    return _slstm_out(p, x_t, state[3]), state
