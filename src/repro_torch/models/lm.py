"""Attention-family decoder stack (port of the dense subset of
``repro/models/lm.py``): parameter specs, embedding, norms, the attention
and MLP sub-blocks, per-layer windows, rope tables and the logits head.

Parameters are a plain dict with the JAX tree's keys; per-layer leaves are
stacked on dim 0.  Norms accumulate in fp32 (RMS norms through the fused
RMSNorm kernel on the card); matmuls run in the activation dtype, with
weights cast at the use site as in the JAX package.  Whole-prompt attention
runs the flash-attention kernel on the card.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.models.attention import flash_attention
from repro_torch.nn.layers import apply_rope, rope_frequencies
from repro_torch.nn.spec import TensorSpec

Tree = Any

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def act_dtype(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.act_dtype]


# ------------------------------------------------------------------ helpers


def embed_tokens(cfg: ArchConfig, params, tokens):
    """Token-table lookup in the activation dtype (+ gemma embed scale)."""
    dt = act_dtype(cfg)
    x = params["embed"]["table"][tokens].to(dt)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    return x


def embed_inputs(cfg: ArchConfig, params, tokens, embeds=None,
                 embed_mask=None):
    """Token lookup (ids clamped to 0) plus optional embedding-span
    injection: masked positions take the ``embeds`` row as it is."""
    x = embed_tokens(cfg, params, tokens.clamp(min=0))
    if embeds is not None:
        x = torch.where(embed_mask[..., None], embeds.to(x.dtype), x)
    return x


def _norm(p, x, kind: str, prefix: str):
    """The layer's norm: ``rmsnorm``/``rmsnorm_zero`` through the fused
    RMSNorm kernel (its plain version on the CPU), ``layernorm`` plain
    (the JAX package has no Pallas layernorm)."""
    if kind == "layernorm":
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + 1e-5)
        return (y * p[prefix + "_s"].float()
                + p[prefix + "_b"].float()).to(x.dtype)
    return rmsnorm(x, p[prefix + "_s"], eps=1e-6,
                   zero_centered=kind == "rmsnorm_zero")


def _norm_spec(L, dim, kind, prefix):
    stack = (L,) if L else ()
    ax = ("layers",) if L else ()
    init = "zeros" if kind == "rmsnorm_zero" else "ones"
    out = {prefix + "_s": TensorSpec(stack + (dim,), ax + ("embed",), init)}
    if kind == "layernorm":
        out[prefix + "_b"] = TensorSpec(stack + (dim,), ax + ("embed",),
                                        "zeros")
    return out


def _head_rms(x, scale):
    """Per-head qk-norm, the same function as the rmsnorm kernel's per
    row of Dh. x [..., Dh], scale [Dh]."""
    return rmsnorm(x, scale, eps=1e-6)


def _act(name):
    if name == "silu_glu":
        return F.silu
    if name == "gelu_glu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(name)


def _attn_out(pl_attn, cfg: ArchConfig, o, dt):
    """Attention output projection ``o @ wo``."""
    return o @ pl_attn["wo"].to(dt)


# ---------------------------------------------------------------- specs


def attn_spec(cfg: ArchConfig, L: int, d: int):
    """Attention weights stacked over L layers."""
    stack = (L,) if L else ()
    ax = ("layers",) if L else ()
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    sc = d ** -0.5
    p = {
        "wq": TensorSpec(stack + (d, H * Dh), ax + ("embed", "heads"),
                         "normal", sc),
        "wk": TensorSpec(stack + (d, Hkv * Dh), ax + ("embed", "kv_heads"),
                         "normal", sc),
        "wv": TensorSpec(stack + (d, Hkv * Dh), ax + ("embed", "kv_heads"),
                         "normal", sc),
        "wo": TensorSpec(stack + (H * Dh, cfg.d_model),
                         ax + ("heads", "embed"), "normal",
                         (H * Dh) ** -0.5),
    }
    if cfg.qkv_bias:
        p["bq"] = TensorSpec(stack + (H * Dh,), ax + ("heads",), "zeros")
        p["bk"] = TensorSpec(stack + (Hkv * Dh,), ax + ("kv_heads",), "zeros")
        p["bv"] = TensorSpec(stack + (Hkv * Dh,), ax + ("kv_heads",), "zeros")
    if cfg.qk_norm:
        p["qn"] = TensorSpec(stack + (Dh,), ax + (None,), "ones")
        p["kn"] = TensorSpec(stack + (Dh,), ax + (None,), "ones")
    return p


def mlp_spec(cfg: ArchConfig, L: int, d: int, ff: int):
    """Gated MLP weights (the dense attention family's only MLP form)."""
    stack = (L,) if L else ()
    ax = ("layers",) if L else ()
    sc, sc2 = d ** -0.5, ff ** -0.5
    return {
        "w_gate": TensorSpec(stack + (d, ff), ax + ("embed", "mlp"),
                             "normal", sc),
        "w_up": TensorSpec(stack + (d, ff), ax + ("embed", "mlp"),
                           "normal", sc),
        "w_down": TensorSpec(stack + (ff, d), ax + ("mlp", "embed"),
                             "normal", sc2),
    }


def build_spec(cfg: ArchConfig) -> Tree:
    """Spec tree of a dense attention-family decoder."""
    if cfg.block_kind != "attn" or cfg.cross_attention or cfg.n_experts \
            or cfg.act == "gelu":
        raise NotImplementedError(
            f"{cfg.name}: the port covers dense attention-family decoders "
            "only (MoE, recurrent, hybrid and encoder-decoder families are "
            "ROADMAP queue 1 items 10-11)")
    d, V, L = cfg.d_model, cfg.vocab, cfg.n_layers
    spec: dict = {"embed": {"table": TensorSpec((V, d), ("vocab", "embed"),
                                                "embed", scale=d ** -0.5)}}
    spec.update(_norm_spec(0, d, cfg.norm, "final"))
    if not cfg.tie_embeddings:
        spec["lm_head"] = TensorSpec((d, V), ("embed", "vocab"), "normal",
                                     scale=d ** -0.5)
    layer = {}
    layer.update(_norm_spec(L, d, cfg.norm, "ln1"))
    layer.update(_norm_spec(L, d, cfg.norm, "ln2"))
    if cfg.post_norms:
        layer.update(_norm_spec(L, d, cfg.norm, "pn1"))
        layer.update(_norm_spec(L, d, cfg.norm, "pn2"))
    layer["attn"] = attn_spec(cfg, L, d)
    layer["mlp"] = mlp_spec(cfg, L, d, cfg.d_ff)
    spec["layers"] = layer
    return spec


# --------------------------------------------------------------- layer flags


def static_layer_windows(cfg: ArchConfig):
    """Per-layer ``is_global`` flags: under the local:global pattern the
    last layer of each ``global_every`` group is global and a ragged tail
    is local; otherwise every layer is global (full causal attention)."""
    L = cfg.n_layers
    if cfg.attn_pattern == "local_global" and cfg.global_every:
        return [((i % cfg.global_every) == cfg.global_every - 1)
                for i in range(L)]
    return [True] * L


def _rope_tables(cfg: ArchConfig, max_len: int, device=None):
    """Returns (rope_local, rope_global); identical unless the arch uses a
    different theta for global layers (gemma3)."""
    cos_l, sin_l = rope_frequencies(cfg.hd, max_len, cfg.rope_theta,
                                    device=device)
    if cfg.rope_theta_global:
        cos_g, sin_g = rope_frequencies(cfg.hd, max_len,
                                        cfg.rope_theta_global, device=device)
    else:
        cos_g, sin_g = cos_l, sin_l
    return (cos_l, sin_l), (cos_g, sin_g)


# -------------------------------------------------------- attention sub-block


def _qkv(pl, cfg, xn, B, S):
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = xn.dtype
    q = xn @ pl["wq"].to(dt)
    k = xn @ pl["wk"].to(dt)
    v = xn @ pl["wv"].to(dt)
    if "bq" in pl:
        q = q + pl["bq"].to(dt)
        k = k + pl["bk"].to(dt)
        v = v + pl["bv"].to(dt)
    q = q.reshape(B, S, H, Dh)
    k = k.reshape(B, S, Hkv, Dh)
    v = v.reshape(B, S, Hkv, Dh)
    if "qn" in pl:
        q = _head_rms(q, pl["qn"])
        k = _head_rms(k, pl["kn"])
    return q, k, v


def _mlp(pl, cfg, xn):
    dt = xn.dtype
    act = _act(cfg.act)
    h = act(xn @ pl["w_gate"].to(dt)) * (xn @ pl["w_up"].to(dt))
    return h @ pl["w_down"].to(dt)


def _ffn(pl, cfg, x):
    """Dense MLP sub-block with residual, on [B, S, d]."""
    if cfg.n_experts:
        raise NotImplementedError("MoE layers are ROADMAP queue 1 item 10")
    y = _mlp(pl["mlp"], cfg, _norm(pl, x, cfg.norm, "ln2"))
    if cfg.post_norms:
        y = _norm(pl, y, cfg.norm, "pn2")
    return x + y


# ------------------------------------------------------ monolithic forward


def _attn_layer(cfg: ArchConfig, pl, x, rope, window: int, positions):
    """One layer over a whole prompt (forward only): causal attention over
    the prompt's own K/V (the flash-attention kernel on the card).
    Returns (x, (k, v)), the K/V already rope'd, as the cache stores
    them."""
    cos, sin = rope
    B, S, _ = x.shape
    xn = _norm(pl, x, cfg.norm, "ln1")
    q, k, v = _qkv(pl["attn"], cfg, xn, B, S)
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    o = flash_attention(q, k, v, window=window)
    o = _attn_out(pl["attn"], cfg, o.reshape(B, S, -1), x.dtype)
    if cfg.post_norms:
        o = _norm(pl, o, cfg.norm, "pn1")
    return _ffn(pl, cfg, x + o), (k, v)


def attn_forward(cfg: ArchConfig, params, tokens, *, return_cache=False):
    """tokens [B, S] -> final-normed hidden [B, S, d], plus the stacked
    cache (k, v) [L, B, S, Hkv, Dh] with ``return_cache``.  Layers walk in
    order, each with its window from ``static_layer_windows``."""
    B, S = tokens.shape
    x = embed_inputs(cfg, params, tokens)
    positions = torch.arange(S, device=tokens.device)
    rope_l, rope_g = _rope_tables(cfg, S, tokens.device)
    ks, vs = [], []
    for i, is_global in enumerate(static_layer_windows(cfg)):
        pl = layer_slice(params["layers"], i)
        x, (k, v) = _attn_layer(cfg, pl, x, rope_g if is_global else rope_l,
                                0 if is_global else cfg.window, positions)
        ks.append(k)
        vs.append(v)
    x = _norm(params, x, cfg.norm, "final")
    return (x, (torch.stack(ks), torch.stack(vs))) if return_cache else x


def layer_slice(tree, i: int):
    """Layer ``i`` of a layer-stacked parameter dict (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def last_hidden(h, length=None):
    """The true last-token hidden state of a (possibly padded) batch:
    h [B, S, d]; ``length`` [B] true lengths, or None for ``h[:, -1]``."""
    if length is None:
        return h[:, -1]
    return h[torch.arange(h.shape[0], device=h.device), length.long() - 1]


def prompt_pos_map(length, S: int):
    """pos_map rows [B, S] int32 for bucket-padded prompts: the position
    for the first ``length`` entries, -1 (empty, masked) for the padding."""
    pos = torch.arange(S, dtype=torch.int32, device=length.device)[None]
    return torch.where(pos < length[:, None], pos, -1).to(torch.int32)


# ------------------------------------------------------------------ head


def last_logits(cfg: ArchConfig, params, hidden_last):
    """hidden_last [..., d] -> [..., V] fp32 logits (tied head, softcap)."""
    head = (params["embed"]["table"].T if cfg.tie_embeddings
            else params["lm_head"])
    logits = (hidden_last @ head.to(hidden_last.dtype)).float()
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits
