"""The model zoo's stacks (ports of ``repro/models/lm.py``): parameter
specs, embedding, norms, the attention and MLP or MoE sub-blocks,
per-layer windows, rope tables and the logits head of the attention
family (dense and MoE); zamba2's Mamba2 groups with their shared
attention+MLP block; xlstm's groups of mLSTM blocks and one sLSTM block;
whisper's encoder over precomputed frame embeddings and its decoder with
cross-attention.

Parameters are a plain dict with the JAX tree's keys; per-layer leaves are
stacked on dim 0.  Norms accumulate in fp32 (RMS norms through the fused
RMSNorm kernel on the card); matmuls run in the activation dtype, with
weights cast at the use site as in the JAX package, and every projection
whose weight tensor parallelism cuts by columns (q, k, v, o, the MLP's,
whisper's cross-attention) through the column-stable dense kernel
(``dense``); the LM head stays ``x @ w``.  Whole-prompt attention
(the decoders' causal attention, whisper's encoder and cross-attention)
runs the flash-attention kernel on the card.  Training
(``forward_hidden``, ``chunked_xent``, ``train_loss``) covers every family
of the zoo, as in the JAX package: under ``remat`` the attention family's
layers, zamba2's Mamba2 layers (not its shared block), xlstm's mLSTM
blocks (not its sLSTM blocks) and whisper's encoder and decoder layers are
recomputed in the backward, at the JAX package's ``jax.checkpoint``
boundaries.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import collectives as coll
from repro_torch.kernels.dense_matmul import dense_matmul
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_lib
from repro_torch.models import xlstm as xl
from repro_torch.models.attention import flash_attention
from repro_torch.nn.layers import apply_rope, rope_frequencies
from repro_torch.nn.spec import TensorSpec

Tree = Any

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float64": torch.float64}  # float64: references of fp32 runs


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


def _head_rms(x, scale, tp: int = 1):
    """Per-head qk-norm, the same function as the rmsnorm kernel's per
    row of Dh. x [..., Dh], scale [Dh]; ``tp``-sharded heads launch under
    the plan of all the heads' rows."""
    rows = x.numel() // x.shape[-1] * tp if tp > 1 else None
    return rmsnorm(x, scale, eps=1e-6, plan_rows=rows)


def _act(name):
    if name == "silu_glu":
        return F.silu
    if name in ("gelu_glu", "gelu"):  # jax.nn.gelu's default: the tanh form
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(name)


def tp_width(cfg: ArchConfig, part: str) -> int:
    """How many ranks split ``part`` (a ``tp_shards`` entry) of a
    tensor-parallel local config (``distributed/tp.py``), else 1.  A
    kernel that runs at a shard's shapes launches under the plan of the
    global width (``plan_*`` arguments), so that each rank computes its
    slice of the unsharded call's output bit for bit."""
    if cfg.tp_axis and part in cfg.tp_shards:
        return coll.axis_size(cfg.tp_axis)
    return 1


def dense(x, w, cfg: ArchConfig, part: str = ""):
    """``x @ w`` over x's last dim through the column-stable dense kernel
    (``kernels/dense_matmul.py``; its plain version on the CPU).  ``part``
    names the ``tp_shards`` entry that cuts w's columns: a rank holding
    1/tp of them launches under the plan of the global width, so that its
    product is those columns of the unsharded product bit for bit."""
    K, N = w.shape
    plan_n = N * tp_width(cfg, part) if part else None
    y = dense_matmul(x.reshape(-1, K).contiguous(), w, plan_n=plan_n)
    return y.reshape(x.shape[:-1] + (N,))


def _col_gathered(x, w, cfg: ArchConfig, dt, part: str):
    """``x @ w`` where ``x``'s last dim and ``w``'s output columns are
    both tensor-parallel (``part`` of ``tp_shards``): ``w`` holds the
    full contraction dim but 1/tp of the output columns.

    Two all-gathers, pure data movement, rebuild the replicated input and
    output around one local product over the full contraction, so every
    output element is a whole dot product computed on one rank.  The
    dense kernel under the global width's plan (``dense``) makes it the
    unsharded product's element bit for bit, as the JAX package assumes
    of XLA's dot.  A row-parallel product with a sum of partials would
    move less but rounds its split-K partial sums differently and flips
    greedy argmax on near-ties."""
    full = coll.all_gather(x, cfg.tp_axis, -1)
    return coll.all_gather(dense(full, w.to(dt), cfg, part), cfg.tp_axis,
                           -1)


def _attn_out(pl_attn, cfg: ArchConfig, o, dt):
    """Attention output projection ``o @ wo``.  Tensor-parallel heads hand
    in the local heads' outputs; wo holds all H*Dh rows but 1/tp of the
    d_model output columns (``_col_gathered``)."""
    if cfg.tp_axis and "heads" in cfg.tp_shards:
        return _col_gathered(o, pl_attn["wo"], cfg, dt, "heads")
    return dense(o, pl_attn["wo"].to(dt), cfg)


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
    """Gated MLP weights, or the plain MLP with biases of ``act="gelu"``
    (whisper)."""
    stack = (L,) if L else ()
    ax = ("layers",) if L else ()
    sc, sc2 = d ** -0.5, ff ** -0.5
    if cfg.act == "gelu":
        return {
            "w1": TensorSpec(stack + (d, ff), ax + ("embed", "mlp"),
                             "normal", sc),
            "b1": TensorSpec(stack + (ff,), ax + ("mlp",), "zeros"),
            "w2": TensorSpec(stack + (ff, d), ax + ("mlp", "embed"),
                             "normal", sc2),
            "b2": TensorSpec(stack + (d,), ax + ("embed",), "zeros"),
        }
    return {
        "w_gate": TensorSpec(stack + (d, ff), ax + ("embed", "mlp"),
                             "normal", sc),
        "w_up": TensorSpec(stack + (d, ff), ax + ("embed", "mlp"),
                           "normal", sc),
        "w_down": TensorSpec(stack + (ff, d), ax + ("mlp", "embed"),
                             "normal", sc2),
    }


def build_spec(cfg: ArchConfig) -> Tree:
    """Spec tree of ``cfg``'s family: an attention decoder (dense or MoE),
    the zamba2 hybrid, xlstm or whisper (JAX ``lm.py:build_spec``)."""
    d, V, L = cfg.d_model, cfg.vocab, cfg.n_layers
    spec: dict = {"embed": {"table": TensorSpec((V, d), ("vocab", "embed"),
                                                "embed", scale=d ** -0.5)}}
    spec.update(_norm_spec(0, d, cfg.norm, "final"))
    if not cfg.tie_embeddings:
        spec["lm_head"] = TensorSpec((d, V), ("embed", "vocab"), "normal",
                                     scale=d ** -0.5)
    if cfg.block_kind == "mamba_hybrid":
        spec.update(_zamba2_spec(cfg))
        return spec
    if cfg.block_kind == "xlstm":
        G, P = xlstm_groups(cfg)
        spec["mlstm"] = xl.mlstm_spec((G, P), d, int(cfg.proj_factor * d),
                                      cfg.n_heads, cfg.conv_width)
        spec["slstm"] = xl.slstm_spec((G,), d, cfg.n_heads)
        return spec
    if cfg.block_kind != "attn":
        raise ValueError(cfg.block_kind)
    if cfg.cross_attention:
        spec.update(_whisper_spec(cfg))
        return spec
    layer = {}
    layer.update(_norm_spec(L, d, cfg.norm, "ln1"))
    layer.update(_norm_spec(L, d, cfg.norm, "ln2"))
    if cfg.post_norms:
        layer.update(_norm_spec(L, d, cfg.norm, "pn1"))
        layer.update(_norm_spec(L, d, cfg.norm, "pn2"))
    layer["attn"] = attn_spec(cfg, L, d)
    if cfg.n_experts:
        layer["moe"] = moe_lib.moe_spec(L, d, cfg.n_experts, cfg.moe_ff,
                                        cfg.shared_ff)
    else:
        layer["mlp"] = mlp_spec(cfg, L, d, cfg.d_ff)
    spec["layers"] = layer
    return spec


def _whisper_spec(cfg: ArchConfig) -> Tree:
    """whisper's encoder layers, its final norm ``enc_final`` and the
    decoder layers with self- (``attn``) and cross-attention (``xattn``)
    and their norms ln1, lnx, ln2."""
    d, L, Le = cfg.d_model, cfg.n_layers, cfg.encoder_layers
    enc = {"attn": attn_spec(cfg, Le, d)}
    enc.update(_norm_spec(Le, d, cfg.norm, "ln1"))
    enc.update(_norm_spec(Le, d, cfg.norm, "ln2"))
    enc["mlp"] = mlp_spec(cfg, Le, d, cfg.d_ff)
    dec = {"attn": attn_spec(cfg, L, d), "xattn": attn_spec(cfg, L, d)}
    dec.update(_norm_spec(L, d, cfg.norm, "ln1"))
    dec.update(_norm_spec(L, d, cfg.norm, "lnx"))
    dec.update(_norm_spec(L, d, cfg.norm, "ln2"))
    dec["mlp"] = mlp_spec(cfg, L, d, cfg.d_ff)
    out = {"encoder": enc, "layers": dec}
    out.update(_norm_spec(0, d, cfg.norm, "enc_final"))
    return out


def _zamba2_spec(cfg: ArchConfig) -> Tree:
    """zamba2's Mamba2 leaves stacked as (groups, per) and the shared
    attention+MLP block, whose attention reads concat(x, x0) [2d]."""
    d = cfg.d_model
    groups, per = cfg.n_layers // cfg.shared_attn_every, cfg.shared_attn_every
    m = m2.mamba2_spec(cfg.n_layers, d, cfg.d_inner, cfg.ssm_state,
                       cfg.ssm_headdim, cfg.conv_width)
    mamba = {k: TensorSpec((groups, per) + s.shape[1:],
                           ("layers", None) + s.axes[1:], s.init, s.scale)
             for k, s in m.items()}
    shared_cfg = dataclasses.replace(cfg, qkv_bias=False, qk_norm=False)
    shared = {"attn": attn_spec(shared_cfg, 0, 2 * d)}
    shared.update(_norm_spec(0, 2 * d, cfg.norm, "ln1"))
    shared.update(_norm_spec(0, d, cfg.norm, "ln2"))
    shared["mlp"] = mlp_spec(cfg, 0, d, cfg.d_ff)
    return {"mamba": mamba, "shared_attn": shared}


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
    q = dense(xn, pl["wq"].to(dt), cfg, "heads")
    k = dense(xn, pl["wk"].to(dt), cfg, "kv_heads")
    v = dense(xn, pl["wv"].to(dt), cfg, "kv_heads")
    if "bq" in pl:
        q = q + pl["bq"].to(dt)
        k = k + pl["bk"].to(dt)
        v = v + pl["bv"].to(dt)
    q = q.reshape(B, S, H, Dh)
    k = k.reshape(B, S, Hkv, Dh)
    v = v.reshape(B, S, Hkv, Dh)
    if "qn" in pl:
        tp = tp_width(cfg, "heads")
        q = _head_rms(q, pl["qn"], tp)
        k = _head_rms(k, pl["kn"], tp)
    return q, k, v


def _mlp(pl, cfg, xn):
    dt = xn.dtype
    act = _act(cfg.act)
    tp = bool(cfg.tp_axis) and "mlp" in cfg.tp_shards
    if "w1" in pl:  # plain, with biases (whisper)
        h = act(dense(xn, pl["w1"].to(dt), cfg, "mlp") + pl["b1"].to(dt))
        if tp:  # b2 is replicated, added once to the gathered output
            return (_col_gathered(h, pl["w2"], cfg, dt, "mlp")
                    + pl["b2"].to(dt))
        return dense(h, pl["w2"].to(dt), cfg) + pl["b2"].to(dt)
    h = (act(dense(xn, pl["w_gate"].to(dt), cfg, "mlp"))
         * dense(xn, pl["w_up"].to(dt), cfg, "mlp"))
    if tp:
        return _col_gathered(h, pl["w_down"], cfg, dt, "mlp")
    return dense(h, pl["w_down"].to(dt), cfg)


def moe(pl, cfg, xt, dispatch_axes=None):
    """The layer's MoE block on the tokens xt [T, d] (``moe_lib.moe_apply``
    with the config's routing knobs)."""
    return moe_lib.moe_apply(pl["moe"], xt, top_k=cfg.top_k,
                             norm_topk=cfg.norm_topk,
                             capacity_factor=cfg.capacity_factor,
                             act=_act(cfg.act), dispatch_axes=dispatch_axes,
                             tp_axis=cfg.tp_axis, tp_shards=cfg.tp_shards)


def _ffn(pl, cfg, x):
    """MLP or MoE sub-block with residual, on [B, S, d].  The MoE block
    sees all B*S tokens at once (they compete for each expert's capacity)
    or, with ``moe_scan_chunks`` dividing them into chunks of at least
    4 * n_experts tokens, one chunk at a time."""
    B, S, d = x.shape
    xn = _norm(pl, x, cfg.norm, "ln2")
    if cfg.n_experts:
        xt = xn.reshape(B * S, d)
        nc = cfg.moe_scan_chunks
        if nc and (B * S) % nc == 0 and (B * S) // nc >= 4 * cfg.n_experts:
            y = torch.cat([moe(pl, cfg, t, cfg.moe_dispatch_axes)
                           for t in xt.reshape(nc, (B * S) // nc, d)])
        else:
            y = moe(pl, cfg, xt, cfg.moe_dispatch_axes)
        y = y.reshape(B, S, d)
    else:
        y = _mlp(pl["mlp"], cfg, xn)
    if cfg.post_norms:
        y = _norm(pl, y, cfg.norm, "pn2")
    return x + y


# ------------------------------------------------------ monolithic forward


def _attn_layer(cfg: ArchConfig, pl, x, rope, window: int, positions,
                pkv=None):
    """One layer over a whole prompt (forward only): causal attention over
    the prompt's own K/V (the flash-attention kernel on the card).

    ``pkv`` optionally carries this layer's already-rope'd prefix K/V
    [B, Spre, Hkv, Dh]: the suffix queries then attend to
    ``concat(prefix, suffix)`` with the causal diagonal shifted by Spre
    (the kernel's default query offset ``Sk - Sq``).  Returns (x, (k, v)),
    the suffix K/V only, already rope'd, as the cache stores them."""
    cos, sin = rope
    B, S, _ = x.shape
    xn = _norm(pl, x, cfg.norm, "ln1")
    q, k, v = _qkv(pl["attn"], cfg, xn, B, S)
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    ka, va = k, v
    if pkv is not None:
        ka = torch.cat([pkv[0].to(k.dtype), k], 1)
        va = torch.cat([pkv[1].to(v.dtype), v], 1)
    o = flash_attention(q, ka, va, window=window,
                        plan_heads=cfg.n_heads * tp_width(cfg, "heads"))
    o = _attn_out(pl["attn"], cfg, o.reshape(B, S, -1), x.dtype)
    if cfg.post_norms:
        o = _norm(pl, o, cfg.norm, "pn1")
    return _ffn(pl, cfg, x + o), (k, v)


def _stack_layers(tree, n: int) -> list:
    """The n layers of a stacked parameter dict: views from one ``unbind``
    a leaf where grad mode is on (``unbind_layers``), else slices."""
    if torch.is_grad_enabled():
        return unbind_layers(tree, n)
    return [layer_slice(tree, i) for i in range(n)]


def _remat(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are recomputed in the backward, with the same values bit
    for bit (the JAX package's ``jax.checkpoint``)."""
    return checkpoint(fn, *args, use_reentrant=False)


def attn_forward(cfg: ArchConfig, params, tokens, *, return_cache=False,
                 prefix_kv=None, embeds=None, embed_mask=None, remat=False):
    """tokens [B, S] -> final-normed hidden [B, S, d], plus the stacked
    cache (k, v) [L, B, S, Hkv, Dh] with ``return_cache``.  Layers walk in
    order, each with its window from ``static_layer_windows``.

    ``remat`` (training; the JAX package's ``jax.checkpoint`` of each
    layer, ``lm.py:420,452,462``) runs each layer under
    ``torch.utils.checkpoint.checkpoint`` (non-reentrant): its activations
    are recomputed in the backward instead of kept, with the same values
    bit for bit.  Where grad mode is on, the per-layer parameters are
    views from one ``unbind`` of each stacked leaf (``unbind_layers``), so
    a leaf's gradient is stacked once.

    ``prefix_kv = (k, v)`` [L, B, Spre, Hkv, Dh] makes this a suffix
    prefill: the S tokens sit at positions [Spre, Spre + S) and attend to
    the cached prefix without recomputing it (the paged engine's
    prefix-hit path); the returned cache covers the suffix only.
    ``embeds``/``embed_mask`` inject embedding spans (``embed_inputs``)."""
    if remat and (return_cache or prefix_kv is not None):
        raise ValueError("attn_forward: remat is for training, without a "
                         "cache or a cached prefix")
    B, S = tokens.shape
    x = embed_inputs(cfg, params, tokens, embeds, embed_mask)
    offset = 0 if prefix_kv is None else prefix_kv[0].shape[2]
    positions = offset + torch.arange(S, device=tokens.device)
    rope_l, rope_g = _rope_tables(cfg, offset + S, tokens.device)
    ks, vs = [], []
    for i, (pl, is_global) in enumerate(zip(
            _stack_layers(params["layers"], cfg.n_layers),
            static_layer_windows(cfg))):
        args = (cfg, pl, x, rope_g if is_global else rope_l,
                0 if is_global else cfg.window, positions)
        if remat:
            x = _remat(lambda *a: _attn_layer(*a)[0], *args)
            continue
        pkv = None if prefix_kv is None else (prefix_kv[0][i],
                                              prefix_kv[1][i])
        x, (k, v) = _attn_layer(*args, pkv)
        ks.append(k)
        vs.append(v)
    x = _norm(params, x, cfg.norm, "final")
    return (x, (torch.stack(ks), torch.stack(vs))) if return_cache else x


# --------------------------------------------------------------- zamba2 family


def _shared_attn_apply(cfg: ArchConfig, ps, x, x0, rope, positions, *,
                       attend=None):
    """Shared attention+MLP block on concat(x, x0) (``lm.py:480`` of the
    JAX package).  Prefill (``attend`` None): x [B, S, d], causal
    attention over the prompt through the flash-attention kernel; returns
    (y, (k, v)) with k/v rope'd [B, S, Hkv, Dh].  Decode: x [B, d] at
    ``positions`` [B, 1]; ``attend(q1, k1, v1)`` owns the cache write and
    the attention (the flash-decode kernel); returns (y, None)."""
    B, dt = x.shape[0], x.dtype
    cat = torch.cat([x, x0], -1)
    if cat.dim() == 2:  # decode: [B, 2d]
        cat = cat[:, None]
    S = cat.shape[1]
    xn = _norm(ps, cat, cfg.norm, "ln1")
    q, k, v = _qkv(ps["attn"], cfg, xn, B, S)
    cos, sin = rope
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    if attend is None:
        o, kv = flash_attention(q, k, v, causal=True), (k, v)
    else:
        o, kv = attend(q[:, 0], k[:, 0], v[:, 0]), None
    o = o.reshape(x.shape[:-1] + (-1,))
    y = x + dense(o, ps["attn"]["wo"].to(dt), cfg)
    yn = _norm(ps, y, cfg.norm, "ln2")
    return y + _mlp(ps["mlp"], cfg, yn).reshape(x.shape), kv


def zamba2_groups(cfg: ArchConfig) -> "tuple[int, int]":
    """(groups, Mamba2 layers per group): the shared block follows each
    group."""
    return cfg.n_layers // cfg.shared_attn_every, cfg.shared_attn_every


def zamba2_forward(cfg: ArchConfig, params, tokens, *, return_cache=False,
                   remat=False):
    """tokens [B, S] -> final-normed hidden [B, S, d] (``lm.py:515`` of the
    JAX package, with Python loops in place of its two scans): each group's
    Mamba2 layers in order, then the shared block on concat(x, x0).  With
    ``return_cache`` also ((conv [G, P, B, min(S, W-1), Ch], ssm
    [G, P, B, nh, p, N] fp32), (k, v) [G, B, S, Hkv, Dh]).  ``remat``
    (training) recomputes each Mamba2 layer in the backward, as the JAX
    package checkpoints ``inner`` (``lm.py:530``); the shared block is not
    recomputed."""
    if remat and return_cache:
        raise ValueError("zamba2_forward: remat is for training, without a "
                         "cache")
    B, S = tokens.shape
    x = embed_tokens(cfg, params, tokens)
    x0 = x
    positions = torch.arange(S, device=tokens.device)
    rope, _ = _rope_tables(cfg, S, tokens.device)
    G, P = zamba2_groups(cfg)
    convs, ssms, ks, vs = [], [], [], []

    def inner(pl, x):
        y, st = m2.mamba2_forward(pl, x, n_state=cfg.ssm_state,
                                  headdim=cfg.ssm_headdim,
                                  chunk=cfg.scan_chunk)
        return x + y, st

    for pm in _stack_layers(params["mamba"], G):
        for pl in _stack_layers(pm, P):
            if remat:
                x = _remat(lambda *a: inner(*a)[0], pl, x)
                continue
            x, (cs, ss) = inner(pl, x)
            convs.append(cs)
            ssms.append(ss)
        x, (k, v) = _shared_attn_apply(cfg, params["shared_attn"], x, x0,
                                       rope, positions)
        ks.append(k)
        vs.append(v)
    x = _norm(params, x, cfg.norm, "final")
    if not return_cache:
        return x

    def stacked(ts):
        t = torch.stack(ts)
        return t.reshape((G, P) + t.shape[1:])

    return x, ((stacked(convs), stacked(ssms)),
               (torch.stack(ks), torch.stack(vs)))


# ---------------------------------------------------------------- xlstm family


def xlstm_groups(cfg: ArchConfig) -> "tuple[int, int]":
    """(groups, mLSTM blocks per group): one sLSTM block ends each
    group."""
    P = cfg.mlstm_per_slstm
    return cfg.n_layers // (P + 1), P


def xlstm_forward(cfg: ArchConfig, params, tokens, *, return_cache=False,
                  remat=False):
    """tokens [B, S] -> final-normed hidden [B, S, d] (``lm.py:544`` of the
    JAX package, with Python loops in place of its scans): each group's
    mLSTM blocks in order, then its sLSTM block.  With ``return_cache``
    also ((mconv [G, P, B, min(S, W-1), d_in], (mC [G, P, B, nh, dh, dh],
    mn [G, P, B, nh, dh], mm [G, P, B, nh])), (sc, sn, sm, sh) each
    [G, B, d]), the states fp32.  A prompt past ``scan_chunk`` must be
    whole chunks (ValueError).  ``remat`` (training) recomputes each mLSTM
    block in the backward, as the JAX package checkpoints ``inner``
    (``lm.py:558``); the sLSTM blocks are not recomputed."""
    if remat and return_cache:
        raise ValueError("xlstm_forward: remat is for training, without a "
                         "cache")
    x = embed_tokens(cfg, params, tokens)
    G, P = xlstm_groups(cfg)
    convs, Cs, ns, ms, sstates = [], [], [], [], []

    def inner(pl, x):
        return xl.mlstm_block(pl, x, nh=cfg.n_heads, chunk=cfg.scan_chunk,
                              gather_qkv=cfg.xlstm_gather_qkv)

    for pm, ps in zip(_stack_layers(params["mlstm"], G),
                      _stack_layers(params["slstm"], G)):
        for pl in _stack_layers(pm, P):
            if remat:
                x = _remat(lambda *a: inner(*a)[0], pl, x)
                continue
            x, (cs, (C, n, m)) = inner(pl, x)
            convs.append(cs)
            Cs.append(C)
            ns.append(n)
            ms.append(m)
        x, st = xl.slstm_block(ps, x, nh=cfg.n_heads)
        sstates.append(st)
    x = _norm(params, x, cfg.norm, "final")
    if not return_cache:
        return x

    def stacked(ts):
        t = torch.stack(ts)
        return t.reshape((G, P) + t.shape[1:])

    mstate = (stacked(convs), (stacked(Cs), stacked(ns), stacked(ms)))
    return x, (mstate, tuple(torch.stack(leaf) for leaf in zip(*sstates)))


# -------------------------------------------------------------- whisper family


def sinusoid(pos, d: int):
    """whisper's sinusoidal position table at ``pos`` [n] -> [n, d] fp32:
    sin of the first half, cos of the second, frequencies
    ``exp(-i / (half - 1) * ln 10000)`` (``half - 1``, as the JAX
    package divides)."""
    half = d // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=pos.device) / (half - 1)
                      * math.log(10000.0))
    ang = pos.float()[:, None] * freqs[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def _whisper_enc_layer(cfg: ArchConfig, pl, x):
    B, Se, _ = x.shape
    xn = _norm(pl, x, cfg.norm, "ln1")
    q, k, v = _qkv(pl["attn"], cfg, xn, B, Se)
    o = flash_attention(q, k, v, causal=False)
    x = x + dense(o.reshape(B, Se, -1), pl["attn"]["wo"].to(x.dtype), cfg)
    return x + _mlp(pl["mlp"], cfg, _norm(pl, x, cfg.norm, "ln2"))


def whisper_encode(cfg: ArchConfig, params, frames, *, remat=False):
    """frames [B, Se, d] (the stub frontend's precomputed frame
    embeddings) -> encoder output [B, Se, d] after ``enc_final``:
    sinusoidal positions, then pre-LN layers of non-causal attention (the
    flash-attention kernel on the card) and the plain gelu MLP.
    ``remat`` (training) recomputes each layer in the backward (JAX
    ``lm.py:591``)."""
    B, Se, d = frames.shape
    x = frames.to(act_dtype(cfg))
    x = x + sinusoid(torch.arange(Se, device=x.device), d)[None].to(x.dtype)
    for pl in _stack_layers(params["encoder"], cfg.encoder_layers):
        x = (_remat(functools.partial(_whisper_enc_layer, cfg), pl, x)
             if remat else _whisper_enc_layer(cfg, pl, x))
    return _norm(params, x, cfg.norm, "enc_final")


def cross_q(cfg: ArchConfig, pl_xattn, xn):
    """The cross-attention queries [B, S, H, Dh] of the lnx-normed
    decoder stream xn [B, S, d] (the JAX package's ``_qkv`` computes this
    layer's k and v of xn too, and drops them)."""
    B, S, _ = xn.shape
    q = dense(xn, pl_xattn["wq"].to(xn.dtype), cfg)
    if "bq" in pl_xattn:
        q = q + pl_xattn["bq"].to(xn.dtype)
    return q.reshape(B, S, cfg.n_heads, cfg.hd)


def cross_kv(cfg: ArchConfig, pl_xattn, enc):
    """One decoder layer's cross-attention K/V [B, Se, Hkv, Dh] from the
    encoder output, with ``bk``/``bv`` added where the config has them."""
    B, Se, _ = enc.shape
    dt = enc.dtype
    shape = (B, Se, cfg.n_kv_heads, cfg.hd)
    k = dense(enc, pl_xattn["wk"].to(dt), cfg).reshape(shape)
    v = dense(enc, pl_xattn["wv"].to(dt), cfg).reshape(shape)
    if "bk" in pl_xattn:
        k = k + pl_xattn["bk"].to(dt).reshape(shape[2:])
        v = v + pl_xattn["bv"].to(dt).reshape(shape[2:])
    return k, v


def _whisper_dec_layer(cfg: ArchConfig, pl, x, enc):
    """One decoder layer; returns (x, (k, v, xk, xv))."""
    B, S, _ = x.shape
    xn = _norm(pl, x, cfg.norm, "ln1")
    q, k, v = _qkv(pl["attn"], cfg, xn, B, S)
    o = flash_attention(q, k, v, causal=True)
    x = x + dense(o.reshape(B, S, -1), pl["attn"]["wo"].to(x.dtype), cfg)
    xn = _norm(pl, x, cfg.norm, "lnx")
    q2 = cross_q(cfg, pl["xattn"], xn)
    k2, v2 = cross_kv(cfg, pl["xattn"], enc.to(x.dtype))
    o2 = flash_attention(q2, k2, v2, causal=False)
    x = x + dense(o2.reshape(B, S, -1), pl["xattn"]["wo"].to(x.dtype),
                  cfg)
    x = x + _mlp(pl["mlp"], cfg, _norm(pl, x, cfg.norm, "ln2"))
    return x, (k, v, k2, v2)


def whisper_decode_forward(cfg: ArchConfig, params, tokens, enc, *,
                           return_cache=False, remat=False):
    """tokens [B, S], enc [B, Se, d] (``whisper_encode``'s output) ->
    final-normed hidden [B, S, d]: sinusoidal positions, then per layer
    causal self-attention, cross-attention over every frame (both through
    the flash-attention kernel on the card) and the MLP.  With
    ``return_cache`` also (k, v [L, B, S, Hkv, Dh], xk, xv [L, B, Se, Hkv,
    Dh]).  ``remat`` (training) recomputes each layer in the backward (JAX
    ``lm.py:628``)."""
    if remat and return_cache:
        raise ValueError("whisper_decode_forward: remat is for training, "
                         "without a cache")
    B, S = tokens.shape
    x = embed_tokens(cfg, params, tokens)
    x = x + sinusoid(torch.arange(S, device=x.device),
                     cfg.d_model)[None].to(x.dtype)
    ks, vs, xks, xvs = [], [], [], []
    for pl in _stack_layers(params["layers"], cfg.n_layers):
        if remat:
            x = _remat(lambda *a: _whisper_dec_layer(cfg, *a)[0], pl, x, enc)
            continue
        x, (k, v, k2, v2) = _whisper_dec_layer(cfg, pl, x, enc)
        ks.append(k)
        vs.append(v)
        xks.append(k2)
        xvs.append(v2)
    x = _norm(params, x, cfg.norm, "final")
    if not return_cache:
        return x
    return x, tuple(torch.stack(t) for t in (ks, vs, xks, xvs))


def layer_slice(tree, i: int):
    """Layer ``i`` of a layer-stacked parameter dict (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def unbind_layers(tree, n: int) -> list:
    """The n layers of a layer-stacked parameter dict as n dicts of views,
    one ``unbind`` a leaf (its backward stacks the layers' gradients
    once, where ``n`` selects would each add a full-size zero-filled
    gradient)."""
    if isinstance(tree, dict):
        per = {k: unbind_layers(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    return tree.unbind(0)


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


# ------------------------------------------------------------------ losses


def forward_hidden(cfg: ArchConfig, params, batch, *, remat=True):
    """Final hidden states [B, S, d] of ``batch``, dispatched per family as
    ``lm.py:697`` of the JAX package does: whisper encodes
    ``batch["encoder_frames"]`` and decodes ``batch["tokens"]`` against
    it; zamba2, xlstm and the attention family (dense or MoE) run their
    forward on the tokens."""
    tokens = batch["tokens"]
    if cfg.cross_attention:
        enc = whisper_encode(cfg, params, batch["encoder_frames"],
                             remat=remat)
        return whisper_decode_forward(cfg, params, tokens, enc, remat=remat)
    if cfg.block_kind == "mamba_hybrid":
        return zamba2_forward(cfg, params, tokens, remat=remat)
    if cfg.block_kind == "xlstm":
        return xlstm_forward(cfg, params, tokens, remat=remat)
    return attn_forward(cfg, params, tokens, remat=remat)


def _xent_chunk(h, y, head, softcap: float):
    """Summed cross-entropy of one chunk's tokens h [B, c, d] against
    labels y [B, c] (-1 ignored): fp32 logits of the head, the softcap,
    ``logsumexp - gold`` on the valid tokens."""
    logits = (h @ head.to(h.dtype)).float()
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    lse = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, y.clamp(min=0)[..., None])[..., 0]
    return ((lse - gold) * (y >= 0).float()).sum()


def chunked_xent(cfg: ArchConfig, params, hidden, labels, *, chunk=512):
    """Per-token mean cross-entropy of hidden [B, S, d] against labels
    [B, S] (-1 ignored) without a full [B, S, V] logits tensor
    (``lm.py:637`` of the JAX package): chunks of ``chunk`` positions, each
    under ``checkpoint`` so that its logits are recomputed in the backward
    rather than kept; the tied head is ``embed.table.T``.  The sums add
    chunk by chunk in order, as the JAX scan's carry does; the last chunk
    is cut short where JAX pads it with ignored labels."""
    S = hidden.shape[1]
    head = (params["embed"]["table"].T if cfg.tie_embeddings
            else params["lm_head"])
    chunk = min(chunk, S)
    tot = torch.zeros((), device=hidden.device)
    cnt = torch.zeros((), device=hidden.device)
    for c0 in range(0, S, chunk):
        h, y = hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        tot = tot + checkpoint(_xent_chunk, h, y, head,
                               float(cfg.logit_softcap), use_reentrant=False)
        cnt = cnt + (y >= 0).float().sum()
    return tot / cnt.clamp(min=1.0)


def train_loss(cfg: ArchConfig, params, batch, *, remat=True):
    """Mean next-token cross-entropy of ``batch`` (``tokens``, ``labels``
    [B, S], whisper's ``encoder_frames`` [B, Se, d]; ``lm.py:710``)."""
    h = forward_hidden(cfg, params, batch, remat=remat)
    return chunked_xent(cfg, params, h, batch["labels"])


# ------------------------------------------------------------------ head


def last_logits(cfg: ArchConfig, params, hidden_last):
    """hidden_last [..., d] -> [..., V] fp32 logits (tied head, softcap)."""
    head = (params["embed"]["table"].T if cfg.tie_embeddings
            else params["lm_head"])
    logits = (hidden_last @ head.to(hidden_last.dtype)).float()
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits
