"""Analytic FLOP accounting (a copy of ``repro/models/counting.py``):
MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE).

N counts matmul-participating parameters (embedding gathers excluded; a tied
embedding table is counted once, as the LM head).  Zamba2's shared attention
block is weight-reused, so its parameters count once per APPLICATION (9x) —
6*N*D measures compute, not storage.  Whisper adds the encoder at its own
token count.  Attention's quadratic term is excluded by the 6ND convention;
the gap shows up in the MODEL_FLOPS / HLO_FLOPS ratio, as intended.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, ShapeConfig


def _attn_params(cfg: ArchConfig, d_in: int) -> int:
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return d_in * H * Dh + 2 * d_in * Hkv * Dh + H * Dh * cfg.d_model


def _mlp_params(cfg: ArchConfig, ff: int) -> int:
    if cfg.act == "gelu":  # plain 2-matmul MLP
        return 2 * cfg.d_model * ff
    return 3 * cfg.d_model * ff  # GLU


def active_matmul_params(cfg: ArchConfig) -> int:
    d, L = cfg.d_model, cfg.n_layers
    head = d * cfg.vocab  # tied or not, the head matmul runs per token
    if cfg.block_kind == "attn" and not cfg.cross_attention:
        per = _attn_params(cfg, d)
        if cfg.n_experts:
            per += d * cfg.n_experts  # router
            per += 3 * d * cfg.moe_ff * cfg.top_k  # active experts
            if cfg.shared_ff:
                per += 3 * d * cfg.shared_ff + d
        else:
            per += _mlp_params(cfg, cfg.d_ff)
        return L * per + head
    if cfg.block_kind == "mamba_hybrid":
        d_in = cfg.d_inner
        nh = d_in // cfg.ssm_headdim
        per = d * (2 * d_in + 2 * cfg.ssm_state + nh) + d_in * d
        n_apps = L // cfg.shared_attn_every  # shared block applications
        shared = _attn_params(cfg, 2 * d) + _mlp_params(cfg, cfg.d_ff)
        return L * per + n_apps * shared + head
    if cfg.block_kind == "xlstm":
        per_g = cfg.mlstm_per_slstm + 1
        G = L // per_g
        d_in = int(cfg.proj_factor * d)
        mlstm = 2 * d * d_in + 3 * d_in * d_in + 2 * d_in * cfg.n_heads \
            + d_in * d
        dh = d // cfg.n_heads
        slstm = 4 * d * d + cfg.n_heads * dh * 4 * dh \
            + 2 * d * int(d * 4 / 3) + int(d * 4 / 3) * d
        return G * (cfg.mlstm_per_slstm * mlstm + slstm) + head
    if cfg.cross_attention:  # whisper decoder side
        per = 2 * _attn_params(cfg, d) + _mlp_params(cfg, cfg.d_ff)
        return L * per + head
    raise ValueError(cfg.block_kind)


def encoder_matmul_params(cfg: ArchConfig) -> int:
    if not cfg.cross_attention:
        return 0
    return cfg.encoder_layers * (_attn_params(cfg, cfg.d_model)
                                 + _mlp_params(cfg, cfg.d_ff))


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """6*N*D for train (fwd+bwd), 2*N*D for inference shapes."""
    N = active_matmul_params(cfg)
    mult = 6.0 if shape.kind == "train" else 2.0
    if shape.kind == "decode":
        tokens = shape.global_batch  # one new token per sequence
    else:
        tokens = shape.tokens
    total = mult * N * tokens
    if cfg.cross_attention and shape.kind != "decode":
        total += mult * encoder_matmul_params(cfg) * (
            shape.global_batch * cfg.encoder_seq)
    return total
