"""Lightweight multimodal encoder: media -> LM-injectable embedding spans
(port of ``repro/models/mm_encoder.py``).

The edge-side model of the paper's multimodal requests.  Its output dim is
the serving LM's ``d_model``, so its features ride ``EmbedSegment``s
straight into the engine's embedding-span prefill (``lm.embed_inputs``):

  * images [B, H, W, 3] — conv patchify (non-overlapping ``patch x patch``
    windows as an unfold + linear, exactly a stride-``patch`` conv), then
    ``n_layers`` pre-norm non-causal transformer blocks;
  * audio [B, T, audio_dim] — a per-frame linear projection into the same
    trunk.

The trunk's attention is ``models.attention.flash_attention(...,
causal=False)`` and its norms ``nn.layers.apply_rmsnorm``: on the card the
flash-attention and fused RMSNorm kernels, on the CPU their plain
versions.  The JAX package scans over the layer-stacked blocks; here a
Python loop walks them.

``keep_ratio`` applies keep-top-k pooling to the encoded span: positions
are ranked by fp32 feature L2 norm and the top ``ceil(ratio * n)`` are
kept in original order, so features come out [B, kept, d].
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models.attention import flash_attention
from repro_torch.models.lm import layer_slice
from repro_torch.nn.layers import apply_linear, apply_rmsnorm, linear, rmsnorm
from repro_torch.nn.spec import TensorSpec, init_params


@dataclasses.dataclass(frozen=True)
class MMEncoderConfig:
    d_model: int  # output dim == the serving LM's d_model
    img_size: int = 32
    patch: int = 8
    audio_dim: int = 16  # input frame feature dim (mel-bin stand-in)
    n_layers: int = 2
    n_heads: int = 2
    d_ff: int = 128
    max_span: int = 256  # learned position table length
    keep_ratio: float = 1.0  # keep-top-k pooling fraction (1.0 = keep all)

    @property
    def n_patches(self) -> int:
        return (self.img_size // self.patch) ** 2

    def kept(self, n: int) -> int:
        """Span length after keep-top-k pooling of ``n`` positions."""
        return max(1, min(n, math.ceil(self.keep_ratio * n)))


def mm_encoder_spec(cfg: MMEncoderConfig):
    """The JAX package's spec tree, keys and shapes unchanged (the
    blocks' leaves stacked over ``n_layers`` on dim 0)."""
    d, L = cfg.d_model, cfg.n_layers
    pdim = cfg.patch * cfg.patch * 3

    def stack(p):  # add the [L] layer dim to a linear/rmsnorm spec
        return {k: TensorSpec((L,) + s.shape, ("layers",) + s.axes,
                              s.init, s.scale) for k, s in p.items()}

    nn = (None, None)
    return {
        "patch_proj": linear(pdim, d, axes=nn, bias=True,
                             scale=pdim ** -0.5),
        "audio_proj": linear(cfg.audio_dim, d, axes=nn, bias=True,
                             scale=cfg.audio_dim ** -0.5),
        "pos": TensorSpec((cfg.max_span, d), nn, "normal", 0.02),
        "blocks": {
            "ln1": stack(rmsnorm(d, axes=(None,))),
            "wq": stack(linear(d, d, axes=nn, scale=d ** -0.5)),
            "wk": stack(linear(d, d, axes=nn, scale=d ** -0.5)),
            "wv": stack(linear(d, d, axes=nn, scale=d ** -0.5)),
            "wo": stack(linear(d, d, axes=nn, scale=d ** -0.5)),
            "ln2": stack(rmsnorm(d, axes=(None,))),
            "w_gate": stack(linear(d, cfg.d_ff, axes=nn, scale=d ** -0.5)),
            "w_up": stack(linear(d, cfg.d_ff, axes=nn, scale=d ** -0.5)),
            "w_down": stack(linear(cfg.d_ff, d, axes=nn,
                                   scale=cfg.d_ff ** -0.5)),
        },
        "final": rmsnorm(d, axes=(None,)),
    }


def init_mm_encoder(cfg: MMEncoderConfig, seed: int = 0,
                    param_dtype=torch.float32, device=None):
    """Seeded parameters on ``device`` (the CUDA card unless the caller
    passes ``device="cpu"``)."""
    return init_params(mm_encoder_spec(cfg), seed, param_dtype, device)


def _block(pl, x, n_heads: int):
    """Pre-norm non-causal transformer block on [B, S, d]."""
    B, S, d = x.shape
    dh = d // n_heads
    xn = apply_rmsnorm(pl["ln1"], x)
    q = apply_linear(pl["wq"], xn).reshape(B, S, n_heads, dh)
    k = apply_linear(pl["wk"], xn).reshape(B, S, n_heads, dh)
    v = apply_linear(pl["wv"], xn).reshape(B, S, n_heads, dh)
    o = flash_attention(q, k, v, causal=False)
    x = x + apply_linear(pl["wo"], o.reshape(B, S, d))
    xn = apply_rmsnorm(pl["ln2"], x)
    h = F.silu(apply_linear(pl["w_gate"], xn)) \
        * apply_linear(pl["w_up"], xn)
    return x + apply_linear(pl["w_down"], h)


def _trunk(cfg: MMEncoderConfig, params, x):
    """Positions + blocks + final norm on projected inputs [B, S, d]."""
    S = x.shape[1]
    if S > cfg.max_span:
        raise ValueError(f"span of {S} exceeds max_span={cfg.max_span}")
    x = x + params["pos"][:S][None].to(x.dtype)
    for i in range(cfg.n_layers):
        x = _block(layer_slice(params["blocks"], i), x, cfg.n_heads)
    return apply_rmsnorm(params["final"], x)


def top_k_positions(features, k: int):
    """The ``k`` highest-L2-norm positions of each span [B, S, d], in
    ascending order: [B, k] int64."""
    score = torch.sqrt(torch.sum(torch.square(features.float()), -1))
    idx = torch.topk(score, k, dim=-1).indices
    return torch.sort(idx, dim=-1).values


def keep_top_k(features, k: int):
    """Keep-top-k pooling: the ``k`` highest-L2-norm positions of each
    span, order preserved — the compression knob for feature uplinks."""
    idx = top_k_positions(features, k)
    return torch.gather(features, 1,
                        idx[..., None].expand(-1, -1, features.shape[-1]))


def encode_image(cfg: MMEncoderConfig, params, images):
    """images [B, H, W, 3] float in [0, 1] -> features [B, kept, d]."""
    B, H, W, _ = images.shape
    p = cfg.patch
    if H % p or W % p:
        raise ValueError(f"image {H}x{W} not divisible by patch={p}")
    # unfold into non-overlapping patches == stride-p conv patchify
    x = images.reshape(B, H // p, p, W // p, p, 3)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, (H // p) * (W // p), -1)
    x = _trunk(cfg, params, apply_linear(params["patch_proj"], x))
    return keep_top_k(x, cfg.kept(x.shape[1]))


def encode_audio(cfg: MMEncoderConfig, params, frames):
    """frames [B, T, audio_dim] -> features [B, kept, d]."""
    x = _trunk(cfg, params, apply_linear(params["audio_proj"], frames))
    return keep_top_k(x, cfg.kept(x.shape[1]))
