"""Frozen pre-trained encoder architectures (paper Sec. IV-A, component 1).

Port of ``repro/core/encoders.py``: the exact architectures of
``google/vit-base-patch16-224`` and ``distilbert-base-uncased``.  The
pretrained weights are replaced by seeded random weights, as in the JAX
package (a documented fidelity deviation, README.md, Design notes): frozen
random transformers are valid untrained-feature encoders, and the
learnable projections, fusion and heads train on top of them.

``profile`` scales the encoder:
  * "paper": ViT-B/16 at 224 px (196 + 1 tokens), DistilBERT L = 256;
  * "fast": the same layer counts and widths, 64 px images (16 + 1
    tokens), L = 64;
  * "tiny": 2 layers of width 128 (unit tests).

The attention (a key-padding mask in BERT) and the LayerNorms (mean and
bias, eps 1e-12) are plain torch, as the JAX package computes them outside
any Pallas kernel.  The JAX package scans over the layer-stacked leaves;
here a loop walks the layer index.  The weights are drawn by
``nn.spec.init_params``, so they are other numbers than ``jax.random``'s,
and a draw on the card differs from one on the CPU.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from repro_torch.device import resolve
from repro_torch.nn.spec import TensorSpec, init_params


@dataclasses.dataclass(frozen=True)
class EncoderProfile:
    name: str
    img_size: int
    patch: int
    vit_layers: int
    vit_dim: int
    vit_heads: int
    vit_mlp: int
    text_len: int
    bert_layers: int
    bert_dim: int
    bert_heads: int
    bert_mlp: int
    bert_vocab: int


PROFILES = {
    "paper": EncoderProfile("paper", 224, 16, 12, 768, 12, 3072,
                            256, 6, 768, 12, 3072, 30522),
    "fast": EncoderProfile("fast", 64, 16, 12, 768, 12, 3072,
                           64, 6, 768, 12, 3072, 30522),
    "tiny": EncoderProfile("tiny", 32, 16, 2, 128, 4, 256,
                           16, 2, 128, 4, 256, 1024),
}


def _tx_layer_spec(L, d, mlp):
    def t(shape, init="normal", scale=None):
        return TensorSpec((L,) + shape, ("layers",) + (None,) * len(shape),
                          init, scale)

    return {
        "ln1_s": t((d,), "ones"), "ln1_b": t((d,), "zeros"),
        "ln2_s": t((d,), "ones"), "ln2_b": t((d,), "zeros"),
        "wq": t((d, d), scale=d ** -0.5), "bq": t((d,), "zeros"),
        "wk": t((d, d), scale=d ** -0.5), "bk": t((d,), "zeros"),
        "wv": t((d, d), scale=d ** -0.5), "bv": t((d,), "zeros"),
        "wo": t((d, d), scale=d ** -0.5), "bo": t((d,), "zeros"),
        "w1": t((d, mlp), scale=d ** -0.5), "b1": t((mlp,), "zeros"),
        "w2": t((mlp, d), scale=mlp ** -0.5), "b2": t((d,), "zeros"),
    }


def vit_spec(p: EncoderProfile):
    n_patches = (p.img_size // p.patch) ** 2
    return {
        "patch_proj": TensorSpec((p.patch * p.patch * 3, p.vit_dim),
                                 (None, None), "normal",
                                 (p.patch * p.patch * 3) ** -0.5),
        "patch_bias": TensorSpec((p.vit_dim,), (None,), "zeros"),
        "cls": TensorSpec((p.vit_dim,), (None,), "normal", 0.02),
        "pos": TensorSpec((n_patches + 1, p.vit_dim), (None, None),
                          "normal", 0.02),
        "layers": _tx_layer_spec(p.vit_layers, p.vit_dim, p.vit_mlp),
        "lnf_s": TensorSpec((p.vit_dim,), (None,), "ones"),
        "lnf_b": TensorSpec((p.vit_dim,), (None,), "zeros"),
    }


def bert_spec(p: EncoderProfile):
    return {
        "tok": TensorSpec((p.bert_vocab, p.bert_dim), (None, None),
                          "normal", 0.02),
        "pos": TensorSpec((p.text_len, p.bert_dim), (None, None),
                          "normal", 0.02),
        "emb_ln_s": TensorSpec((p.bert_dim,), (None,), "ones"),
        "emb_ln_b": TensorSpec((p.bert_dim,), (None,), "zeros"),
        "layers": _tx_layer_spec(p.bert_layers, p.bert_dim, p.bert_mlp),
    }


def _ln(x, s, b):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)  # jnp.var: population
    return ((xf - mu) * torch.rsqrt(var + 1e-12) * s + b).to(x.dtype)


def _tx_stack(params, x, heads, mask=None, post_ln=True):
    """Post-LN (BERT) or pre-LN (ViT) encoder stack, layer by layer."""
    B, S, d = x.shape
    dh = d // heads
    layers = params["layers"]

    def attn(pl, xin):
        def split(w, b):
            return (xin @ w + b).view(B, S, heads, dh).transpose(1, 2)

        q, k, v = (split(pl["wq"], pl["bq"]), split(pl["wk"], pl["bk"]),
                   split(pl["wv"], pl["bv"]))
        s = (q @ k.transpose(-1, -2)) * dh ** -0.5  # [B, H, S, S]
        if mask is not None:
            s = torch.where(mask[:, None, None, :], s, -1e30)
        o = (torch.softmax(s, -1) @ v).transpose(1, 2).reshape(B, S, d)
        return o @ pl["wo"] + pl["bo"]

    def mlp(pl, xin):
        h = F.gelu(xin @ pl["w1"] + pl["b1"], approximate="tanh")
        return h @ pl["w2"] + pl["b2"]

    for i in range(layers["wq"].shape[0]):
        pl = {k: v[i] for k, v in layers.items()}
        if post_ln:  # BERT
            x = _ln(x + attn(pl, x), pl["ln1_s"], pl["ln1_b"])
            x = _ln(x + mlp(pl, x), pl["ln2_s"], pl["ln2_b"])
        else:  # ViT pre-LN
            x = x + attn(pl, _ln(x, pl["ln1_s"], pl["ln1_b"]))
            x = x + mlp(pl, _ln(x, pl["ln2_s"], pl["ln2_b"]))
    return x


@torch.no_grad()
def vit_encode(params, images, p: EncoderProfile):
    """images [B, H, W, 3] -> [CLS] feature [B, vit_dim]  (Eq. 8)."""
    B = images.shape[0]
    ph = p.img_size // p.patch
    x = images.reshape(B, ph, p.patch, ph, p.patch, 3)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, ph * ph, -1)
    x = x @ params["patch_proj"] + params["patch_bias"]
    cls = params["cls"].expand(B, 1, p.vit_dim)
    x = torch.cat([cls, x], 1) + params["pos"][None]
    x = _tx_stack(params, x, p.vit_heads, post_ln=False)
    x = _ln(x, params["lnf_s"], params["lnf_b"])
    return x[:, 0]


@torch.no_grad()
def bert_encode(params, token_ids, attn_mask, p: EncoderProfile):
    """token_ids [B, L] -> mean-pooled feature [B, bert_dim]  (Eqs. 6-7)."""
    B, L = token_ids.shape
    x = params["tok"][token_ids.long()] + params["pos"][None, :L]
    x = _ln(x, params["emb_ln_s"], params["emb_ln_b"])
    x = _tx_stack(params, x, p.bert_heads, mask=attn_mask.bool(),
                  post_ln=True)
    m = attn_mask.float()[..., None]
    return (x * m).sum(1) / m.sum(1).clamp_min(1.0)


def frozen_encoders(profile: str = "fast", seed: int = 0, device=None):
    """(vit_params, bert_params, profile) with seeded frozen fp32 weights
    on ``device`` (the card unless the caller says ``"cpu"``), cached by
    profile, seed and device.  The two trees are drawn under the paths
    ``/vit`` and ``/bert``, so their same-named leaves differ."""
    return _frozen(profile, seed, resolve(device))


@functools.lru_cache(maxsize=4)
def _frozen(profile: str, seed: int, device: torch.device):
    p = PROFILES[profile]
    tree = init_params({"vit": vit_spec(p), "bert": bert_spec(p)}, seed,
                       torch.float32, device)
    return tree["vit"], tree["bert"], p


def encode_batch(images, token_ids, attn_mask, *, profile: str = "fast",
                 seed: int = 0, device=None):
    """Frozen forward: returns (f_img [B, 768], f_text [B, 768]) on the
    encoders' device; numpy inputs are moved there."""
    vit, bert, p = frozen_encoders(profile, seed, device)
    dev = vit["cls"].device
    return (vit_encode(vit, torch.as_tensor(images, device=dev), p),
            bert_encode(bert, torch.as_tensor(token_ids, device=dev),
                        torch.as_tensor(attn_mask, device=dev), p))
