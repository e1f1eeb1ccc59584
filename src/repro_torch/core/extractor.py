"""Universal multimodal feature extractor (paper Sec. IV-A, Fig. 3).

Port of ``repro/core/extractor.py``.  Four branches (the frozen ViT [CLS]
feature, the frozen DistilBERT mean-pooled feature, a model-type
embedding and a device-type embedding) are projected to a common 64-d
space (Eqs. 9-12) and fused by a two-layer MLP (Eq. 13).  The frozen
encoder outputs are computed once per task (``feature_store``), so
training runs only these learnable parts.

Dropout draws its masks from the caller's ``torch.Generator`` (on the
tensors' device); ``jax.random.bernoulli``'s masks cannot be reproduced,
so only the deterministic path equals the JAX package's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.spec import TensorSpec, init_params

PROJ_DIM = 64
META_DIM = 32
FUSED_DIM = 64


def extractor_spec(feat_dim: int = 768, n_models: int = 8,
                   n_devices: int = 8):
    def lin(i, o):
        return {"w": TensorSpec((i, o), (None, None), "normal", i ** -0.5),
                "b": TensorSpec((o,), (None,), "zeros"),
                "ln_s": TensorSpec((o,), (None,), "ones"),
                "ln_b": TensorSpec((o,), (None,), "zeros")}

    return {
        "proj_text": lin(feat_dim, PROJ_DIM),
        "proj_img": lin(feat_dim, PROJ_DIM),
        "emb_model": TensorSpec((n_models, META_DIM), (None, None),
                                "normal", 0.02),
        "emb_device": TensorSpec((n_devices, META_DIM), (None, None),
                                 "normal", 0.02),
        "fuse1": lin(3 * PROJ_DIM, FUSED_DIM),
        "fuse2": lin(FUSED_DIM, FUSED_DIM),
    }


def apply_dropout(h, generator, dropout: float):
    """``h`` with each value kept with probability ``1 - dropout`` (and
    scaled by its inverse) by a draw from ``generator``."""
    keep = torch.rand(h.shape, generator=generator, device=h.device) \
        < 1 - dropout
    return torch.where(keep, h / (1 - dropout), 0.0)


def _proj(p, x, generator, dropout, deterministic):
    h = (x @ p["w"] + p["b"]).float()
    mu = h.mean(-1, keepdim=True)
    var = h.var(-1, keepdim=True, correction=0)
    h = (h - mu) * torch.rsqrt(var + 1e-5) * p["ln_s"] + p["ln_b"]
    h = F.gelu(h, approximate="tanh")
    if not deterministic and dropout > 0:
        h = apply_dropout(h, generator, dropout)
    return h


def extract(params, f_text, f_img, model_id, device_id, *, generator=None,
            dropout: float = 0.1, deterministic: bool = True):
    """-> fused feature [B, 64]  (Eq. 13)."""
    ft = _proj(params["proj_text"], f_text, generator, dropout,
               deterministic)
    fi = _proj(params["proj_img"], f_img, generator, dropout, deterministic)
    fm = params["emb_model"][model_id]
    fd = params["emb_device"][device_id]
    cat = torch.cat([ft, fi, fm, fd], -1)
    h = _proj(params["fuse1"], cat, generator, dropout, deterministic)
    return _proj(params["fuse2"], h, generator, dropout, deterministic)


def init_extractor(seed: int = 0, feat_dim=768, n_models=8, n_devices=8,
                   device=None):
    return init_params(extractor_spec(feat_dim, n_models, n_devices), seed,
                       device=device)
