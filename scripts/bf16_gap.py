"""bf16 prefill/decode consistency gap of the JAX package and the PyTorch
port on the CPU, at a config's full width with few layers.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/bf16_gap.py xlstm-1.3b
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/bf16_gap.py whisper-large-v3

The gap is smoke_decode's check: logits of token S from prefill(S + 1)
against prefill(S) + serve_step, as a fraction of the largest |logit|,
with bf16 weights and activations (B 2, S 33).  Both packages run the
same weights (the JAX package's seeded draw, carried into the port by
``from_jax_params``) on the same tokens (and, for whisper, frames).  The
widths are the published config's; depth is cut to ``LAYERS``: xlstm-1.3b
one group (7 mLSTM blocks and 1 sLSTM block, d 2048), whisper-large-v3
two encoder and two decoder layers (d 1280, 1500 frames).  A large
config's full depth does not fit this script's CPU budget.
"""
from __future__ import annotations

import dataclasses
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild
from repro_torch.configs import get_config
from repro_torch.models.api import build_model
from repro_torch.weights import from_jax_params

B, S = 2, 33
LAYERS = {"xlstm-1.3b": dict(n_layers=8),
          "whisper-large-v3": dict(n_layers=2, encoder_layers=2)}


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-9))


def grow_jax(cache):
    out = dict(cache)
    for k in ("k", "v"):
        if k in out:
            pad = [(0, 0)] * out[k].ndim
            pad[-3] = (0, 1)
            out[k] = jnp.pad(out[k], pad)
    if "pos_map" in out:
        out["pos_map"] = jnp.pad(out["pos_map"], ((0, 0), (0, 1)),
                                 constant_values=-1)
    return out


def grow_torch(cache):
    out = dict(cache)
    for k in ("k", "v"):
        if k in out:
            c = out[k]
            out[k] = torch.cat([c, torch.zeros_like(c[:, :, :1])], 2)
    if "pos_map" in out:
        pm = out["pos_map"]
        out["pos_map"] = torch.cat([pm, torch.full_like(pm[:, :1], -1)], 1)
    return out


def gaps(arch: str) -> "tuple[float, float]":
    jcfg = dataclasses.replace(jget_config(arch), **LAYERS[arch])
    tcfg = dataclasses.replace(get_config(arch), **LAYERS[arch])
    rng = np.random.default_rng(21)
    toks = rng.integers(0, jcfg.vocab, (B, S + 1))
    extra = {}
    if jcfg.cross_attention:
        extra["encoder_frames"] = rng.normal(
            size=(B, jcfg.encoder_seq, jcfg.d_model)).astype(np.float32)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0), param_dtype=jnp.bfloat16)
    je = {k: jnp.asarray(v) for k, v in extra.items()}
    full, _ = jax.jit(jm.prefill)(
        jp, {"tokens": jnp.asarray(toks, jnp.int32), **je})
    _, cache = jax.jit(jm.prefill)(
        jp, {"tokens": jnp.asarray(toks[:, :S], jnp.int32), **je})
    step, _ = jax.jit(jm.serve_step)(jp, grow_jax(cache), {
        "tokens": jnp.asarray(toks[:, S], jnp.int32),
        "pos": jnp.full((B,), S, jnp.int32)})
    jgap = rel(full, step)
    params = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    del jp, cache
    tm = build_model(tcfg)
    t = torch.from_numpy(toks)
    te = {k: torch.from_numpy(v) for k, v in extra.items()}
    with torch.no_grad():
        full, _ = tm.prefill(params, {"tokens": t, **te})
        _, cache = tm.prefill(params, {"tokens": t[:, :S], **te})
        step, _ = tm.serve_step(params, grow_torch(cache), {
            "tokens": t[:, S], "pos": torch.full((B,), S, dtype=torch.int32)})
    return jgap, rel(full.float().numpy(), step.float().numpy())


def main():
    for arch in sys.argv[1:] or list(LAYERS):
        t0 = time.perf_counter()
        jgap, gap = gaps(arch)
        print(f"{arch} {LAYERS[arch]} bf16 consistency gap: JAX {jgap:.4e}, "
              f"port {gap:.4e}, port / JAX {gap / jgap:.3f} "
              f"({time.perf_counter() - t0:.0f} s on the CPU)", flush=True)


if __name__ == "__main__":
    main()
