"""The whole zoo through the port's model steps (the port's counterpart of
``scripts/smoke_decode.py`` and of tests/test_models.py's
``test_decode_matches_prefill``): for every config in ``ARCH_IDS``,
reduced, in fp32, with ``capacity_factor=16`` (so that no MoE expert
drops a token, which batched prefill and decode would drop differently),
the last logits of ``prefill`` over S + 1 tokens equal those of
``prefill`` over S tokens followed by one ``serve_step`` at position S;
and the port's prefill logits equal the JAX package's on the same
weights (``from_jax_params``).  whisper takes its frames in
``encoder_frames``.

Tolerances: the consistency check is test_models.py's, 2e-4 of the
largest |logit| (fp32 caches: the prefill's K/V and states stay in the
activation type, so the two paths differ only in summation order); the
JAX comparison 1e-4 of the largest |logit| (fp32 matmuls in other orders
over at most four layers).

In bf16 the same check is no longer a cache check for xlstm: the two
paths round differently (a batched and a one-row GEMM, the causal conv's
bf16 sums against its one-row einsum) and the recurrent blocks carry
it, so the JAX package's own gap exceeds smoke_decode's 2e-2 already at
reduced width; ``test_xlstm_bf16_gap_is_the_references`` pins that fact
and holds the port's gap to the same order (``chip_smoke.py`` phase 9f
therefore holds xlstm's check with fp32 activations).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models import build_model as jbuild
except ImportError:  # JAX (the reference) is not installed
    jax = None

from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.models.api import build_model
from repro_torch.weights import from_jax_params

B, S = 2, 33


@pytest.fixture
def need_jax():
    """JAX, with the reference computed on the CPU on any host."""
    if jax is None:
        pytest.skip("JAX (the reference package) is not installed here")
    with jax.default_device(jax.devices("cpu")[0]):
        yield


def _cfg(arch):
    return dataclasses.replace(reduced(get_config(arch)),
                               act_dtype="float32", capacity_factor=16.0)


def _inputs(cfg, seed=1):
    """Tokens [B, S + 1] and, for whisper, frames [B, Se, d]."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1))
    extra = {}
    if cfg.cross_attention:
        extra["encoder_frames"] = rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return toks, extra


def _grow(cache):
    """One more (empty) entry in the sequence dim of the positional
    leaves, for the decode step's token to land in."""
    out = dict(cache)
    for name in ("k", "v"):
        if name in out:
            c = out[name]
            out[name] = torch.cat([c, torch.zeros_like(c[:, :, :1])], 2)
    if "pos_map" in out:
        pm = out["pos_map"]
        out["pos_map"] = torch.cat([pm, torch.full_like(pm[:, :1], -1)], 1)
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(a).max() + 1e-9))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_matches_prefill(arch):
    """serve_step(token S) after prefill(S) == prefill(S + 1), every
    family, on the port's own seeded fp32 weights."""
    cfg = _cfg(arch)
    m = build_model(cfg)
    params = m.init(2, param_dtype=torch.float32, device="cpu")
    toks, extra = _inputs(cfg)
    extra = {k: torch.from_numpy(v) for k, v in extra.items()}
    toks = torch.from_numpy(toks)
    full, _ = m.prefill(params, {"tokens": toks, **extra})
    _, cache = m.prefill(params, {"tokens": toks[:, :S], **extra})
    step, _ = m.serve_step(params, _grow(cache), {
        "tokens": toks[:, S], "pos": torch.full((B,), S, dtype=torch.int32)})
    assert step.shape == (B, cfg.vocab)
    assert bool(torch.isfinite(step).all())
    err = _rel(full.numpy(), step.numpy())
    assert err < 2e-4, f"{arch}: decode/prefill mismatch {err:.3e}"


@functools.cache
def _jax_logits(arch):
    jcfg = dataclasses.replace(jreduced(jget_config(arch)),
                               act_dtype="float32", capacity_factor=16.0)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0), param_dtype=jnp.float32)
    toks, extra = _inputs(jcfg, seed=3)
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S], jnp.int32),
                            **{k: jnp.asarray(v) for k, v in extra.items()}})
    return jax.tree.map(np.asarray, jp), toks, extra, np.asarray(jl)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_logits_match_jax(need_jax, arch):
    """prefill(S) on the JAX package's weights gives its logits."""
    jp, toks, extra, want = _jax_logits(arch)
    m = build_model(_cfg(arch))
    params = from_jax_params(jp, device="cpu")
    got, _ = m.prefill(params, {
        "tokens": torch.from_numpy(toks[:, :S]),
        **{k: torch.from_numpy(v) for k, v in extra.items()}})
    err = _rel(want, got.numpy())
    assert err < 1e-4, f"{arch}: port vs JAX prefill logits {err:.3e}"


def test_xlstm_bf16_gap_is_the_references(need_jax, d_model=256):
    """Reduced xlstm-1.3b at d_model 256 with bf16 weights and
    activations, the same weights in both packages: the JAX package's
    consistency gap exceeds smoke_decode's 2e-2, and the port's is of the
    same order (within 2.5 times the reference's; fp32 gaps are ~1e-6).
    The gaps are printed (``-s``)."""
    jcfg = jreduced(jget_config("xlstm-1.3b"), d_model=d_model)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0), param_dtype=jnp.bfloat16)
    toks = np.random.default_rng(21).integers(0, jcfg.vocab, (B, S + 1))
    pos = np.full((B,), S, np.int32)
    full, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    _, cache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S],
                                                     jnp.int32)})
    step, _ = jm.serve_step(jp, cache, {
        "tokens": jnp.asarray(toks[:, S], jnp.int32),
        "pos": jnp.asarray(pos)})
    jgap = _rel(full, step)
    m = build_model(reduced(get_config("xlstm-1.3b"), d_model=d_model))
    params = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    t = torch.from_numpy(toks)
    full, _ = m.prefill(params, {"tokens": t})
    _, cache = m.prefill(params, {"tokens": t[:, :S]})
    step, _ = m.serve_step(params, cache, {"tokens": t[:, S],
                                           "pos": torch.from_numpy(pos)})
    gap = _rel(full.numpy(), step.numpy())
    print(f"xlstm d_model {d_model} bf16 consistency gap: JAX {jgap:.3e}, "
          f"port {gap:.3e}")
    assert jgap > 2e-2
    assert 0 < gap <= 2.5 * jgap
