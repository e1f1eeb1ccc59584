"""Public model API of the attention family: spec/init, the paged KV cache
layout, chunked paged prefill and the batched paged decode step (ports of
``repro/models/api.py``).

Paged cache layout: ``k_pages``/``v_pages`` [L, P, bs, Hkv, Dh] bf16, or
int8 with fp32 row scales ``k_scales``/``v_scales`` [L, P, bs, Hkv]
(``kv_dtype="int8"``); a per-slot block table [B, NB] int32 maps logical
block ``j`` to a page id (-1 = unallocated).

The JAX package scans over the stacked layers; here a Python loop walks
them, each layer taking its (rope, window) from
``lm.static_layer_windows``.  The pools are updated in place with
``index_put_`` (the counterpart of the JAX engine donating its cache), and
the functions still return the cache dict.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.kernels.quant import quantize_kv
from repro_torch.models import lm
from repro_torch.models.attention import (
    paged_chunk_prefill_attention, paged_chunk_prefill_attention_quant)
from repro_torch.nn.layers import apply_rope
from repro_torch.nn.spec import init_params

Tree = Any

_QUANT_NAMES = ("k_pages", "v_pages", "k_scales", "v_scales")
_NAMES = ("k_pages", "v_pages")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    @functools.cached_property
    def spec(self):
        return lm.build_spec(self.cfg)

    @functools.cached_property
    def _ropes(self) -> dict:
        """(length, device) -> rope tables, built once per length: eager
        torch has no trace to hoist them out of the decode loop."""
        return {}

    # ------------------------------------------------------------- params
    def init(self, seed: int = 0, param_dtype=torch.bfloat16, device=None):
        """Seeded parameters (``repro_torch.nn.spec.init_params``)."""
        return init_params(self.spec, seed, param_dtype, device)

    # ------------------------------------------------------------- caches
    @property
    def supports_paged(self) -> bool:
        """Paged KV serving covers the pure-attention family."""
        return self.cfg.block_kind == "attn" and not self.cfg.cross_attention

    @property
    def supports_embed_spans(self) -> bool:
        return self.supports_paged

    @property
    def supports_bucketed_prefill(self) -> bool:
        """Padded prefill needs a positional cache (attention family)."""
        return self.cfg.block_kind == "attn"

    @property
    def supports_chunked_prefill(self) -> bool:
        return self.supports_paged

    def abstract_paged_cache(self, num_pages: int, block_size: int,
                             kv_dtype: str = "bf16"):
        """The paged cache's leaves as ``meta`` tensors (shape and dtype,
        no storage): bf16 pools, or int8 pools plus fp32 scales sharing
        the page axis, so page bookkeeping moves values and scales
        together."""
        cfg = self.cfg
        if not self.supports_paged:
            raise ValueError(f"{cfg.name}: paged KV cache needs attn family")
        if kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype must be 'bf16' or 'int8', "
                             f"got {kv_dtype!r}")
        shape = (cfg.n_layers, num_pages, block_size, cfg.n_kv_heads, cfg.hd)

        def meta(s, dt):
            return torch.empty(s, dtype=dt, device="meta")

        if kv_dtype == "int8":
            return {"k_pages": meta(shape, torch.int8),
                    "v_pages": meta(shape, torch.int8),
                    "k_scales": meta(shape[:-1], torch.float32),
                    "v_scales": meta(shape[:-1], torch.float32)}
        return {"k_pages": meta(shape, torch.bfloat16),
                "v_pages": meta(shape, torch.bfloat16)}

    @property
    def kv_geometry(self) -> "tuple[int, int, int]":
        """(n_layers, n_kv_heads, head_dim): the page shape minus the page
        axes."""
        cfg = self.cfg
        return (cfg.n_layers, cfg.n_kv_heads, cfg.hd)

    # ------------------------------------------------------------- layers
    def _decode_layer(self, pl, x, kv, pos, rope, window, attend):
        """One decode layer; ``attend(q1, k1, v1, kv, window) -> o`` owns
        the cache write and the attention contraction."""
        cfg = self.cfg
        B = x.shape[0]
        cos, sin = rope
        xn = lm._norm(pl, x[:, None], cfg.norm, "ln1")
        q, k, v = lm._qkv(pl["attn"], cfg, xn, B, 1)
        q = apply_rope(q, cos, sin, pos[:, None])
        k = apply_rope(k, cos, sin, pos[:, None])
        o = attend(q[:, 0], k[:, 0], v[:, 0], kv, window)
        o = lm._attn_out(pl["attn"], cfg, o.reshape(B, -1), x.dtype)
        if cfg.post_norms:
            o = lm._norm(pl, o, cfg.norm, "pn1")
        return lm._ffn(pl, cfg, (x + o)[:, None])[:, 0]

    def _chunk_layer(self, pl, x, kv, qpos, rope, window, attend):
        """One chunked-prefill layer: ``_decode_layer`` with a C-token
        chunk of queries. x [B, C, d]; qpos [B, C]."""
        cfg = self.cfg
        B, C, _ = x.shape
        cos, sin = rope
        xn = lm._norm(pl, x, cfg.norm, "ln1")
        q, k, v = lm._qkv(pl["attn"], cfg, xn, B, C)
        q = apply_rope(q, cos, sin, qpos)
        k = apply_rope(k, cos, sin, qpos)
        o = attend(q, k, v, kv, window)
        o = lm._attn_out(pl["attn"], cfg, o.reshape(B, C, -1), x.dtype)
        if cfg.post_norms:
            o = lm._norm(pl, o, cfg.norm, "pn1")
        return lm._ffn(pl, cfg, x + o)

    def _rope(self, length: int, device):
        key = (length, str(device))
        if key not in self._ropes:
            self._ropes[key] = lm._rope_tables(self.cfg, length, device)
        return self._ropes[key]

    def _run_layers(self, params, x, pos, kv_all, rope_len, attend,
                    layer_fn):
        """Walk the layers in order; ``kv_all`` holds the cache leaves
        stacked on dim 0 and each layer gets its own slice (a view)."""
        cfg = self.cfg
        rope_l, rope_g = self._rope(rope_len, x.device)
        layers = params["layers"]
        for i, is_global in enumerate(lm.static_layer_windows(cfg)):
            pl = _layer_slice(layers, i)
            x = layer_fn(pl, x, tuple(c[i] for c in kv_all), pos,
                         rope_g if is_global else rope_l,
                         0 if is_global else cfg.window, attend)
        return x

    # ------------------------------------------------------------- decode
    def serve_step_paged(self, params, cache, batch):
        """One token for the whole batch against the paged KV cache.

        cache  = the bf16 pools, or the int8 pools with their scales;
        batch  = {tokens [B], pos [B] int32, block_tables [B, NB] int32}.

        The new K/V row of slot b lands in page ``tables[b, pos // bs]``,
        clamped to the null page 0 for inactive slots (all -1 rows, pos 0).
        Several inactive slots then write row 0 of page 0; on CUDA the
        winner of such duplicate ``index_put_`` writes is undefined, which
        is harmless because page 0 is never read unmasked.  On the int8
        path the rows are quantized first and their scales written at the
        same (page, offset).  Attention then runs the paged decode kernel
        (its plain version for CPU tensors).  Returns (logits [B, V] fp32,
        cache).
        """
        cfg = self.cfg
        tokens, pos = batch["tokens"], batch["pos"]
        tables = batch["block_tables"]
        B = tokens.shape[0]
        bs = cache["k_pages"].shape[2]
        NB = tables.shape[1]
        quant = "k_scales" in cache
        x = lm.embed_tokens(cfg, params, tokens)  # [B, d]
        rows = torch.arange(B, device=tables.device)
        page = tables[rows, (pos // bs).long()].long().clamp(min=0)
        off = (pos % bs).long()

        def attend(q1, k1, v1, kv, window):
            q1 = q1.contiguous()
            if quant:
                kp, vp, ksc, vsc = kv
                k8, k1s = quantize_kv(k1)  # [B, Hkv, D] -> int8 + [B, Hkv]
                v8, v1s = quantize_kv(v1)
                kp[page, off] = k8
                vp[page, off] = v8
                ksc[page, off] = k1s
                vsc[page, off] = v1s
                return ops.paged_decode_quant(q1, kp, vp, ksc, vsc, tables,
                                              pos, window=window)
            kp, vp = kv
            kp[page, off] = k1.to(kp.dtype)
            vp[page, off] = v1.to(vp.dtype)
            return ops.paged_decode(q1, kp, vp, tables, pos, window=window)

        names = _QUANT_NAMES if quant else _NAMES
        x = self._run_layers(params, x, pos, tuple(cache[n] for n in names),
                             NB * bs, attend, self._decode_layer)
        x = lm._norm(params, x, cfg.norm, "final")
        return lm.last_logits(cfg, params, x), cache

    # ------------------------------------------------------- chunked prefill
    def prefill_chunk_paged(self, params, cache, batch):
        """One bucketed prefill chunk into a paged-cache block table.

        batch = {tokens [1, C] (right-padded to the chunk bucket),
                 block_tables [1, NB] int32 (covering ``pos + length``),
                 pos int (tokens already in the cache), length int (true
                 chunk length)}.

        Write-then-attend: the first ``length`` columns' K/V are written
        into their pages (int8 pools: quantized first) and the chunk
        attends back through the block table.  The JAX package drops the
        padded columns' writes through an out-of-bounds page id; here they
        are sliced off before the write, which stores the same rows.
        Returns (logits [1, V] of the chunk's last real token, cache).
        """
        cfg = self.cfg
        tokens, tables = batch["tokens"], batch["block_tables"]
        pos0, n = int(batch["pos"]), int(batch["length"])
        B, C = tokens.shape
        bs = cache["k_pages"].shape[2]
        NB = tables.shape[1]
        quant = "k_scales" in cache
        x = lm.embed_inputs(cfg, params, tokens, batch.get("embeds"),
                            batch.get("embed_mask"))  # [1, C, d]
        dev = tokens.device
        positions = pos0 + torch.arange(C, device=dev)  # [C]
        blk = (positions[:n] // bs).clamp(max=NB - 1)
        page = tables[0, blk].long().clamp(min=0)
        off = positions[:n] % bs
        qpos = positions[None]  # [1, C]

        def attend(q, k, v, kv, window):
            if quant:
                kp, vp, ksc, vsc = kv
                k8, k1s = quantize_kv(k[0, :n])  # [n, Hkv, D] + [n, Hkv]
                v8, v1s = quantize_kv(v[0, :n])
                kp[page, off] = k8
                vp[page, off] = v8
                ksc[page, off] = k1s
                vsc[page, off] = v1s
                return paged_chunk_prefill_attention_quant(
                    q, kp, vp, ksc, vsc, tables, qpos, window=window)
            kp, vp = kv
            kp[page, off] = k[0, :n].to(kp.dtype)
            vp[page, off] = v[0, :n].to(vp.dtype)
            return paged_chunk_prefill_attention(q, kp, vp, tables, qpos,
                                                 window=window)

        names = _QUANT_NAMES if quant else _NAMES
        x = self._run_layers(params, x, qpos,
                             tuple(cache[n_] for n_ in names), NB * bs,
                             attend, self._chunk_layer)
        x = lm._norm(params, x[:, n - 1], cfg.norm, "final")
        return lm.last_logits(cfg, params, x), cache


def _layer_slice(tree, i: int):
    """Layer ``i`` of a layer-stacked parameter dict (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
