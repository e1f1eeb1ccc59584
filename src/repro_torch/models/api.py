"""Public model API of the attention family, dense and MoE, and of the
zamba2 hybrid: spec/init, the paged and dense KV cache layouts, monolithic
prefill (with embedding spans and, on a prefix-cache hit, against cached
prefix K/V), chunked prefill into either cache, the batched paged and
dense decode steps, the speculative verify step and the export and import
of a request's pages (ports of ``repro/models/api.py``).  The dense
decode step serves the engine's dense backend and the speculative draft
model; its attention runs the flash-decode kernel on the card.

zamba2 (``block_kind="mamba_hybrid"``) has the dense cache only, with
exact-shape monolithic prefill, as in the JAX package: conv windows
``conv`` [G, P, B, W-1, Ch] bf16 and SSM states ``ssm`` [G, P, B, nh, p,
N] fp32 per Mamba2 layer (G groups of P), the shared block's ``k``/``v``
[G, B, Sa, Hkv, Dh] bf16 per group and ``pos_map``.  Its prefill runs the
SSD-scan kernel in every Mamba2 layer and the flash-attention kernel in
every shared block; its decode step the flash-decode kernel in every
shared block.

Paged cache layout: ``k_pages``/``v_pages`` [L, P, bs, Hkv, Dh] bf16, or
int8 with fp32 row scales ``k_scales``/``v_scales`` [L, P, bs, Hkv]
(``kv_dtype="int8"``); a per-slot block table [B, NB] int32 maps logical
block ``j`` to a page id (-1 = unallocated).  Dense cache layout: ``k``/
``v`` [L, B, Sa, Hkv, Dh] bf16 and ``pos_map`` [B, Sa] int32 (the position
held by each cache entry, -1 = empty).

Where the JAX package drops a write through an out-of-bounds index (a
parked slot at ``pos = max_seq``, a verify row past the block table), the
port writes the entry's old value back through a clamped index instead
(``_masked_write``): torch raises on such indices, and the clamped rows
never collide with a live row's write.

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
from repro_torch.kernels.quant import dequantize_kv, quantize_kv
from repro_torch.kernels.ssd_scan import chunk_length
from repro_torch.models import lm
from repro_torch.models import mamba2 as m2
from repro_torch.models.attention import chunk_prefill_attention
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
    def abstract_cache(self, B: int, Sa: int):
        """The dense cache's leaves as ``meta`` tensors: k/v
        [L, B, Sa, Hkv, Dh] bf16 and pos_map [B, Sa] int32; for zamba2 also
        conv [G, P, B, W-1, Ch] bf16 and ssm [G, P, B, nh, p, N] fp32, with
        k/v per group [G, B, Sa, Hkv, Dh]."""
        cfg = self.cfg
        if not lm.ported_family(cfg):
            raise NotImplementedError(
                f"{cfg.name}: dense caches of the xlstm and encoder-decoder "
                "families are not ported to repro_torch yet (ROADMAP queue 1 "
                "item 11 B)")

        def meta(shape, dt):
            return torch.empty(shape, dtype=dt, device="meta")

        kv = (cfg.n_layers, B, Sa, cfg.n_kv_heads, cfg.hd)
        out = {}
        if cfg.block_kind == "mamba_hybrid":
            G, P = lm.zamba2_groups(cfg)
            Ch = cfg.d_inner + 2 * cfg.ssm_state
            nh = cfg.d_inner // cfg.ssm_headdim
            kv = (G,) + kv[1:]
            out["conv"] = meta((G, P, B, cfg.conv_width - 1, Ch),
                               torch.bfloat16)
            out["ssm"] = meta((G, P, B, nh, cfg.ssm_headdim, cfg.ssm_state),
                              torch.float32)
        out["k"] = meta(kv, torch.bfloat16)
        out["v"] = meta(kv, torch.bfloat16)
        out["pos_map"] = meta((B, Sa), torch.int32)
        return out

    @property
    def supports_paged(self) -> bool:
        """Paged KV serving covers the pure-attention family; zamba2's
        recurrent states live in the dense cache."""
        return self.cfg.block_kind == "attn" and not self.cfg.cross_attention

    @property
    def supports_embed_spans(self) -> bool:
        """Embedding spans need the attention family (zamba2's recurrent
        state updates are fused with its token scans)."""
        return self.supports_paged

    @property
    def supports_bucketed_prefill(self) -> bool:
        """Padded prefill needs a positional cache (attention family): a
        recurrent state integrates every input token, padding included."""
        return self.cfg.block_kind == "attn"

    @property
    def supports_chunked_prefill(self) -> bool:
        return self.supports_paged

    def check_prompt_length(self, T: int):
        """Raise ValueError for a prompt length the model cannot prefill:
        zamba2's SSD scan takes a prompt past ``scan_chunk`` only in whole
        chunks (``ssd_scan.chunk_length``)."""
        if self.cfg.block_kind == "mamba_hybrid":
            chunk_length(T, self.cfg.scan_chunk, "scan_chunk")

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

    def export_paged_kv(self, cache, pages) -> dict:
        """Gather ``pages`` (a request's block table, in logical block
        order) out of the paged pool to the host: one CPU tensor per cache
        leaf, page axis in logical block order — ``k_pages``/``v_pages``
        [L, NB, bs, Hkv, Dh] plus ``k_scales``/``v_scales`` [L, NB, bs,
        Hkv] for an int8 pool.  The storage form is copied verbatim (bf16
        rows, or int8 rows and fp32 scales; numpy has no bfloat16, so the
        host form is torch's), so a same-precision import reads the
        source's bits.  The copy is complete when this returns
        (``Tensor.cpu`` waits for the card), so the caller may release the
        pages after it."""
        dev = cache["k_pages"].device
        idx = torch.as_tensor(list(pages), dtype=torch.long, device=dev)
        return {name: leaf[:, idx].cpu() for name, leaf in cache.items()}

    def import_paged_kv(self, cache, pages, leaves, src_dtype: str, *,
                        from_block: int = 0):
        """Scatter exported logical blocks ``[from_block, from_block +
        len(pages))`` of ``leaves`` (``export_paged_kv``'s layout) into
        this pool at page ids ``pages``, converting precision where the
        source form differs from the pool's:

          * int8 -> int8 and bf16 -> bf16: the rows (and scales) verbatim;
          * bf16 -> int8: ``quantize_kv``, the engine's own write recipe;
          * int8 -> bf16: ``dequantize_kv`` to bf16.

        The pool is updated in place; returns the cache dict."""
        quant = "k_scales" in cache
        lo, hi = from_block, from_block + len(pages)
        dev = cache["k_pages"].device
        idx = torch.as_tensor(list(pages), dtype=torch.long, device=dev)

        def blocks(name):
            return leaves[name][:, lo:hi].to(dev)

        if src_dtype == "int8" and quant:
            upd = {name: blocks(name) for name in _QUANT_NAMES}
        elif src_dtype == "int8":
            upd = {name: dequantize_kv(blocks(name), blocks(sname),
                                       dtype=torch.bfloat16)
                   for name, sname in (("k_pages", "k_scales"),
                                       ("v_pages", "v_scales"))}
        elif quant:
            k8, ks = quantize_kv(blocks("k_pages"))
            v8, vs = quantize_kv(blocks("v_pages"))
            upd = {"k_pages": k8, "v_pages": v8,
                   "k_scales": ks, "v_scales": vs}
        else:
            upd = {name: blocks(name) for name in _NAMES}
        for name, val in upd.items():
            cache[name][:, idx] = val.to(cache[name].dtype)
        return cache

    # ------------------------------------------------------------ prefill
    def prefill(self, params, batch):
        """Monolithic prefill of a whole prompt batch: (last-token logits
        [B, V], dense cache {k, v [L, B, S, Hkv, Dh], pos_map [B, S]}; for
        zamba2 also conv and ssm, with k/v per group).

        ``batch["length"]`` [B] int32 optionally carries the true prompt
        lengths of a batch right-padded to a shape bucket: pos_map marks
        the padding empty (-1) and the logits are taken at ``length - 1``;
        causal masking keeps the padding out of every real position.
        ``batch["embeds"]`` [B, S, d] and ``batch["embed_mask"]`` [B, S]
        optionally inject embedding spans (``lm.embed_inputs``).  zamba2
        takes neither (ValueError, as in the JAX package), and a prompt
        past ``scan_chunk`` only in whole chunks (ValueError).
        """
        cfg = self.cfg
        tokens, length = batch["tokens"], batch.get("length")
        embeds = batch.get("embeds")
        B, S = tokens.shape
        if length is not None and not self.supports_bucketed_prefill:
            raise ValueError(
                f"{cfg.name}: bucketed (padded) prefill needs a positional "
                "cache; recurrent state would integrate the padding")
        if embeds is not None and not self.supports_embed_spans:
            raise ValueError(
                f"{cfg.name}: embedding-span prefill needs the attention "
                "family (see Model.supports_embed_spans)")
        if length is None:
            pos_map = torch.arange(S, dtype=torch.int32,
                                   device=tokens.device).expand(B, S)
        else:
            pos_map = lm.prompt_pos_map(length, S)
        if cfg.block_kind == "mamba_hybrid":
            h, ((conv, ssm), (k, v)) = lm.zamba2_forward(
                cfg, params, tokens, return_cache=True)
            cache = {"conv": conv, "ssm": ssm, "k": k, "v": v,
                     "pos_map": pos_map}
        elif lm.ported_family(cfg):
            h, (k, v) = lm.attn_forward(cfg, params, tokens,
                                        return_cache=True, embeds=embeds,
                                        embed_mask=batch.get("embed_mask"))
            cache = {"k": k, "v": v, "pos_map": pos_map}
        else:
            raise NotImplementedError(
                f"{cfg.name}: prefill of the xlstm and encoder-decoder "
                "families is not ported to repro_torch yet (ROADMAP queue 1 "
                "item 11 B)")
        logits = lm.last_logits(cfg, params, lm.last_hidden(h, length))
        return logits, cache

    def prefill_with_prefix(self, params, batch, prefix_k, prefix_v):
        """Suffix prefill against cached prefix K/V (the paged engine's
        monolithic prefix-hit path).

        ``batch["tokens"]`` [B, Ssfx] are the tokens after the prefix;
        ``prefix_k``/``prefix_v`` [L, B, Spre, Hkv, Dh] hold the prefix
        K/V, already rope'd.  ``batch["length"]`` [B] optionally carries
        the true suffix length of a bucket-padded suffix (the caller then
        scatters only the first ``length`` columns); ``batch["embeds"]``/
        ``batch["embed_mask"]`` inject the suffix's embedding spans.
        Every layer's attention is one flash-attention call over
        ``Sk = Spre + Ssfx`` keys.  Returns (last-token logits [B, V],
        (k_sfx, v_sfx) [L, B, Ssfx, Hkv, Dh])."""
        cfg = self.cfg
        if not self.supports_paged:
            raise ValueError(f"{cfg.name}: prefix prefill needs attn family")
        h, (k, v) = lm.attn_forward(cfg, params, batch["tokens"],
                                    return_cache=True,
                                    prefix_kv=(prefix_k, prefix_v),
                                    embeds=batch.get("embeds"),
                                    embed_mask=batch.get("embed_mask"))
        logits = lm.last_logits(cfg, params,
                                lm.last_hidden(h, batch.get("length")))
        return logits, (k, v)

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
        if not cfg.n_experts:
            return lm._ffn(pl, cfg, (x + o)[:, None])[:, 0]
        # the JAX decode layer calls moe_apply on the B tokens directly,
        # without moe_scan_chunks or dispatch_axes
        y = x + o
        f = lm.moe(pl, cfg, lm._norm(pl, y[:, None], cfg.norm, "ln2")[:, 0])
        if cfg.post_norms:
            f = lm._norm(pl, f, cfg.norm, "pn2")
        return y + f

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
            pl = lm.layer_slice(layers, i)
            x = layer_fn(pl, x, tuple(c[i] for c in kv_all), pos,
                         rope_g if is_global else rope_l,
                         0 if is_global else cfg.window, attend)
        return x

    # ------------------------------------------------------------- decode
    def serve_step(self, params, cache, batch):
        """One token for the whole batch against the dense cache (the
        engine's dense backend and the speculative draft model's step).
        batch = {tokens [B], pos [B]}; a slot parked at ``pos >= Sa``
        writes nothing (the JAX package's out-of-bounds drop) and its
        logits are garbage nobody reads.  Attention runs
        ``ops.flash_decode`` over each layer's cache view (the CUDA kernel
        on the card, its plain version on the CPU); zamba2 dispatches to
        ``_zamba2_decode``.  The cache is updated in place; returns
        (logits [B, V] fp32, cache)."""
        cfg = self.cfg
        if not lm.ported_family(cfg):
            raise NotImplementedError(
                f"{cfg.name}: dense decode of the xlstm and encoder-decoder "
                "families is not ported to repro_torch yet (ROADMAP queue 1 "
                "item 11 B)")
        tokens, pos = batch["tokens"], batch["pos"].long()
        x = lm.embed_tokens(cfg, params, tokens)  # [B, d]
        B = x.shape[0]
        Sa = cache["k"].shape[2]
        rows = torch.arange(B, device=pos.device)
        live = pos < Sa
        wpos = pos.clamp(max=Sa - 1)
        pos_map = cache["pos_map"]
        _masked_write(pos_map, (rows, wpos), pos.to(pos_map.dtype), live)
        pos32 = pos.to(torch.int32)
        if cfg.block_kind == "mamba_hybrid":
            return self._zamba2_decode(params, cache, x, wpos, rows, live,
                                       pos32)

        def attend(q1, k1, v1, kv, window):
            kc, vc = kv
            _masked_write(kc, (rows, wpos), k1, live)
            _masked_write(vc, (rows, wpos), v1, live)
            return ops.flash_decode(q1.contiguous(), kc, vc, pos_map, pos32,
                                    window=window)

        # rope positions clamp into the table, as a JAX gather does
        x = self._run_layers(params, x, wpos, (cache["k"], cache["v"]), Sa,
                             attend, self._decode_layer)
        x = lm._norm(params, x, cfg.norm, "final")
        return lm.last_logits(cfg, params, x), cache

    def _zamba2_decode(self, params, cache, x, wpos, rows, live, pos32):
        """zamba2's dense decode step (``api.py:786`` of the JAX package,
        with Python loops in place of its scans): every group's Mamba2
        layers advance their conv windows and SSM states by one token,
        then the shared block writes its K/V at ``wpos`` (nothing for a
        parked slot, ``live`` False) and attends through the flash-decode
        kernel.  States are updated in place; the conv leaf first takes
        the activation type where it differs (the JAX step returns its
        conv windows in the promoted type, which the engine keeps)."""
        cfg = self.cfg
        x0 = x
        Sa = cache["k"].shape[2]
        rope, _ = self._rope(Sa, x.device)
        conv, ssm = cache["conv"], cache["ssm"]
        dt = torch.promote_types(conv.dtype, x.dtype)
        if conv.dtype != dt:
            conv = conv.to(dt)
        pos_map = cache["pos_map"]
        G, P = lm.zamba2_groups(cfg)
        for g in range(G):
            pm = lm.layer_slice(params["mamba"], g)
            for i in range(P):
                y, cs, ss = m2.mamba2_decode(
                    lm.layer_slice(pm, i), x, conv[g, i], ssm[g, i],
                    n_state=cfg.ssm_state, headdim=cfg.ssm_headdim)
                conv[g, i] = cs
                ssm[g, i] = ss
                x = x + y
            kc, vc = cache["k"][g], cache["v"][g]

            def attend(q1, k1, v1, kc=kc, vc=vc):
                _masked_write(kc, (rows, wpos), k1, live)
                _masked_write(vc, (rows, wpos), v1, live)
                return ops.flash_decode(q1.contiguous(), kc, vc, pos_map,
                                        pos32)

            x, _ = lm._shared_attn_apply(cfg, params["shared_attn"], x, x0,
                                         rope, wpos[:, None], attend=attend)
        x = lm._norm(params, x, cfg.norm, "final")
        return lm.last_logits(cfg, params, x), {**cache, "conv": conv}

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

    # ---------------------------------------------------------- verify
    def verify_step_paged(self, params, cache, batch):
        """Score T candidate tokens per slot in one pass (the speculative
        verify) against the paged KV cache.

        batch = {tokens [B, T], pos [B] int32, block_tables [B, NB] int32}:
        ``tokens[:, 0]`` is the last accepted token, landing at ``pos``,
        and ``tokens[:, 1:]`` the draft's k = T-1 candidates.
        Write-then-attend: token t's K/V goes to page
        ``tables[b, (pos+t)//bs]`` (int8 pools: quantized first), except
        rows whose block runs past the table or is unallocated (parked
        slots), which write nothing; then the T queries attend causally
        through ``ops.paged_verify(_quant)`` (the CUDA kernel on the card,
        its plain version on the CPU).  Returns (logits [B, T, V] fp32,
        cache): ``argmax(logits[:, t])`` is the target's next token given
        ``tokens[:, :t+1]``.  Rejected drafts leave their K/V past the
        accepted position, masked by every later read and overwritten as
        decoding reaches them.
        """
        cfg = self.cfg
        tokens, pos = batch["tokens"], batch["pos"]
        tables = batch["block_tables"]
        B, T = tokens.shape
        bs = cache["k_pages"].shape[2]
        NB = tables.shape[1]
        quant = "k_scales" in cache
        x = lm.embed_tokens(cfg, params, tokens)  # [B, T, d]
        positions = pos.long()[:, None] + torch.arange(T,
                                                       device=pos.device)
        blk = positions // bs
        page = tables.gather(1, blk.clamp(0, NB - 1)).long()
        live = (page >= 0) & (blk < NB)
        # dead rows point at the null page, which no live row writes
        idx = (torch.where(live, page, 0), positions % bs)

        def attend(q, k, v, kv, window):
            q = q.contiguous()
            if quant:
                kp, vp, ksc, vsc = kv
                k8, k1s = quantize_kv(k)  # [B,T,Hkv,D] -> int8 + [B,T,Hkv]
                v8, v1s = quantize_kv(v)
                for leaf, new in ((kp, k8), (vp, v8), (ksc, k1s),
                                  (vsc, v1s)):
                    _masked_write(leaf, idx, new, live)
                return ops.paged_verify_quant(q, kp, vp, ksc, vsc, tables,
                                              pos, window=window)
            kp, vp = kv
            _masked_write(kp, idx, k, live)
            _masked_write(vp, idx, v, live)
            return ops.paged_verify(q, kp, vp, tables, pos, window=window)

        names = _QUANT_NAMES if quant else _NAMES
        # rope positions clamp into the table, as a JAX gather does
        x = self._run_layers(params, x, positions.clamp(max=NB * bs - 1),
                             tuple(cache[n] for n in names), NB * bs,
                             attend, self._chunk_layer)
        x = lm._norm(params, x, cfg.norm, "final")
        return lm.last_logits(cfg, params, x), cache

    # ------------------------------------------------------- chunked prefill
    def prefill_chunk_dense(self, params, cache, batch):
        """One bucketed prefill chunk into one dense-cache slot.

        cache = the engine's dense cache {k, v [L, B, Sa, Hkv, Dh],
        pos_map [B, Sa]}; batch = {tokens [1, C] (right-padded to the
        chunk bucket), slot int, pos int (tokens already in the slot),
        length int (true chunk length)}, plus optional ``embeds``/
        ``embed_mask`` [1, C, d] / [1, C] for the chunk's slice of a
        prompt's embedding spans.

        Write-then-attend: the first ``length`` columns' K/V and positions
        are written at ``[pos, pos + length)`` of row ``slot`` (the JAX
        package drops the padded columns' writes out of bounds; here they
        are sliced off, which stores the same rows), then the chunk
        attends back through the whole slot with the plain
        ``chunk_prefill_attention`` (the JAX package has no kernel for
        it either): in-chunk causality falls out of the pos_map mask.
        Returns (logits [1, V] of the chunk's last real token, cache).
        """
        cfg = self.cfg
        tokens, slot = batch["tokens"], int(batch["slot"])
        pos0, n = int(batch["pos"]), int(batch["length"])
        B, C = tokens.shape
        Sa = cache["k"].shape[2]
        x = lm.embed_inputs(cfg, params, tokens, batch.get("embeds"),
                            batch.get("embed_mask"))  # [1, C, d]
        positions = pos0 + torch.arange(C, device=tokens.device)  # [C]
        qpos = positions[None]  # [1, C]
        pos_map = cache["pos_map"]
        pos_map[slot, pos0:pos0 + n] = positions[:n].to(pos_map.dtype)

        def attend(q, k, v, kv, window):
            kc, vc = kv
            kc[slot, pos0:pos0 + n] = k[0, :n].to(kc.dtype)
            vc[slot, pos0:pos0 + n] = v[0, :n].to(vc.dtype)
            return chunk_prefill_attention(q, kc[slot][None], vc[slot][None],
                                           pos_map[slot][None], qpos,
                                           window=window)

        # rope positions clamp into the table, as a JAX gather does
        x = self._run_layers(params, x, qpos.clamp(max=Sa - 1),
                             (cache["k"], cache["v"]), Sa, attend,
                             self._chunk_layer)
        x = lm._norm(params, x[:, n - 1], cfg.norm, "final")
        return lm.last_logits(cfg, params, x), cache

    def prefill_chunk_paged(self, params, cache, batch):
        """One bucketed prefill chunk into a paged-cache block table.

        batch = {tokens [1, C] (right-padded to the chunk bucket),
                 block_tables [1, NB] int32 (covering ``pos + length``),
                 pos int (tokens already in the cache), length int (true
                 chunk length)}.

        Write-then-attend: the first ``length`` columns' K/V are written
        into their pages (int8 pools: quantized first) and the chunk
        attends back through the block table with ``ops.paged_verify
        (_quant)``: chunk column t sits at ``pos + t``, the verify
        kernel's query layout, so the CUDA kernel runs here on the card
        (its plain version on the CPU is the JAX package's chunked-prefill
        attention).  The JAX package drops the padded columns' writes
        through an out-of-bounds page id; here they are sliced off before
        the write, which stores the same rows.  The padded columns' rows
        read stale keys; only column ``length - 1`` reaches the logits.
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
        pos = torch.tensor([pos0], dtype=torch.int32, device=dev)

        def attend(q, k, v, kv, window):
            q = q.contiguous()
            if quant:
                kp, vp, ksc, vsc = kv
                k8, k1s = quantize_kv(k[0, :n])  # [n, Hkv, D] + [n, Hkv]
                v8, v1s = quantize_kv(v[0, :n])
                kp[page, off] = k8
                vp[page, off] = v8
                ksc[page, off] = k1s
                vsc[page, off] = v1s
                return ops.paged_verify_quant(q, kp, vp, ksc, vsc, tables,
                                              pos, window=window)
            kp, vp = kv
            kp[page, off] = k[0, :n].to(kp.dtype)
            vp[page, off] = v[0, :n].to(vp.dtype)
            return ops.paged_verify(q, kp, vp, tables, pos, window=window)

        names = _QUANT_NAMES if quant else _NAMES
        # rope positions clamp into the table, as a JAX gather does: a
        # padded chunk may run past max_seq (a prefix hit leaves pos0 off
        # the chunk grid)
        x = self._run_layers(params, x, qpos.clamp(max=NB * bs - 1),
                             tuple(cache[n_] for n_ in names), NB * bs,
                             attend, self._chunk_layer)
        x = lm._norm(params, x[:, n - 1], cfg.norm, "final")
        return lm.last_logits(cfg, params, x), cache


def _masked_write(leaf, idx, new, live):
    """``leaf[idx] = new`` where ``live``, the old value elsewhere: a
    write that drops the rows a JAX scatter drops out of bounds, without
    a host sync.  ``idx`` must keep dead rows off every live row's
    target; dead rows that share a target all write its old value."""
    old = leaf[idx]
    mask = live.reshape(live.shape + (1,) * (old.dim() - live.dim()))
    leaf[idx] = torch.where(mask, new.to(leaf.dtype), old)


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
