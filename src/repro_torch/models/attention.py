"""Plain PyTorch attention of the serving path (ports of
``repro/models/attention.py``).

Layouts: q [B, H, D] (decode) or [B, C, H, D] (chunk); caches
[B, S, Hkv, D]; page pools [P, bs, Hkv, D] addressed by block tables
[B, NB] (-1 = unallocated, clamped to the null page 0 and masked).

The softmax runs in fp32 and the probabilities are cast to the cache's
type before the value product, as the JAX functions do; a row with no
visible key gets the uniform softmax of ``NEG_INF`` fills (garbage the
callers never read).  These are the plain versions of the CUDA kernels
(``kernels/paged_decode.py``, ``kernels/paged_verify.py``), which the
serving path calls for decode, speculative verify and chunked-prefill
attention.

``flash_attention`` is the dispatching entry of whole-prompt attention
(``kernels/flash_attention.py``): the CUDA flash-attention kernel for
CUDA tensors, its plain version for CPU tensors.  The monolithic forward
(the draft model's prefill) calls it causal, the multimodal encoder's
trunk non-causal.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.quant import dequantize_kv

NEG_INF = -1e30


def decode_attention(q, k_cache, v_cache, cache_positions, pos, *,
                     window: int = 0, scale: float | None = None,
                     softcap: float = 0.0):
    """Single-token attention against a KV cache.

    q [B, H, D]; k_cache/v_cache [B, S, Hkv, D]; cache_positions [B, S]
    absolute position per cache slot (-1 = empty); pos [B] query position.
    """
    B, H, D = q.shape
    _, S, Hkv, _ = k_cache.shape
    G = H // Hkv
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) * scale
    s = s.reshape(B, H, S)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    valid = (cache_positions >= 0) & (cache_positions <= pos[:, None])
    if window:
        valid &= (pos[:, None] - cache_positions) < window
    s = torch.where(valid[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype).float()
    o = torch.einsum("bhgs,bshd->bhgd", p.reshape(B, Hkv, G, S),
                     v_cache.float())
    return o.reshape(B, H, D).to(q.dtype)


def chunk_prefill_attention(q, k_cache, v_cache, cache_positions, qpos, *,
                            window: int = 0, scale: float | None = None,
                            softcap: float = 0.0):
    """C query tokens against a KV cache that already holds the chunk's own
    K/V (write-then-attend): in-chunk causality falls out of the
    ``cache_positions <= qpos`` mask.

    q [B, C, H, D]; k_cache/v_cache [B, S, Hkv, D]; cache_positions [B, S]
    (-1 = empty); qpos [B, C] absolute query positions.
    """
    B, C, H, D = q.shape
    _, S, Hkv, _ = k_cache.shape
    G = H // Hkv
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, C, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bshd->bhgqs", qg, k_cache.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    valid = ((cache_positions >= 0)[:, None, :]
             & (cache_positions[:, None, :] <= qpos[:, :, None]))  # [B,C,S]
    if window:
        valid &= (qpos[:, :, None] - cache_positions[:, None, :]) < window
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype).float()
    o = torch.einsum("bhgqs,bshd->bqhgd", p, v_cache.float())
    return o.reshape(B, C, H, D).to(q.dtype)


def _gather_pages(pages, block_tables):
    """[P, bs, ...] pool -> [B, NB*bs, ...] through the block table, plus
    the logical position of every gathered row (-1 for unallocated
    blocks, whose rows come from the null page)."""
    B, NB = block_tables.shape
    bs = pages.shape[1]
    bt = block_tables.long().clamp(min=0)  # -1 -> null page, masked below
    gathered = pages[bt].reshape((B, NB * bs) + pages.shape[2:])
    logical = (torch.arange(NB, device=bt.device)[:, None] * bs
               + torch.arange(bs, device=bt.device)[None, :])  # [NB, bs]
    cpos = torch.where((block_tables >= 0)[:, :, None], logical[None], -1)
    return gathered, bt, cpos.reshape(B, NB * bs)


def _gather_kv(k_pages, v_pages, block_tables, k_scales=None,
               v_scales=None):
    kc, bt, cpos = _gather_pages(k_pages, block_tables)
    vc, _, _ = _gather_pages(v_pages, block_tables)
    if k_scales is not None:  # gather first, then dequantize: same values
        B, S = cpos.shape
        ks = k_scales[bt].reshape((B, S) + k_scales.shape[2:])
        vs = v_scales[bt].reshape((B, S) + v_scales.shape[2:])
        kc, vc = dequantize_kv(kc, ks), dequantize_kv(vc, vs)
    return kc, vc, cpos


def paged_chunk_prefill_attention(q, k_pages, v_pages, block_tables, qpos,
                                  *, window: int = 0,
                                  scale: float | None = None,
                                  softcap: float = 0.0):
    """Chunked-prefill attention against a paged KV cache (one layer).

    q [B, C, H, D]; k_pages/v_pages [P, bs, Hkv, D]; block_tables [B, NB];
    qpos [B, C].  The chunk's K/V must already be scattered into its pages.
    """
    kc, vc, cpos = _gather_kv(k_pages, v_pages, block_tables)
    return chunk_prefill_attention(q, kc, vc, cpos, qpos, window=window,
                                   scale=scale, softcap=softcap)


def paged_chunk_prefill_attention_quant(q, k_pages, v_pages, k_scales,
                                        v_scales, block_tables, qpos, *,
                                        window: int = 0,
                                        scale: float | None = None,
                                        softcap: float = 0.0):
    """``paged_chunk_prefill_attention`` over an int8 pool: the chunk reads
    the dequantized cache, exactly what decode will read later."""
    kc, vc, cpos = _gather_kv(k_pages, v_pages, block_tables, k_scales,
                              v_scales)
    return chunk_prefill_attention(q, kc, vc, cpos, qpos, window=window,
                                   scale=scale, softcap=softcap)


def paged_verify_attention(q, k_pages, v_pages, block_tables, pos, *,
                           window: int = 0, scale: float | None = None,
                           softcap: float = 0.0):
    """Multi-token verify attention against a paged KV cache (one layer):
    ``paged_chunk_prefill_attention`` with query ``t`` at ``pos + t``.

    q [B, T, H, D]; k_pages/v_pages [P, bs, Hkv, D]; block_tables [B, NB];
    pos [B] the position of each slot's first query.  The T tokens' K/V
    must already be in their pages (write-then-attend); row t then sees
    exactly what a sequential decode at ``pos + t`` would.  The plain
    version of ``kernels/csrc/paged_verify.cu``.
    """
    T = q.shape[1]
    qpos = pos[:, None] + torch.arange(T, device=pos.device)[None, :]
    return paged_chunk_prefill_attention(q, k_pages, v_pages, block_tables,
                                         qpos, window=window, scale=scale,
                                         softcap=softcap)


def paged_verify_attention_quant(q, k_pages, v_pages, k_scales, v_scales,
                                 block_tables, pos, *, window: int = 0,
                                 scale: float | None = None,
                                 softcap: float = 0.0):
    """``paged_verify_attention`` over an int8 pool with fp32 row scales:
    the same dequantized values the JAX function attends over (it
    dequantizes the whole pool, this the gathered rows)."""
    T = q.shape[1]
    qpos = pos[:, None] + torch.arange(T, device=pos.device)[None, :]
    return paged_chunk_prefill_attention_quant(
        q, k_pages, v_pages, k_scales, v_scales, block_tables, qpos,
        window=window, scale=scale, softcap=softcap)


def paged_decode_attention(q, k_pages, v_pages, block_tables, pos, *,
                           window: int = 0, scale: float | None = None,
                           softcap: float = 0.0):
    """Single-token attention against a paged KV cache (one layer): the
    gather path that the CUDA kernel in ``kernels/csrc/paged_decode.cu``
    computes without materializing the gathered cache.

    q [B, H, D]; k_pages/v_pages [P, bs, Hkv, D]; block_tables [B, NB];
    pos [B].  Key ``j*bs + t`` is visible if it is ``<= pos`` and, with a
    window, ``pos - key < window``.
    """
    kc, vc, cpos = _gather_kv(k_pages, v_pages, block_tables)
    return decode_attention(q, kc, vc, cpos, pos, window=window,
                            scale=scale, softcap=softcap)


def paged_decode_attention_quant(q, k_pages, v_pages, k_scales, v_scales,
                                 block_tables, pos, *, window: int = 0,
                                 scale: float | None = None,
                                 softcap: float = 0.0):
    """``paged_decode_attention`` over an int8 pool with fp32 row scales
    [P, bs, Hkv] addressed by the same page ids."""
    kc, vc, cpos = _gather_kv(k_pages, v_pages, block_tables, k_scales,
                              v_scales)
    return decode_attention(q, kc, vc, cpos, pos, window=window,
                            scale=scale, softcap=softcap)
