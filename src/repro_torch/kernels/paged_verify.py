"""Paged multi-token verify attention: wrappers of the hand-written CUDA
kernel ``csrc/paged_verify.cu`` and their plain PyTorch versions.

The kernel replaces the Pallas TPU kernels ``paged_verify_tpu`` and
``paged_verify_quant_tpu`` (``repro/kernels/paged_verify.py:95,147``).
The serving path calls it for the speculative verify pass
(``Model.verify_step_paged``) and for the attention of every chunked
prefill (``Model.prefill_chunk_paged``, whose queries sit at
``pos + arange(C)``).  The source note in the ``.cu`` file says what
bounds it on an H100 and what its design does about that.

``paged_verify``/``paged_verify_quant`` take the JAX signatures.  For
tensors on the CPU they run the plain version; for CUDA tensors they
launch the kernel or raise, never falling back.  Each wrapper counts its
kernel launches in its ``launches`` attribute (a plain integer).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import on_cpu
from repro_torch.kernels import build
from repro_torch.kernels.paged_decode import (PAGE_DTYPES, Q_DTYPES,
                                              check_paged_args,
                                              score_scratch)
from repro_torch.models.attention import (paged_verify_attention,
                                          paged_verify_attention_quant)

MAX_TOKENS = 1024  # query tokens per slot (T) the wrapper takes


def paged_verify_ref(q, k_pages, v_pages, block_tables, pos, *, window=0):
    """Plain version: gather through the block table, then causal softmax
    attention with query t at ``pos + t``
    (``models.attention.paged_verify_attention``)."""
    return paged_verify_attention(q, k_pages, v_pages, block_tables, pos,
                                  window=window)


def paged_verify_quant_ref(q, k_pages, v_pages, k_scales, v_scales,
                           block_tables, pos, *, window=0):
    """Plain version over the int8 pool: gather, dequantize, attend."""
    return paged_verify_attention_quant(q, k_pages, v_pages, k_scales,
                                        v_scales, block_tables, pos,
                                        window=window)


@functools.cache
def _lib():
    """The built library, with its C signatures declared (pointers and the
    stream as ``c_void_p``, so ctypes does not cut them to 32 bits)."""
    lib = build.load("paged_verify")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.paged_verify_launch.argtypes = (
        [i32, i32] + [ptr] * 9 + [i32] * 8 + [ctypes.c_float, ptr])
    lib.paged_verify_launch.restype = i32
    lib.paged_verify_smem_bytes.argtypes = [i32, i32, i32]
    lib.paged_verify_smem_bytes.restype = i32
    lib.paged_verify_tile_rows.argtypes = []
    lib.paged_verify_tile_rows.restype = i32
    return lib


def smem_bytes(D: int, bs: int, score_words: int = 0) -> int:
    """Dynamic shared memory one CTA of the kernel takes for head dim D and
    page size bs, with ``score_words`` fp32 scores kept there
    (tile_rows() * NB * bs, or 0 when they go to global memory), from the
    built library."""
    return _lib().paged_verify_smem_bytes(D, bs, score_words)


def tile_rows() -> int:
    """Query rows (token x query head) one CTA of the kernel takes."""
    return _lib().paged_verify_tile_rows()


def _launch(q, k_pages, v_pages, k_scales, v_scales, block_tables, pos,
            window):
    B, T, H, D = q.shape
    _, bs, Hkv, _ = k_pages.shape
    NB = block_tables.shape[1]
    if not 1 <= T <= MAX_TOKENS:
        raise ValueError(f"paged verify: {T} query tokens per slot, the "
                         f"kernel takes 1..{MAX_TOKENS}")
    lib = _lib()
    rows = tile_rows()
    ctas = B * Hkv * -(-T * (H // Hkv) // rows)
    scores = score_scratch("paged verify",
                           lambda words: smem_bytes(D, bs, words), ctas,
                           rows * NB * bs, q.device)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.paged_verify_launch(
            Q_DTYPES[q.dtype], PAGE_DTYPES[k_pages.dtype], q.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(),
            None if k_scales is None else k_scales.data_ptr(),
            None if v_scales is None else v_scales.data_ptr(),
            block_tables.data_ptr(), pos.data_ptr(),
            None if scores is None else scores.data_ptr(), out.data_ptr(), B,
            T, H, Hkv, D, bs, NB, int(window), D ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"paged verify kernel launch failed: error {err}")
    return out


def paged_verify(q, k_pages, v_pages, block_tables, pos, *, window=0):
    """q [B,T,H,D] fp32/bf16, query t of slot b at ``pos[b] + t``;
    k_pages/v_pages [P,bs,Hkv,D] bf16 (the plain version on the CPU also
    takes fp32); block_tables [B,NB] int32 (-1 = unallocated); pos [B]
    int32.  Returns [B,T,H,D] in q's dtype."""
    if on_cpu("paged verify", q, k_pages, v_pages, block_tables, pos):
        return paged_verify_ref(q, k_pages, v_pages, block_tables, pos,
                                window=window)
    check_paged_args("paged verify", "B,T,H,D", q, k_pages, v_pages,
                     block_tables, pos, window, ())
    out = _launch(q, k_pages, v_pages, None, None, block_tables, pos,
                  window)
    paged_verify.launches += 1
    return out


def paged_verify_quant(q, k_pages, v_pages, k_scales, v_scales,
                       block_tables, pos, *, window=0):
    """``paged_verify`` over int8 pages with fp32 row scales
    k_scales/v_scales [P,bs,Hkv], dequantized right after the load."""
    if on_cpu("paged verify", q, k_pages, v_pages, k_scales, v_scales,
              block_tables, pos):
        return paged_verify_quant_ref(q, k_pages, v_pages, k_scales,
                                      v_scales, block_tables, pos,
                                      window=window)
    check_paged_args("paged verify", "B,T,H,D", q, k_pages, v_pages,
                     block_tables, pos, window, (k_scales, v_scales))
    out = _launch(q, k_pages, v_pages, k_scales, v_scales, block_tables,
                  pos, window)
    paged_verify_quant.launches += 1
    return out


paged_verify.launches = 0
paged_verify_quant.launches = 0
