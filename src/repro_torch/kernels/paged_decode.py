"""Paged decode attention: wrappers of the hand-written CUDA kernel
``csrc/paged_decode.cu`` and their plain PyTorch versions.

The kernel replaces the Pallas TPU kernels ``paged_decode_tpu`` and
``paged_decode_quant_tpu`` (``repro/kernels/paged_decode.py:92,137``).
On an H100 it is bound by the bytes of the visible K/V rows; the source
note in the ``.cu`` file says what its design does about that (reads the
pool in place, skips masked blocks, stages each page once per kv head for
all G query heads).

``paged_decode``/``paged_decode_quant`` take the JAX signatures.  For
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
from repro_torch.models.attention import (paged_decode_attention,
                                          paged_decode_attention_quant)

HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 16  # query heads per kv head
MAX_SMEM_BYTES = 227 * 1024  # per-block dynamic shared memory on Hopper

Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PAGE_DTYPES = {torch.bfloat16: 0, torch.int8: 1}  # the serving pools


def paged_decode_ref(q, k_pages, v_pages, block_tables, pos, *, window=0):
    """Plain version: gather through the block table, then softmax
    attention (``models.attention.paged_decode_attention``)."""
    return paged_decode_attention(q, k_pages, v_pages, block_tables, pos,
                                  window=window)


def paged_decode_quant_ref(q, k_pages, v_pages, k_scales, v_scales,
                           block_tables, pos, *, window=0):
    """Plain version over the int8 pool: gather, dequantize, attend."""
    return paged_decode_attention_quant(q, k_pages, v_pages, k_scales,
                                        v_scales, block_tables, pos,
                                        window=window)


@functools.cache
def _lib():
    """The built library, with its C signatures declared (pointers and the
    stream as ``c_void_p``, so ctypes does not cut them to 32 bits)."""
    lib = build.load("paged_decode")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.paged_decode_launch.argtypes = (
        [i32, i32] + [ptr] * 8 + [i32] * 7 + [ctypes.c_float, ptr])
    lib.paged_decode_launch.restype = i32
    lib.paged_decode_smem_bytes.argtypes = [i32, i32, i32]
    lib.paged_decode_smem_bytes.restype = i32
    return lib


def smem_bytes(G: int, D: int, bs: int) -> int:
    """Dynamic shared memory one CTA of the kernel takes for G query heads
    per kv head, head dim D and page size bs (from the built library)."""
    return _lib().paged_decode_smem_bytes(G, D, bs)


def check_paged_args(what, q_layout, q, k_pages, v_pages, block_tables, pos,
                     window, scales):
    """Raise ValueError for what the paged kernels do not take.  q has
    ``q_layout`` ("B,H,D" for decode, "B,T,H,D" for verify); pages
    [P, bs, Hkv, D] bf16, or int8 with fp32 ``scales`` (k, v)
    [P, bs, Hkv]."""
    if q.dim() != len(q_layout.split(",")) or k_pages.dim() != 4:
        raise ValueError(f"{what}: q {tuple(q.shape)} must be [{q_layout}] "
                         f"and pages {tuple(k_pages.shape)} [P,bs,Hkv,D]")
    B, (H, D) = q.shape[0], q.shape[-2:]
    P, bs, Hkv, Dk = k_pages.shape
    if v_pages.shape != k_pages.shape or Dk != D:
        raise ValueError(f"{what}: k/v pages and q disagree: "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}, "
                         f"D={D}")
    if H % Hkv or H // Hkv > MAX_GROUP:
        raise ValueError(f"{what}: H={H}, Hkv={Hkv}: the kernel takes "
                         f"G = H/Hkv integral and <= {MAX_GROUP}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {D} not in {HEAD_DIMS}")
    if q.dtype not in Q_DTYPES:
        raise ValueError(f"{what}: q dtype {q.dtype} not fp32/bf16")
    quant = bool(scales)
    if k_pages.dtype != v_pages.dtype or k_pages.dtype not in PAGE_DTYPES \
            or quant != (k_pages.dtype == torch.int8):
        raise ValueError(f"{what}: page dtype {k_pages.dtype} does not "
                         "fit this wrapper (the kernel takes bf16 pages, or "
                         "int8 pages through the quant wrapper)")
    if block_tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError(f"{what}: block_tables and pos must be int32")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or tuple(pos.shape) != (B,):
        raise ValueError(f"{what}: block_tables "
                         f"{tuple(block_tables.shape)} / pos "
                         f"{tuple(pos.shape)} do not match B={B}")
    for s in scales:
        if s.dtype != torch.float32 or tuple(s.shape) != (P, bs, Hkv):
            raise ValueError(f"{what}: scales {tuple(s.shape)} "
                             f"{s.dtype} must be fp32 [P, bs, Hkv]")
    tensors = (q, k_pages, v_pages, block_tables, pos) + tuple(scales)
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what}: every tensor must be contiguous")
    for t in (q, k_pages, v_pages):
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: q and pages must be 16-byte aligned")
    if window < 0:
        raise ValueError(f"{what}: window {window} < 0")


def _launch(q, k_pages, v_pages, k_scales, v_scales, block_tables, pos,
            window):
    B, H, D = q.shape
    _, bs, Hkv, _ = k_pages.shape
    NB = block_tables.shape[1]
    lib = _lib()
    smem = smem_bytes(H // Hkv, D, bs)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"paged decode: block size {bs} needs {smem} bytes "
                         f"of shared memory, over {MAX_SMEM_BYTES}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.paged_decode_launch(
            Q_DTYPES[q.dtype], PAGE_DTYPES[k_pages.dtype], q.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(),
            None if k_scales is None else k_scales.data_ptr(),
            None if v_scales is None else v_scales.data_ptr(),
            block_tables.data_ptr(), pos.data_ptr(), out.data_ptr(), B, H,
            Hkv, D, bs, NB, int(window), D ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"paged decode kernel launch failed: error {err}")
    return out


def paged_decode(q, k_pages, v_pages, block_tables, pos, *, window=0):
    """q [B,H,D] fp32/bf16; k_pages/v_pages [P,bs,Hkv,D] bf16 (the plain
    version on the CPU also takes fp32); block_tables [B,NB] int32
    (-1 = unallocated); pos [B] int32.  Returns [B,H,D] in q's dtype."""
    if on_cpu("paged decode", q, k_pages, v_pages, block_tables, pos):
        return paged_decode_ref(q, k_pages, v_pages, block_tables, pos,
                                window=window)
    check_paged_args("paged decode", "B,H,D", q, k_pages, v_pages,
                     block_tables, pos, window, ())
    out = _launch(q, k_pages, v_pages, None, None, block_tables, pos,
                  window)
    paged_decode.launches += 1
    return out


def paged_decode_quant(q, k_pages, v_pages, k_scales, v_scales,
                       block_tables, pos, *, window=0):
    """``paged_decode`` over int8 pages with fp32 row scales
    k_scales/v_scales [P,bs,Hkv], dequantized right after the load."""
    if on_cpu("paged decode", q, k_pages, v_pages, k_scales, v_scales,
              block_tables, pos):
        return paged_decode_quant_ref(q, k_pages, v_pages, k_scales,
                                      v_scales, block_tables, pos,
                                      window=window)
    check_paged_args("paged decode", "B,H,D", q, k_pages, v_pages,
                     block_tables, pos, window, (k_scales, v_scales))
    out = _launch(q, k_pages, v_pages, k_scales, v_scales, block_tables,
                  pos, window)
    paged_decode_quant.launches += 1
    return out


paged_decode.launches = 0
paged_decode_quant.launches = 0
