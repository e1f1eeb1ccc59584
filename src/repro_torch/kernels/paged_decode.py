"""Paged decode attention: wrappers of the hand-written CUDA kernel
``csrc/paged_decode.cu``, their plain PyTorch versions, the kernel's launch
plan, and the split rule, plan and scratch that the split-KV kernels share
(paged decode and verify, flash decode).

The kernel replaces the Pallas TPU kernels ``paged_decode_tpu`` and
``paged_decode_quant_tpu`` (``repro/kernels/paged_decode.py:92,137``).
Every decode tick of a paged engine calls it once per layer.  The source
note in the ``.cu`` file says what bounds it on an H100 and what its
design does about that.  Two hand-written instantiations, chosen by q's
dtype (``variant`` names them): bf16 queries (every bf16 serving path)
split the table's keys across CTAs by ``plan``, made from the shapes
alone (the wrapper never reads ``pos`` or the tables on the host), in two
launches from one C call (the passes of ``csrc/split_decode.cuh``, which
flash decode shares); fp32 queries (the tests, fp32 parity runs) run
the two-walk kernel, one CTA per (slot, kv head), whose arithmetic paged
verify's fp32 kernel shares.

``paged_decode``/``paged_decode_quant`` take the JAX signatures.  For
tensors on the CPU they run the plain version; for CUDA tensors they
launch the kernel or raise, never falling back.  Each wrapper counts its
calls that launch the kernel in its ``launches`` attribute (a plain
integer).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.device import kernel_wrapper, on_cpu
from repro_torch.kernels import build
from repro_torch.models.attention import (paged_decode_attention,
                                          paged_decode_attention_quant)

HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 16  # query heads per kv head
MAX_SMEM_BYTES = 227 * 1024  # per-block dynamic shared memory on Hopper

Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PAGE_DTYPES = {torch.bfloat16: 0, torch.int8: 1}  # the serving pools
SMS = 132  # streaming multiprocessors of an H100 SXM (the plans' default)
# splits a pass-2 CTA merges at most: beyond it the splits grow instead
MAX_SPLITS = 32
# keys a split may stage the map of (64 KB of a CTA's shared memory):
# rows longer than this take more splits than the SMs alone ask for, as
# zamba2-2.7b's 524,288-key cache does (B 1, 32 kv heads)
MAX_SPLIT_KEYS = 16384


def key_tile(D: int) -> int:
    """Keys per tile the split kernels stage at head dim D (32 past D 128);
    a split is a whole number of them."""
    return 32 if D > 128 else 64


def split_rule(S: int, units: int, D: int, sms: int = SMS) -> tuple:
    """(keys a split, splits) for a table of S keys read by ``units``
    independent CTA rows (slot x kv head, times the row tiles of paged
    verify): splits of whole ``key_tile(D)`` tiles, about two CTAs per SM
    over all units, and at least enough that a split holds at most
    ``MAX_SPLIT_KEYS`` keys, at most ``MAX_SPLITS`` splits (the last may
    be ragged).  The one rule of the paged decode and verify plans."""
    kt = key_tile(D)
    want = max(1, -(-2 * sms // units), -(-S // MAX_SPLIT_KEYS))
    split_keys = max(-(-S // want), -(-S // MAX_SPLITS))
    split_keys = -(-split_keys // kt) * kt
    return split_keys, -(-S // split_keys)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How a split-KV decode call (paged decode's and flash decode's bf16-q
    passes) cuts one call: the S keys of a row in ``splits`` splits of
    ``split_keys`` (split s holds keys s * split_keys up to
    min((s + 1) * split_keys, S)); ``ctas`` of each of its two launches;
    the scratch: ``partial_floats`` for every split's fp32 [G, D] partial
    (none with one split), ``ml_floats`` for every split's max and sum of
    each query head, ``counters`` int32 arrival counters, one per (slot,
    kv head) (none with one split)."""
    key_tile: int
    split_keys: int
    splits: int
    ctas: int
    partial_floats: int
    ml_floats: int
    counters: int


@functools.cache
def split_plan(B: int, G: int, Hkv: int, S: int, D: int,
               sms: int = SMS, plan_kv_heads: int | None = None) -> Plan:
    """The split-KV decode plan for rows of S keys, from the shapes alone:
    ``split_rule`` over the B*Hkv (slot, kv head) pairs, as paged
    verify's plan cuts its keys at T = 1.  ``plan_kv_heads`` (a
    tensor-parallel rank's global kv heads) cuts the keys as for that
    many heads; the CTAs and scratch stay Hkv's."""
    split_keys, splits = split_rule(S, B * (plan_kv_heads or Hkv), D, sms)
    ctas = B * Hkv * splits
    many = splits > 1
    return Plan(key_tile(D), split_keys, splits, ctas,
                ctas * G * D if many else 0, 2 * ctas * G,
                B * Hkv if many else 0)


def plan(B: int, G: int, Hkv: int, NB: int, bs: int, D: int,
         sms: int = SMS, plan_kv_heads: int | None = None) -> Plan:
    """The launch plan of the bf16-q kernel: ``split_plan`` over the table's
    NB*bs keys."""
    return split_plan(B, G, Hkv, NB * bs, D, sms, plan_kv_heads)


def split_scratch(p: Plan, device):
    """The scratch of a split-KV decode call under plan ``p``: one fp32
    tensor of the partials (first, so they are 16-byte aligned), every
    split's maxima and sums, and the arrival counters; returns the
    kernel's pointers (m, l, partial, arrived; the last two None with one
    split) and the tensor, which the caller keeps alive until the
    launch."""
    scratch = torch.empty(p.partial_floats + p.ml_floats + p.counters,
                          dtype=torch.float32, device=device)
    partial = scratch.data_ptr()
    m = partial + 4 * p.partial_floats
    l = m + 2 * p.ml_floats
    arrived = m + 4 * p.ml_floats
    return (m, l, partial if p.partial_floats else None,
            arrived if p.counters else None), scratch


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
        [i32] + [ptr] * 12 + [i32] * 9 + [ctypes.c_float, ptr])
    lib.paged_decode_launch.restype = i32
    lib.paged_decode_smem_bytes.argtypes = [i32] * 6
    lib.paged_decode_smem_bytes.restype = i32
    lib.paged_decode_key_tile.argtypes = [i32]
    lib.paged_decode_key_tile.restype = i32
    lib.paged_decode_variant.argtypes = [i32]
    lib.paged_decode_variant.restype = ctypes.c_char_p
    lib.paged_decode_fp32_launch.argtypes = (
        [i32] + [ptr] * 9 + [i32] * 7 + [ctypes.c_float, ptr])
    lib.paged_decode_fp32_launch.restype = i32
    lib.paged_decode_fp32_smem_bytes.argtypes = [i32] * 4
    lib.paged_decode_fp32_smem_bytes.restype = i32
    return lib


@functools.cache
def smem_bytes(G: int, D: int, bs: int, split_keys: int, splits: int,
               page_dtype=torch.bfloat16) -> int:
    """Dynamic shared memory one CTA of the bf16-q kernel's launches takes
    (from the built library)."""
    lib = _lib()
    if lib.paged_decode_key_tile(D) != key_tile(D):
        raise RuntimeError("paged decode: the library's key tile differs "
                           "from the plan's")
    return lib.paged_decode_smem_bytes(PAGE_DTYPES[page_dtype], D, G,
                                       split_keys, splits, bs)


def fp32_smem_bytes(G: int, D: int, bs: int, score_words: int = 0) -> int:
    """Dynamic shared memory one CTA of the fp32-q kernel takes for G query
    heads per kv head, head dim D and page size bs, with ``score_words``
    fp32 scores kept there (G * NB * bs, or 0 when they go to global
    memory), from the built library."""
    return _lib().paged_decode_fp32_smem_bytes(G, D, bs, score_words)


def variant(dtype=torch.bfloat16) -> str:
    """The hand-written instantiation that runs for queries of ``dtype``."""
    return _lib().paged_decode_variant(Q_DTYPES[dtype]).decode()


@functools.cache
def device_sms(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (the plans')."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def score_scratch(what, smem_of, ctas, words, device):
    """Where each CTA of an attention kernel keeps its ``words`` fp32
    scores: in shared memory (returns None) if ``smem_of(words)`` bytes
    fit the card's, else in a global scratch of ``ctas * words`` floats
    (returned).  Raises ValueError where even ``smem_of(0)`` does not
    fit."""
    if smem_of(words) <= MAX_SMEM_BYTES:
        return None
    smem = smem_of(0)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{what}: needs {smem} bytes of shared memory, "
                         f"over {MAX_SMEM_BYTES}")
    return torch.empty(ctas * words, dtype=torch.float32, device=device)


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


def _split_args(q, k_pages, block_tables, plan_kv_heads=None):
    """The bf16-q kernel's scratch pointers and plan arguments, and the
    scratch itself (kept alive by the caller until the launch)."""
    B, H, D = q.shape
    _, bs, Hkv, _ = k_pages.shape
    NB = block_tables.shape[1]
    G = H // Hkv
    p = plan(B, G, Hkv, NB, bs, D, device_sms(q.device.index),
             plan_kv_heads)
    smem = smem_bytes(G, D, bs, p.split_keys, p.splits, k_pages.dtype)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"paged decode: needs {smem} bytes of shared "
                         f"memory, over {MAX_SMEM_BYTES}")
    ptrs, scratch = split_scratch(p, q.device)
    return ptrs, (p.split_keys, p.splits), scratch


def _launch(q, k_pages, v_pages, k_scales, v_scales, block_tables, pos,
            window, plan_kv_heads=None):
    B, H, D = q.shape
    _, bs, Hkv, _ = k_pages.shape
    NB = block_tables.shape[1]
    if NB < 1:
        raise ValueError("paged decode: the block table has no entry")
    lib = _lib()
    out = torch.empty_like(q)
    pages = (PAGE_DTYPES[k_pages.dtype], q.data_ptr(), k_pages.data_ptr(),
             v_pages.data_ptr(),
             None if k_scales is None else k_scales.data_ptr(),
             None if v_scales is None else v_scales.data_ptr(),
             block_tables.data_ptr(), pos.data_ptr())
    shape = (B, H, Hkv, D, bs, NB, int(window))
    if q.dtype == torch.bfloat16:
        ptrs, cut, scratch = _split_args(q, k_pages, block_tables,
                                         plan_kv_heads)
        fn = lib.paged_decode_launch
        args = pages + ptrs + (out.data_ptr(),) + shape + cut
    else:
        G = H // Hkv
        scratch = score_scratch(
            "paged decode", lambda words: fp32_smem_bytes(G, D, bs, words),
            B * Hkv, G * NB * bs, q.device)
        fn = lib.paged_decode_fp32_launch
        args = pages + (None if scratch is None else scratch.data_ptr(),
                        out.data_ptr()) + shape
    with torch.cuda.device(q.device):
        # the raw stream pointer: ``current_stream()`` builds a Stream
        # object on every call, and at a decode tick the host's time to
        # issue the call is longer than its kernels
        stream = torch._C._cuda_getCurrentRawStream(q.device.index)
        err = fn(*args, D ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"paged decode kernel launch failed: error {err}")
    return out


@kernel_wrapper
def paged_decode(q, k_pages, v_pages, block_tables, pos, *, window=0,
                 plan_kv_heads=None):
    """q [B,H,D] fp32/bf16; k_pages/v_pages [P,bs,Hkv,D] bf16 (the plain
    version on the CPU also takes fp32); block_tables [B,NB] int32
    (-1 = unallocated); pos [B] int32.  Returns [B,H,D] in q's dtype.
    ``plan_kv_heads`` (default Hkv): the kv heads the split plan is made
    for; a tensor-parallel rank passes the global count, so that its
    heads split their keys as the unsharded call does."""
    if on_cpu("paged decode", q, k_pages, v_pages, block_tables, pos):
        return paged_decode_ref(q, k_pages, v_pages, block_tables, pos,
                                window=window)
    check_paged_args("paged decode", "B,H,D", q, k_pages, v_pages,
                     block_tables, pos, window, ())
    out = _launch(q, k_pages, v_pages, None, None, block_tables, pos,
                  window, plan_kv_heads)
    paged_decode.launches += 1
    return out


@kernel_wrapper
def paged_decode_quant(q, k_pages, v_pages, k_scales, v_scales,
                       block_tables, pos, *, window=0, plan_kv_heads=None):
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
                  pos, window, plan_kv_heads)
    paged_decode_quant.launches += 1
    return out


paged_decode.launches = 0
paged_decode_quant.launches = 0
