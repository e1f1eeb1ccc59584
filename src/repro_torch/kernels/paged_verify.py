"""Paged multi-token verify attention: wrappers of the hand-written CUDA
kernel ``csrc/paged_verify.cu``, their plain PyTorch versions, and the
kernel's launch plan.

The kernel replaces the Pallas TPU kernels ``paged_verify_tpu`` and
``paged_verify_quant_tpu`` (``repro/kernels/paged_verify.py:95,147``).
The serving path calls it for the speculative verify pass
(``Model.verify_step_paged``) and for the attention of every chunked
prefill (``Model.prefill_chunk_paged``, whose queries sit at
``pos + arange(C)``).  The source note in the ``.cu`` file says what
bounds it on an H100 and what its design does about that.  Two
hand-written instantiations, chosen by q's dtype (``variant`` names
them): bf16 queries (every bf16 serving path) split the table's keys
across CTAs by ``plan``, made from the shapes alone (the wrapper never
reads ``pos`` or the tables on the host), and multiply on the tensor
cores in three passes from one C call; fp32 queries (the tests, fp32
parity runs) run a CUDA-core kernel whose arithmetic is the paged-decode
kernel's.

``paged_verify``/``paged_verify_quant`` take the JAX signatures.  For
tensors on the CPU they run the plain version; for CUDA tensors they
launch the kernel or raise, never falling back.  Each wrapper counts its
calls that launch the kernel (for bf16 queries its scores, values and,
with more than one split, combine passes) in its ``launches`` attribute
(a plain integer).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.device import kernel_wrapper, on_cpu
from repro_torch.kernels import build
from repro_torch.kernels.paged_decode import (  # noqa: F401
    MAX_SMEM_BYTES, MAX_SPLITS, PAGE_DTYPES, Q_DTYPES, SMS, check_paged_args,
    device_sms, key_tile, score_scratch, split_rule)
from repro_torch.models.attention import (paged_verify_attention,
                                          paged_verify_attention_quant)

MAX_TOKENS = 1024  # query tokens per slot (T) the wrapper takes


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the bf16-q kernel cuts one call: ``rows`` query rows per tile
    (the T*G rows of a (slot, kv head) token-major), ``tiles`` of them per
    (slot, kv head); the S = NB*bs keys of the table in ``splits`` splits
    of ``split_keys`` (split s holds keys s * split_keys up to
    min((s + 1) * split_keys, S): the last may be ragged); ``ctas`` of
    passes 1 and 2; the fp32 scratch: ``ml_floats`` for every split's row
    max and sum, ``partial_floats`` for its [rows, D] partial (none with
    one split)."""
    rows: int
    tiles: int
    key_tile: int
    split_keys: int
    splits: int
    ctas: int
    ml_floats: int
    partial_floats: int


@functools.cache
def plan(B: int, T: int, G: int, Hkv: int, NB: int, bs: int, D: int,
         sms: int = SMS, plan_kv_heads: int | None = None) -> Plan:
    """The launch plan from the shapes alone.  Rows: 16, 32 or 64 a tile
    (32 takes the speculative T*G = 28 without padding half of a 64-row
    tile); keys: ``split_rule`` over the (row tile, slot, kv head) units,
    so that passes 1 and 2 run about two CTAs per SM (a split a whole
    number of ``key_tile(D)``-key tiles, at most ``MAX_SPLITS``
    splits).  ``plan_kv_heads`` (a tensor-parallel rank's global kv
    heads) cuts the keys as for that many heads; the CTAs and scratch
    stay Hkv's."""
    rows_total = T * G
    rows = 16 if rows_total <= 16 else 32 if rows_total <= 32 else 64
    tiles = -(-rows_total // rows)
    units = B * Hkv * tiles
    split_keys, splits = split_rule(NB * bs, B * (plan_kv_heads or Hkv)
                                    * tiles, D, sms)
    ctas = units * splits
    return Plan(rows, tiles, key_tile(D), split_keys, splits, ctas,
                2 * ctas * rows, ctas * rows * D if splits > 1 else 0)


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
        [i32] + [ptr] * 11 + [i32] * 11 + [ctypes.c_float, ptr])
    lib.paged_verify_launch.restype = i32
    lib.paged_verify_smem_bytes.argtypes = [i32] * 6
    lib.paged_verify_smem_bytes.restype = i32
    lib.paged_verify_key_tile.argtypes = [i32]
    lib.paged_verify_key_tile.restype = i32
    lib.paged_verify_variant.argtypes = [i32]
    lib.paged_verify_variant.restype = ctypes.c_char_p
    lib.paged_verify_fp32_launch.argtypes = (
        [i32] + [ptr] * 9 + [i32] * 8 + [ctypes.c_float, ptr])
    lib.paged_verify_fp32_launch.restype = i32
    lib.paged_verify_fp32_smem_bytes.argtypes = [i32] * 3
    lib.paged_verify_fp32_smem_bytes.restype = i32
    lib.paged_verify_fp32_tile_rows.argtypes = []
    lib.paged_verify_fp32_tile_rows.restype = i32
    return lib


@functools.cache
def smem_bytes(D: int, bs: int, rows: int, split_keys: int, splits: int,
               page_dtype=torch.bfloat16) -> int:
    """Dynamic shared memory one CTA of the bf16-q kernel's passes 1 and 2
    takes (from the built library)."""
    lib = _lib()
    if lib.paged_verify_key_tile(D) != key_tile(D):
        raise RuntimeError("paged verify: the library's key tile differs "
                           "from the plan's")
    return lib.paged_verify_smem_bytes(PAGE_DTYPES[page_dtype], D, rows,
                                       split_keys, splits, bs)


def fp32_smem_bytes(D: int, bs: int, score_words: int = 0) -> int:
    """Dynamic shared memory one CTA of the fp32-q kernel takes, with
    ``score_words`` fp32 scores kept there (fp32_tile_rows() * NB * bs,
    or 0 when they go to global memory)."""
    return _lib().paged_verify_fp32_smem_bytes(D, bs, score_words)


def fp32_tile_rows() -> int:
    """Query rows (token x query head) one CTA of the fp32-q kernel
    takes."""
    return _lib().paged_verify_fp32_tile_rows()


def variant(dtype=torch.bfloat16) -> str:
    """The hand-written instantiation that runs for queries of ``dtype``."""
    return _lib().paged_verify_variant(Q_DTYPES[dtype]).decode()


def _split_args(q, k_pages, block_tables, plan_kv_heads=None):
    """The bf16-q kernel's scratch pointers and plan arguments, and the
    scratch itself (kept alive by the caller until the launch)."""
    B, T, H, D = q.shape
    _, bs, Hkv, _ = k_pages.shape
    NB = block_tables.shape[1]
    p = plan(B, T, H // Hkv, Hkv, NB, bs, D, device_sms(q.device.index),
             plan_kv_heads)
    smem = smem_bytes(D, bs, p.rows, p.split_keys, p.splits, k_pages.dtype)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"paged verify: needs {smem} bytes of shared "
                         f"memory, over {MAX_SMEM_BYTES}")
    scratch = torch.empty(p.ml_floats + p.partial_floats,
                          dtype=torch.float32, device=q.device)
    m = scratch.data_ptr()
    l = m + 4 * (p.ml_floats // 2)
    partial = m + 4 * p.ml_floats if p.partial_floats else None
    return (m, l, partial), (p.rows, p.split_keys, p.splits), scratch


def _launch(q, k_pages, v_pages, k_scales, v_scales, block_tables, pos,
            window, plan_kv_heads=None):
    B, T, H, D = q.shape
    _, bs, Hkv, _ = k_pages.shape
    NB = block_tables.shape[1]
    if not 1 <= T <= MAX_TOKENS or NB < 1:
        raise ValueError(f"paged verify: {T} query tokens per slot and "
                         f"{NB} table entries, the kernel takes "
                         f"1..{MAX_TOKENS} and at least 1")
    lib = _lib()
    out = torch.empty_like(q)
    pages = (PAGE_DTYPES[k_pages.dtype], q.data_ptr(), k_pages.data_ptr(),
             v_pages.data_ptr(),
             None if k_scales is None else k_scales.data_ptr(),
             None if v_scales is None else v_scales.data_ptr(),
             block_tables.data_ptr(), pos.data_ptr())
    shape = (B, T, H, Hkv, D, bs, NB, int(window))
    if q.dtype == torch.bfloat16:
        ptrs, cut, scratch = _split_args(q, k_pages, block_tables,
                                         plan_kv_heads)
        fn = lib.paged_verify_launch
        args = pages + ptrs + (out.data_ptr(),) + shape + cut
    else:
        rows = fp32_tile_rows()
        ctas = B * Hkv * -(-T * (H // Hkv) // rows)
        scores = score_scratch(
            "paged verify", lambda words: fp32_smem_bytes(D, bs, words),
            ctas, rows * NB * bs, q.device)
        fn = lib.paged_verify_fp32_launch
        args = pages + (None if scores is None else scores.data_ptr(),
                        out.data_ptr()) + shape
    with torch.cuda.device(q.device):
        # the raw stream pointer: ``current_stream()`` builds a Stream
        # object on every call, and at the speculative shape the host's
        # time to issue a verify call sets its pace
        stream = torch._C._cuda_getCurrentRawStream(q.device.index)
        err = fn(*args, D ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"paged verify kernel launch failed: error {err}")
    return out


@kernel_wrapper
def paged_verify(q, k_pages, v_pages, block_tables, pos, *, window=0,
                 plan_kv_heads=None):
    """q [B,T,H,D] fp32/bf16, query t of slot b at ``pos[b] + t``;
    k_pages/v_pages [P,bs,Hkv,D] bf16 (the plain version on the CPU also
    takes fp32); block_tables [B,NB] int32 (-1 = unallocated); pos [B]
    int32.  Returns [B,T,H,D] in q's dtype.  ``plan_kv_heads`` (default
    Hkv): the kv heads the split plan is made for (a tensor-parallel
    rank's global count)."""
    if on_cpu("paged verify", q, k_pages, v_pages, block_tables, pos):
        return paged_verify_ref(q, k_pages, v_pages, block_tables, pos,
                                window=window)
    check_paged_args("paged verify", "B,T,H,D", q, k_pages, v_pages,
                     block_tables, pos, window, ())
    out = _launch(q, k_pages, v_pages, None, None, block_tables, pos,
                  window, plan_kv_heads)
    paged_verify.launches += 1
    return out


@kernel_wrapper
def paged_verify_quant(q, k_pages, v_pages, k_scales, v_scales,
                       block_tables, pos, *, window=0, plan_kv_heads=None):
    """``paged_verify`` over int8 pages with fp32 row scales
    k_scales/v_scales [P,bs,Hkv]: the kernel applies k_scales to the
    scores and v_scales to the probabilities, the plain version
    dequantizes the gathered rows."""
    if on_cpu("paged verify", q, k_pages, v_pages, k_scales, v_scales,
              block_tables, pos):
        return paged_verify_quant_ref(q, k_pages, v_pages, k_scales,
                                      v_scales, block_tables, pos,
                                      window=window)
    check_paged_args("paged verify", "B,T,H,D", q, k_pages, v_pages,
                     block_tables, pos, window, (k_scales, v_scales))
    out = _launch(q, k_pages, v_pages, k_scales, v_scales, block_tables,
                  pos, window, plan_kv_heads)
    paged_verify_quant.launches += 1
    return out


paged_verify.launches = 0
paged_verify_quant.launches = 0
