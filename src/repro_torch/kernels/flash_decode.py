"""Flash decode: wrappers of the hand-written CUDA kernel
``csrc/flash_decode.cu``, their plain PyTorch versions and the kernel's
launch plan.

The kernel replaces the Pallas TPU kernels ``flash_decode_tpu`` and
``flash_decode_quant_tpu`` (``repro/kernels/flash_decode.py:71,125``).
The port calls ``flash_decode`` for the attention of the dense decode step
(``models/api.py:Model.serve_step``), which the engine's dense cache
backend, the speculative draft model and zamba2's shared attention run;
no serving path of either package reaches the int8 instance (the engines
keep dense caches bf16).  The source note in the ``.cu`` file says what
bounds it on an H100 and what its design does about that.  Two
hand-written instantiations, chosen by the types (``variant`` names
them): bf16 queries over bf16 or int8 caches (every serving path) split
the S keys of each row across CTAs by ``plan``, made from the shapes
alone (the wrapper never reads ``pos`` or ``cache_positions`` on the
host), in two launches from one C call, the passes paged decode shares
(``csrc/split_decode.cuh``); fp32 queries (the tests, fp32 parity
engines) and fp32 caches (the JAX kernel sweep) run the two-walk kernel,
one CTA per (slot, kv head).

``flash_decode``/``flash_decode_quant`` take the JAX signatures
(``block_k`` is accepted and checked; the kernel stages its own tile of
keys).  For tensors on the CPU they run the plain version; for CUDA
tensors they launch the kernel or raise, never falling back.  Each
wrapper counts its calls that launch the kernel in its ``launches``
attribute (a plain integer).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import kernel_wrapper, on_cpu
from repro_torch.kernels import build
from repro_torch.kernels.paged_decode import (MAX_SMEM_BYTES, SMS, Plan,
                                              device_sms, key_tile,
                                              score_scratch, split_plan,
                                              split_scratch)
from repro_torch.models.attention import (decode_attention,
                                          decode_attention_quant)

# the reduced configs' 16, the kernel tests' 32, qwen2-0.5b 64,
# zamba2-2.7b's shared attention 80, llama3.2-3b 128, gemma3-1b 256
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
MAX_GROUP = 16  # query heads per kv head
Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the dense serving caches are bf16; fp32 caches for the JAX kernel sweep
CACHE_DTYPES = {torch.bfloat16: 0, torch.int8: 1, torch.float32: 2}


def plan(B: int, G: int, Hkv: int, S: int, D: int, sms: int = SMS) -> Plan:
    """The split-KV launch plan of a bf16-q call over caches of S keys a
    slot: paged decode's (``paged_decode.split_rule`` over the B*Hkv
    (slot, kv head) pairs), so a dense row is cut as a paged table of S
    keys is."""
    return split_plan(B, G, Hkv, S, D, sms)


def uses_splits(q_dtype, cache_dtype) -> bool:
    """Whether a call of these types takes the split-KV passes (bf16 q over
    a bf16 or int8 cache) rather than the two-walk kernel."""
    return q_dtype == torch.bfloat16 and cache_dtype != torch.float32


def flash_decode_ref(q, k_cache, v_cache, cache_positions, pos, *,
                     window=0, block_k=512):
    """Plain version: masked softmax attention over the whole cache
    (``models.attention.decode_attention``); ``block_k`` is unused."""
    return decode_attention(q, k_cache, v_cache, cache_positions, pos,
                            window=window)


def flash_decode_quant_ref(q, k_cache, v_cache, k_scales, v_scales,
                           cache_positions, pos, *, window=0, block_k=512):
    """Plain version over an int8 cache: dequantize, then attend."""
    return decode_attention_quant(q, k_cache, v_cache, k_scales, v_scales,
                                  cache_positions, pos, window=window)


@functools.cache
def _lib():
    """The built library, with its C signatures declared (pointers and the
    stream as ``c_void_p``, so ctypes does not cut them to 32 bits)."""
    lib = build.load("flash_decode")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_decode_launch.argtypes = (
        [i32] + [ptr] * 12 + [i32] * 8 + [ctypes.c_float, ptr])
    lib.flash_decode_launch.restype = i32
    lib.flash_decode_smem_bytes.argtypes = [i32] * 5
    lib.flash_decode_smem_bytes.restype = i32
    lib.flash_decode_key_tile.argtypes = [i32]
    lib.flash_decode_key_tile.restype = i32
    lib.flash_decode_variant.argtypes = [i32, i32]
    lib.flash_decode_variant.restype = ctypes.c_char_p
    lib.flash_decode_walk_launch.argtypes = (
        [i32, i32] + [ptr] * 9 + [i32] * 6 + [ctypes.c_float, ptr])
    lib.flash_decode_walk_launch.restype = i32
    lib.flash_decode_walk_smem_bytes.argtypes = [i32, i32, i32]
    lib.flash_decode_walk_smem_bytes.restype = i32
    lib.flash_decode_walk_tile_keys.argtypes = []
    lib.flash_decode_walk_tile_keys.restype = i32
    return lib


@functools.cache
def smem_bytes(G: int, D: int, split_keys: int, splits: int,
               cache_dtype=torch.bfloat16) -> int:
    """Dynamic shared memory one CTA of the split-KV passes takes (from the
    built library)."""
    lib = _lib()
    if lib.flash_decode_key_tile(D) != key_tile(D):
        raise RuntimeError("flash decode: the library's key tile differs "
                           "from the plan's")
    return lib.flash_decode_smem_bytes(CACHE_DTYPES[cache_dtype], D, G,
                                       split_keys, splits)


def walk_smem_bytes(G: int, D: int, score_words: int = 0) -> int:
    """Dynamic shared memory one CTA of the two-walk kernel takes for G
    query heads per kv head and head dim D, with ``score_words`` fp32
    scores kept there (G times S rounded up to whole tiles, or 0 when
    they go to global memory), from the built library."""
    return _lib().flash_decode_walk_smem_bytes(G, D, score_words)


def walk_tile_keys() -> int:
    """Keys one CTA of the two-walk kernel stages per tile."""
    return _lib().flash_decode_walk_tile_keys()


def variant(q_dtype=torch.bfloat16, cache_dtype=torch.bfloat16) -> str:
    """The hand-written instantiation that runs for queries of ``q_dtype``
    over caches of ``cache_dtype``."""
    return _lib().flash_decode_variant(Q_DTYPES[q_dtype],
                                       CACHE_DTYPES[cache_dtype]).decode()


def _check(q, k_cache, v_cache, cache_positions, pos, window, block_k,
           scales):
    """Raise ValueError for what the kernel does not take: q [B,H,D] fp32
    or bf16; caches [B,S,Hkv,D] bf16 or fp32, or int8 with fp32 ``scales``
    (k, v) [B,S,Hkv]; cache_positions [B,S] and pos [B] int32; every
    tensor contiguous, q and caches 16-byte aligned."""
    what = "flash decode"
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"{what}: q {tuple(q.shape)} must be [B,H,D] and "
                         f"k/v {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)} [B,S,Hkv,D]")
    B, H, D = q.shape
    Bk, S, Hkv, Dk = k_cache.shape
    if Bk != B or Dk != D or S < 1:
        raise ValueError(f"{what}: q {tuple(q.shape)} and caches "
                         f"{tuple(k_cache.shape)} disagree")
    if H % Hkv or H // Hkv > MAX_GROUP:
        raise ValueError(f"{what}: H={H}, Hkv={Hkv}: the kernel takes "
                         f"G = H/Hkv integral and <= {MAX_GROUP}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {D} not in {HEAD_DIMS}")
    if q.dtype not in Q_DTYPES:
        raise ValueError(f"{what}: q dtype {q.dtype} not fp32/bf16")
    quant = bool(scales)
    if k_cache.dtype != v_cache.dtype or k_cache.dtype not in CACHE_DTYPES \
            or quant != (k_cache.dtype == torch.int8):
        raise ValueError(f"{what}: cache dtype {k_cache.dtype} does not fit "
                         "this wrapper (the kernel takes bf16 or fp32 "
                         "caches, or int8 caches through the quant wrapper)")
    if cache_positions.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError(f"{what}: cache_positions and pos must be int32")
    if tuple(cache_positions.shape) != (B, S) or tuple(pos.shape) != (B,):
        raise ValueError(f"{what}: cache_positions "
                         f"{tuple(cache_positions.shape)} / pos "
                         f"{tuple(pos.shape)} do not match B={B}, S={S}")
    for s in scales:
        if s.dtype != torch.float32 or tuple(s.shape) != (B, S, Hkv):
            raise ValueError(f"{what}: scales {tuple(s.shape)} {s.dtype} "
                             "must be fp32 [B, S, Hkv]")
    for t in (q, k_cache, v_cache, cache_positions, pos) + tuple(scales):
        if not t.is_contiguous():
            raise ValueError(f"{what}: every tensor must be contiguous")
    for t in (q, k_cache, v_cache):
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: q and caches must be 16-byte "
                             "aligned")
    if window < 0:
        raise ValueError(f"{what}: window {window} < 0")
    if block_k < 1:
        raise ValueError(f"{what}: block_k {block_k} < 1")


def _launch(q, k_cache, v_cache, k_scales, v_scales, cache_positions, pos,
            window):
    B, H, D = q.shape
    _, S, Hkv, _ = k_cache.shape
    G = H // Hkv
    lib = _lib()
    out = torch.empty_like(q)
    caches = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
              None if k_scales is None else k_scales.data_ptr(),
              None if v_scales is None else v_scales.data_ptr(),
              cache_positions.data_ptr(), pos.data_ptr())
    if uses_splits(q.dtype, k_cache.dtype):
        p = plan(B, G, Hkv, S, D, device_sms(q.device.index))
        smem = smem_bytes(G, D, p.split_keys, p.splits, k_cache.dtype)
        if smem > MAX_SMEM_BYTES:
            raise ValueError(f"flash decode: needs {smem} bytes of shared "
                             f"memory, over {MAX_SMEM_BYTES}")
        ptrs, scratch = split_scratch(p, q.device)
        fn = lib.flash_decode_launch
        args = ((CACHE_DTYPES[k_cache.dtype],) + caches + ptrs
                + (out.data_ptr(), B, H, Hkv, D, S, int(window),
                   p.split_keys, p.splits))
    else:
        tile = walk_tile_keys()
        scratch = score_scratch(
            "flash decode", lambda words: walk_smem_bytes(G, D, words),
            B * Hkv, G * -(-S // tile) * tile, q.device)
        fn = lib.flash_decode_walk_launch
        args = ((Q_DTYPES[q.dtype], CACHE_DTYPES[k_cache.dtype]) + caches
                + (None if scratch is None else scratch.data_ptr(),
                   out.data_ptr(), B, H, Hkv, D, S, int(window)))
    with torch.cuda.device(q.device):
        # the raw stream pointer: ``current_stream()`` builds a Stream
        # object on every call, and at a decode tick the host's time to
        # issue the call is longer than its kernels
        stream = torch._C._cuda_getCurrentRawStream(q.device.index)
        err = fn(*args, D ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash decode kernel launch failed: error {err}")
    return out


@kernel_wrapper
def flash_decode(q, k_cache, v_cache, cache_positions, pos, *, window=0,
                 block_k=512):
    """q [B,H,D] fp32/bf16; k_cache/v_cache [B,S,Hkv,D] bf16 or fp32;
    cache_positions [B,S] int32 (-1 = empty); pos [B] int32.  Returns
    [B,H,D] in q's dtype."""
    if on_cpu("flash decode", q, k_cache, v_cache, cache_positions, pos):
        return flash_decode_ref(q, k_cache, v_cache, cache_positions, pos,
                                window=window)
    _check(q, k_cache, v_cache, cache_positions, pos, window, block_k, ())
    out = _launch(q, k_cache, v_cache, None, None, cache_positions, pos,
                  window)
    flash_decode.launches += 1
    return out


@kernel_wrapper
def flash_decode_quant(q, k_cache, v_cache, k_scales, v_scales,
                       cache_positions, pos, *, window=0, block_k=512):
    """``flash_decode`` over int8 caches with fp32 row scales
    k_scales/v_scales [B,S,Hkv], dequantized right after the load."""
    if on_cpu("flash decode", q, k_cache, v_cache, k_scales, v_scales,
              cache_positions, pos):
        return flash_decode_quant_ref(q, k_cache, v_cache, k_scales,
                                      v_scales, cache_positions, pos,
                                      window=window)
    _check(q, k_cache, v_cache, cache_positions, pos, window, block_k,
           (k_scales, v_scales))
    out = _launch(q, k_cache, v_cache, k_scales, v_scales, cache_positions,
                  pos, window)
    flash_decode_quant.launches += 1
    return out


flash_decode.launches = 0
flash_decode_quant.launches = 0
