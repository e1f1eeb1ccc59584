"""Flash attention (forward): the wrapper of the hand-written CUDA kernel
``csrc/flash_attention.cu`` and its plain PyTorch version.

The kernel replaces the Pallas TPU kernel ``flash_attention_tpu``
(``repro/kernels/flash_attention.py:84``).  The port calls it, through
``models.attention.flash_attention``, for the non-causal attention of the
multimodal encoder's trunk (``models/mm_encoder.py``) and for the causal
attention of the monolithic forward (``models/lm.py:_attn_layer``) that the
draft model's bucketed prefill runs.  The source note in the ``.cu`` file
says what bounds it on an H100 and what its design does about that.

``flash_attention`` takes the JAX signature plus ``q_offset``.  For
tensors on the CPU it runs the plain version; for CUDA tensors it
launches the kernel or raises, never falling back.  It counts its kernel
launches in its ``launches`` attribute (a plain integer).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import on_cpu
from repro_torch.kernels import build

NEG_INF = -1e30
# every head dim a ported path needs: the reduced test configs' 16, the
# kernel tests' 32 and 64, qwen2-0.5b 64, llama3.2-3b 128, gemma3-1b 256,
# and the multimodal encoder at qwen2-0.5b's width with two heads, 448
HEAD_DIMS = (16, 32, 64, 128, 256, 448)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM_BYTES = 227 * 1024  # per-block dynamic shared memory on Hopper


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int | None = None):
    """Plain version, in one masked softmax: what ``flash_attention_tpu``
    and the JAX package's ``models/attention.py:flash_attention`` compute
    with their blocked scans.

    q [B, Sq, H, D]; k/v [B, Sk, Hkv, D]; query head h reads kv head
    ``h // (H // Hkv)``.  Query i sits at ``q_offset + i``
    (default ``Sk - Sq`` when causal, 0 otherwise) and sees key j when
    ``j <= q_offset + i`` (causal) and ``q_offset + i - j < window``
    (window > 0), the Pallas kernel's mask.  Scale ``D ** -0.5``; scores,
    softmax and the value product run in fp32; the output has q's type.
    A row with no visible key gets the uniform softmax of ``NEG_INF``
    fills (never read; the kernel writes zeros there).
    """
    B, Sq, H, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = H // Hkv
    scale = D ** -0.5
    if q_offset is None:
        q_offset = Sk - Sq if causal else 0
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bshd->bhgqs", qg, k.float()) * scale
    if causal or window:
        qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Sk, device=q.device)[None, :]
        live = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
        if causal:
            live &= kpos <= qpos
        if window:
            live &= (qpos - kpos) < window
        s = torch.where(live, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqs,bshd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


@functools.cache
def _lib():
    """The built library, with its C signatures declared (pointers and the
    stream as ``c_void_p``, so ctypes does not cut them to 32 bits)."""
    lib = build.load("flash_attention")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = (
        [i32] + [ptr] * 4 + [i32] * 9 + [ctypes.c_float, ptr])
    lib.flash_attention_launch.restype = i32
    lib.flash_attention_smem_bytes.argtypes = [i32]
    lib.flash_attention_smem_bytes.restype = i32
    lib.flash_attention_tile_rows.argtypes = []
    lib.flash_attention_tile_rows.restype = i32
    return lib


def smem_bytes(D: int) -> int:
    """Dynamic shared memory one CTA of the kernel takes for head dim D
    (from the built library)."""
    return _lib().flash_attention_smem_bytes(D)


def tile_rows() -> int:
    """Query rows one CTA of the kernel takes."""
    return _lib().flash_attention_tile_rows()


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash attention: q {tuple(q.shape)} must be "
                         f"[B,Sq,H,D] and k/v {tuple(k.shape)}, "
                         f"{tuple(v.shape)} [B,Sk,Hkv,D]")
    B, _, H, D = q.shape
    Bk, _, Hkv, Dk = k.shape
    if Bk != B or Dk != D or H % Hkv:
        raise ValueError(f"flash attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree (B, D, or H not a "
                         "multiple of Hkv)")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash attention: head dim {D} not in "
                         f"{HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash attention: q/k/v {q.dtype}, {k.dtype}, "
                         f"{v.dtype} must be one type, fp32 or bf16")
    for t in (q, k, v):
        if not t.is_contiguous():
            raise ValueError("flash attention: q, k and v must be "
                             "contiguous")
        if t.data_ptr() % 16:
            raise ValueError("flash attention: q, k and v must be 16-byte "
                             "aligned")
    if window < 0:
        raise ValueError(f"flash attention: window {window} < 0")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int | None = None):
    """q [B,Sq,H,D], k/v [B,Sk,Hkv,D], fp32 or bf16 (one type) ->
    [B,Sq,H,D] in q's type; mask and query offset as in
    ``flash_attention_ref``, scale ``D ** -0.5``."""
    if on_cpu("flash attention", q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    _check(q, k, v, window)
    B, Sq, H, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if q_offset is None:
        q_offset = Sk - Sq if causal else 0
    out = torch.empty_like(q)
    if out.numel() == 0:  # a launch of 0 CTAs is refused
        return out
    lib = _lib()
    smem = smem_bytes(D)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"flash attention: head dim {D} needs {smem} bytes "
                         f"of shared memory, over {MAX_SMEM_BYTES}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_launch(
            DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, Sq, Sk, H, Hkv, D, int(bool(causal)),
            int(window), int(q_offset), D ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: error "
                           f"{err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
