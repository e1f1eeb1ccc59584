"""Flash attention: the wrappers of the hand-written CUDA kernels
``csrc/flash_attention.cu`` (forward) and ``csrc/flash_attention_bwd.cu``
(backward), their plain PyTorch versions and the autograd Function that
joins them.

The kernel replaces the Pallas TPU kernel ``flash_attention_tpu``
(``repro/kernels/flash_attention.py:84``).  The port calls it, through
``models.attention.flash_attention``, for the non-causal attention of the
multimodal encoder's trunk (``models/mm_encoder.py``) and for the causal
attention of the monolithic forward (``models/lm.py:_attn_layer``) that
every whole-prompt prefill runs: the engine's monolithic admission, a
suffix against its cached prefix (``Sk = Spre + Sq``), the draft model's
bucketed prefill.  The source note in the ``.cu`` file
says what bounds it on an H100 and what its design does about that.
Which hand-written instantiation runs is chosen by (dtype, D) in the C
entry point (``variant`` names it): bf16 on the tensor cores at every head
dim but 448, fp32 (and bf16 at D 448) on the CUDA cores, register-tiled,
with the keys of a query tile split over a cluster of CTAs by ``plan``
when the grid would leave the card's SMs idle.

``flash_attention`` takes the JAX signature plus ``q_offset``.  For
tensors on the CPU it runs the plain version; for CUDA tensors it
launches the kernel or raises, never falling back.  It counts its kernel
launches in its ``launches`` attribute (a plain integer).

Training: where grad mode is on and q, k or v requires grad,
``flash_attention`` is the apply of ``FlashAttention``, a
``torch.autograd.Function`` (the counterpart of the JAX package's
``jax.custom_vjp`` at ``models/attention.py:147``).  Its forward also
writes each row's logsumexp (``lse`` [B, H, Sq] fp32, natural units, the
residual ``_flash_fwd`` saves); its backward is the backward kernel on
CUDA tensors (``flash_attention_bwd``, counted in
``flash_attention.bwd_launches``) and ``flash_attention_bwd_ref``, the
formula of ``_flash_bwd`` (``attention.py:157``) in one masked pass, on
CPU tensors.  Elsewhere (serving, ``no_grad``) no lse is written and no
graph is built.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import kernel_wrapper, on_cpu
from repro_torch.kernels import build

NEG_INF = -1e30
# every head dim a ported path needs: the reduced test configs' 16, the
# kernel tests' 32 and 64, qwen2-0.5b 64, zamba2-2.7b's shared attention
# 80, llama3.2-3b 128, gemma3-1b 256, and the multimodal encoder at
# qwen2-0.5b's width with two heads, 448 (each has its own instantiation)
HEAD_DIMS = (16, 32, 64, 80, 128, 256, 448)
# the backward's instantiations: the trained configs' head dims (qwen2 and
# whisper 64, zamba2-2.7b's shared attention 80, llama3.2-3b and chameleon
# 128, gemma3-1b 256, the reduced configs' 16) and the kernel tests' 32
BWD_HEAD_DIMS = (16, 32, 64, 80, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM_BYTES = 227 * 1024  # per-block dynamic shared memory on Hopper
# the CUDA-core instantiation's tiles (csrc/flash_attention.cu, cc::BM and
# cc::BN) and the most CTAs of a cluster that share a query tile's keys
CC_ROWS, CC_KEYS, MAX_SPLITS = 32, 64, 8
SMS = 132  # streaming multiprocessors of an H100 SXM (the plan fills them)
# the bf16 backward's key pass (csrc/flash_attention_bwd.cu, tcb::Tc): keys
# a CTA, and the most shares its (query head, query tile) walk is cut into
BWD_KEYS, MAX_BWD_SPLITS = 64, 16


def _offset(q, k, causal, q_offset):
    return (k.shape[1] - q.shape[1] if causal else 0) if q_offset is None \
        else q_offset


def _wide(q) -> torch.dtype:
    """The plain versions' arithmetic type: fp32, or float64 for float64
    inputs (so that gradcheck can hold the backward in float64)."""
    return torch.promote_types(q.dtype, torch.float32)


def _scores(q, k, causal, window, q_offset):
    """The scaled fp32 scores [B, Hkv, G, Sq, Sk] with masked entries set
    to ``NEG_INF``, and the mask [Sq, Sk] (None when nothing is masked)."""
    B, Sq, H, D = q.shape
    _, Sk, Hkv, _ = k.shape
    qg = q.reshape(B, Sq, Hkv, H // Hkv, D).to(_wide(q))
    s = torch.einsum("bqhgd,bshd->bhgqs", qg, k.to(_wide(q))) * D ** -0.5
    if not (causal or window):
        return s, None
    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    live = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        live &= kpos <= qpos
    if window:
        live &= (qpos - kpos) < window
    return torch.where(live, s, NEG_INF), live


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int | None = None, return_lse: bool = False):
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
    fills (never read; the kernel writes zeros there).  ``return_lse``
    also returns each row's ``m + log(max(l, 1e-30))`` [B, H, Sq] fp32
    (``_flash_fwd_impl``'s residual).
    """
    B, Sq, H, D = q.shape
    s, _ = _scores(q, k, causal, window, _offset(q, k, causal, q_offset))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqs,bshd->bqhgd", p, v.to(_wide(q)))
    o = o.reshape(B, Sq, H, D).to(q.dtype)
    if not return_lse:
        return o
    m = s.amax(-1, keepdim=True)
    lse = m + torch.log(torch.exp(s - m).sum(-1, keepdim=True)
                        .clamp(min=1e-30))
    return o, lse[..., 0].reshape(B, H, Sq)


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            window: int = 0, q_offset: int | None = None):
    """Plain backward, in one masked pass: ``_flash_bwd``'s formula
    (``repro/models/attention.py:157``) over every (query, key) pair.
    With ``D = rowsum(do * o)``, ``p = exp(s - lse)`` on visible pairs (0
    elsewhere), ``dv = p^T do``, ``dp = do v^T``, ``ds = p (dp - D) *
    scale``, ``dq = ds k`` and ``dk = ds^T q``, all in fp32, the G query
    heads of a kv head summed into its dk and dv; dq, dk, dv in q's
    type."""
    B, Sq, H, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = H // Hkv
    s, live = _scores(q, k, causal, window, _offset(q, k, causal, q_offset))
    p = torch.exp(s - lse.reshape(B, Hkv, G, Sq, 1))
    if live is not None:
        p = torch.where(live, p, 0.0)
    dog = do.reshape(B, Sq, Hkv, G, D).to(_wide(q))
    rows = (dog * o.reshape(B, Sq, Hkv, G, D).to(_wide(q))).sum(-1)
    dv = torch.einsum("bhgqs,bqhgd->bshd", p, dog)
    dp = torch.einsum("bqhgd,bshd->bhgqs", dog, v.to(_wide(q)))
    ds = p * (dp - rows.permute(0, 2, 3, 1)[..., None]) * D ** -0.5
    dq = torch.einsum("bhgqs,bshd->bqhgd", ds, k.to(_wide(q)))
    dk = torch.einsum("bhgqs,bqhgd->bshd", ds,
                      q.reshape(B, Sq, Hkv, G, D).to(_wide(q)))
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(q.dtype),
            dv.to(q.dtype))


@functools.cache
def _lib():
    """The built library, with its C signatures declared (pointers and the
    stream as ``c_void_p``, so ctypes does not cut them to 32 bits)."""
    lib = build.load("flash_attention")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = (
        [i32] + [ptr] * 4 + [i32] * 9 + [ctypes.c_float, i32, ptr])
    lib.flash_attention_launch.restype = i32
    lib.flash_attention_launch_lse.argtypes = (
        [i32] + [ptr] * 5 + [i32] * 9 + [ctypes.c_float, i32, ptr])
    lib.flash_attention_launch_lse.restype = i32
    lib.flash_attention_smem_bytes.argtypes = [i32, i32]
    lib.flash_attention_smem_bytes.restype = i32
    lib.flash_attention_tile_rows.argtypes = [i32, i32]
    lib.flash_attention_tile_rows.restype = i32
    lib.flash_attention_variant.argtypes = [i32, i32]
    lib.flash_attention_variant.restype = ctypes.c_char_p
    return lib


def uses_cuda_cores(D: int, dtype) -> bool:
    """True where the CUDA-core instantiation runs: fp32 at every D, bf16
    at D 448 (the tensor-core kernel takes every other bf16 D)."""
    return dtype == torch.float32 or D == 448


@functools.lru_cache(maxsize=1024)  # shapes vary with prompts
def plan(B: int, Sq: int, Sk: int, H: int) -> int:
    """Splits of the CUDA-core instantiation, from the shapes alone: the
    CTAs of a cluster that share one (query tile, head, batch)'s key
    tiles.  Doubled while the grid stays within the card's ``SMS`` and
    each split keeps a tile, up to ``MAX_SPLITS`` (the encoder's B 4, S
    256, two heads: 64 (query tile, head, batch) CTAs, 2 splits, 128
    CTAs; S 16: one key tile, 1)."""
    base = -(-Sq // CC_ROWS) * H * B
    tiles = -(-Sk // CC_KEYS)
    splits = 1
    while (2 * splits <= min(tiles, MAX_SPLITS)
           and 2 * splits * base <= SMS):
        splits *= 2
    return splits


def bwd_rows(D: int) -> int:
    """Query rows a step of the bf16 backward's key pass takes at head dim
    D (``tcb::Tc<D>::KM``): 32 at D 128 and 256, where a warp's s, dp, dk
    and dv must fit its registers, else 64."""
    return 32 if D >= 128 else 64


@functools.lru_cache(maxsize=1024)  # shapes vary with prompts
def bwd_plan(B: int, Sq: int, Sk: int, H: int, Hkv: int, D: int) -> int:
    """Splits of the bf16 backward's key pass, from the shapes alone: the
    shares into which the walk of a key tile over its G query heads and
    query tiles is cut, one CTA each, their fp32 partial dk and dv summed
    in split order by a fourth kernel.  Doubled while the grid stays
    within the card's ``SMS`` and each share keeps a step of the walk, up
    to ``MAX_BWD_SPLITS``: gemma3-1b's training shape (B 2, S 1024, 4/1
    heads of 256: 32 key-tile CTAs) 4 splits, 128 CTAs; qwen2-0.5b's (B 8,
    14/2 heads: 256 CTAs) and whisper's (B 4, 20 kv heads) 1."""
    base = -(-Sk // BWD_KEYS) * Hkv * B
    walk = (H // Hkv) * -(-Sq // bwd_rows(D))
    splits = 1
    while (2 * splits <= min(walk, MAX_BWD_SPLITS)
           and 2 * splits * base <= SMS):
        splits *= 2
    return splits


def smem_bytes(D: int, dtype=torch.bfloat16) -> int:
    """Dynamic shared memory one CTA of the kernel that runs for ``dtype``
    and head dim D takes (from the built library)."""
    return _lib().flash_attention_smem_bytes(DTYPES[dtype], D)


def tile_rows(D: int, dtype=torch.bfloat16) -> int:
    """Query rows one CTA of the kernel that runs for ``dtype`` and D
    takes."""
    return _lib().flash_attention_tile_rows(DTYPES[dtype], D)


def variant(D: int, dtype=torch.bfloat16) -> str:
    """The hand-written instantiation that runs for ``dtype`` and D."""
    return _lib().flash_attention_variant(DTYPES[dtype], D).decode()


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
                    q_offset: int | None = None,
                    plan_heads: int | None = None):
    """q [B,Sq,H,D], k/v [B,Sk,Hkv,D], fp32 or bf16 (one type) ->
    [B,Sq,H,D] in q's type; mask and query offset as in
    ``flash_attention_ref``, scale ``D ** -0.5``.  Differentiable (through
    ``FlashAttention``) where grad mode is on and an input requires
    grad.  ``plan_heads``: see ``flash_attention_fwd``."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if plan_heads not in (None, q.shape[2]):
            raise ValueError("flash attention: a plan of other heads than "
                             "q's is a serving (forward-only) call")
        return FlashAttention.apply(q, k, v, causal, window, q_offset)
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, plan_heads=plan_heads)


@kernel_wrapper
def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int | None = None, return_lse: bool = False,
                        plan_heads: int | None = None):
    """The forward alone (no graph): the plain version on the CPU, the
    kernel on the card.  ``plan_heads`` (default H): the head count the
    CUDA-core instantiation's split plan is made for; a tensor-parallel
    rank passes the global count, so that its heads split their keys as
    the unsharded call does.  ``return_lse`` also returns the rows' logsumexp
    [B, H, Sq] fp32 (the kernel writes it only then)."""
    if on_cpu("flash attention", q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, return_lse=return_lse)
    _check(q, k, v, window)
    B, Sq, H, D = q.shape
    _, Sk, Hkv, _ = k.shape
    q_offset = _offset(q, k, causal, q_offset)
    out = torch.empty_like(q)
    lse = (torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:  # a launch of 0 CTAs is refused
        return (out, lse) if return_lse else out
    lib = _lib()
    smem = smem_bytes(D, q.dtype)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"flash attention: head dim {D} needs {smem} bytes "
                         f"of shared memory, over {MAX_SMEM_BYTES}")
    splits = (plan(B, Sq, Sk, plan_heads or H)
              if uses_cuda_cores(D, q.dtype) else 1)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_launch_lse(
            DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(), B, Sq,
            Sk, H, Hkv, D, int(bool(causal)), int(window), int(q_offset),
            D ** -0.5, splits, stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: error "
                           f"{err}")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


@functools.cache
def _bwd_lib():
    lib = build.load("flash_attention_bwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    args = [i32] + [ptr] * 10 + [i32] * 9 + [ctypes.c_float]
    lib.flash_attention_bwd_launch_split.argtypes = args + [i32, ptr, ptr]
    lib.flash_attention_bwd_launch_split.restype = i32
    # the first version's CUDA-core kernels for either dtype: the yardstick
    # chip_smoke.py times beside the bf16 tensor-core kernels
    lib.flash_attention_bwd_launch_cuda_cores.argtypes = args + [ptr]
    lib.flash_attention_bwd_launch_cuda_cores.restype = i32
    lib.flash_attention_bwd_smem_bytes.argtypes = [i32, i32]
    lib.flash_attention_bwd_smem_bytes.restype = i32
    return lib


def bwd_smem_bytes(D: int, dtype=torch.bfloat16) -> tuple:
    """Dynamic shared memory a CTA of the backward's key pass and query
    pass takes at head dim D for ``dtype`` (bf16: the tensor-core kernels;
    fp32: the CUDA-core kernels), from the built library."""
    lib, base = _bwd_lib(), 2 * DTYPES[dtype]
    return (lib.flash_attention_bwd_smem_bytes(base, D),
            lib.flash_attention_bwd_smem_bytes(base + 1, D))


@kernel_wrapper
def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, q_offset: int | None = None):
    """(dq, dk, dv) in q's type from the forward's inputs, output o and
    ``lse`` and the output's gradient ``do``: the plain version on the
    CPU, the backward kernel on the card (or raises): bf16 on the tensor
    cores with the key pass split by ``bwd_plan``, fp32 on the CUDA
    cores."""
    if on_cpu("flash attention backward", q, k, v, o, lse, do):
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window, q_offset=q_offset)
    _check(q, k, v, window)
    B, Sq, H, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if D not in BWD_HEAD_DIMS:
        raise ValueError(f"flash attention backward: head dim {D} not in "
                         f"{BWD_HEAD_DIMS}")
    for t, shape in ((o, q.shape), (do, q.shape), (lse, (B, H, Sq))):
        if t.shape != shape or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash attention backward: a tensor of shape "
                             f"{tuple(t.shape)} must be {tuple(shape)}, "
                             "contiguous and 16-byte aligned")
    if o.dtype != q.dtype or do.dtype != q.dtype or lse.dtype != torch.float32:
        raise ValueError("flash attention backward: o and do must have q's "
                         "type and lse fp32")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    rows = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    splits = (bwd_plan(B, Sq, Sk, H, Hkv, D) if q.dtype == torch.bfloat16
              else 1)
    part = (torch.empty(2 * splits * k.numel(), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_lib().flash_attention_bwd_launch_split(
            DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), rows.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H, Hkv,
            D, int(bool(causal)), int(window),
            int(_offset(q, k, causal, q_offset)), D ** -0.5, splits,
            None if part is None else part.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"flash attention backward kernel launch failed: "
                           f"error {err}")
    flash_attention.bwd_launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with its hand-written backward: the forward saves
    q, k, v, o and the rows' logsumexp; the backward recomputes p from
    them (``flash_attention_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, window, q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, q_offset = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         causal=causal, window=window,
                                         q_offset=q_offset)
        return dq, dk, dv, None, None, None


flash_attention.launches = 0  # forward kernel launches
flash_attention.bwd_launches = 0  # backward calls (three kernels each, four
# where bwd_plan splits the bf16 key pass)
