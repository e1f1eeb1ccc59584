"""Fused RMSNorm: the wrapper of the hand-written CUDA kernel
``csrc/rmsnorm.cu`` and its plain PyTorch version.

The kernel replaces the Pallas TPU kernel ``rmsnorm_tpu``
(``repro/kernels/rmsnorm.py:23``).  The port calls it for every norm of
the LM (``models/lm.py:_norm`` for the ``rmsnorm`` and ``rmsnorm_zero``
kinds, ``_head_rms`` for qk-norm) and of the multimodal encoder
(``nn/layers.py:apply_rmsnorm``).  The source note in the ``.cu`` file
says what bounds it on an H100 and what its design does about that.

``rmsnorm`` takes the JAX signature.  For tensors on the CPU it runs the
plain version; for CUDA tensors it launches the kernel or raises, never
falling back.  It counts its kernel launches in its ``launches``
attribute (a plain integer).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import on_cpu
from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # x and scale types


def rmsnorm_ref(x, scale, *, eps: float = 1e-6, zero_centered: bool = False):
    """Plain version: ``x * rsqrt(mean(x^2) + eps) * scale`` in fp32, in
    that order, cast back to x's type (``scale + 1`` when zero-centered,
    the gemma convention).  x [..., d]; scale [d]."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    s = scale.float()
    if zero_centered:
        s = s + 1.0
    return (xf * torch.rsqrt(var + eps) * s).to(x.dtype)


@functools.cache
def _lib():
    """The built library, with its C signatures declared (pointers and the
    stream as ``c_void_p``, so ctypes does not cut them to 32 bits)."""
    lib = build.load("rmsnorm")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rmsnorm_launch.argtypes = ([i32, i32] + [ptr] * 3 + [i32] * 2
                                   + [ctypes.c_float, i32, ptr])
    lib.rmsnorm_launch.restype = i32
    return lib


def _check(x, scale, out):
    if x.dtype not in DTYPES or scale.dtype not in DTYPES:
        raise ValueError(f"rmsnorm: x {x.dtype} and scale {scale.dtype} "
                         "must each be fp32 or bf16")
    if x.dim() < 1 or scale.dim() != 1 or scale.shape[0] != x.shape[-1]:
        raise ValueError(f"rmsnorm: x {tuple(x.shape)} must be [..., d] "
                         f"and scale {tuple(scale.shape)} [d]")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm: x and scale must be contiguous")
    # the kernel moves rows in 16-byte vectors
    if (x.shape[-1] * x.element_size()) % 16 or x.data_ptr() % 16 \
            or out.data_ptr() % 16:
        raise ValueError(f"rmsnorm: rows of {x.shape[-1]} {x.dtype} values "
                         "must fill whole 16-byte vectors from a 16-byte "
                         "aligned start")


def rmsnorm(x, scale, *, eps: float = 1e-6, zero_centered: bool = False):
    """x [..., d] fp32/bf16, scale [d] fp32/bf16 -> [..., d] in x's type.
    On the card a row must fill whole 16-byte vectors (d a multiple of 8
    in bf16, of 4 in fp32)."""
    if on_cpu("rmsnorm", x, scale):
        return rmsnorm_ref(x, scale, eps=eps, zero_centered=zero_centered)
    out = torch.empty_like(x)
    _check(x, scale, out)
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    if rows == 0:  # nothing to normalize: a launch of 0 CTAs is refused
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().rmsnorm_launch(
            DTYPES[x.dtype], DTYPES[scale.dtype], x.data_ptr(),
            scale.data_ptr(), out.data_ptr(), rows, d, float(eps),
            int(bool(zero_centered)), stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: error {err}")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
