"""Fused RMSNorm: the wrapper of the hand-written CUDA kernel
``csrc/rmsnorm.cu`` and its plain PyTorch version.

The kernel replaces the Pallas TPU kernel ``rmsnorm_tpu``
(``repro/kernels/rmsnorm.py:23``).  The port calls it for every norm of
the LM (``models/lm.py:_norm`` for the ``rmsnorm`` and ``rmsnorm_zero``
kinds, ``_head_rms`` for qk-norm) and of the multimodal encoder
(``nn/layers.py:apply_rmsnorm``).  The source note in the ``.cu`` file
says what bounds it on an H100 and what its design does about that.

``plan`` chooses, from rows, d and x's type alone, how many threads share
a row and how many of its 16-byte vectors each holds.

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
SMS = 132  # streaming multiprocessors of an H100 SXM
MAX_THREADS = 256  # threads a row at most (csrc/rmsnorm.cu kMaxThreads)
VECTORS = (1, 2, 4, 8)  # the instantiations: 16-byte vectors a thread


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


@functools.lru_cache(maxsize=1024)  # shapes vary with prompts
def plan(rows: int, d: int, dtype) -> tuple:
    """(vectors a thread, threads a row) of the kernel for ``rows`` rows of
    d values of ``dtype``, from the shapes alone.  Rows that would not
    give every SM a CTA of 128 threads at 4 vectors a thread (a decode
    tick, a prefill chunk: the launch's latency sets the time) take one
    vector a thread, spread over more threads; others take 4, so that
    each thread keeps 4 loads in flight.  A thread holds more only where
    a row would need over ``MAX_THREADS`` threads."""
    nvec = d * (torch.finfo(dtype).bits // 8) // 16
    if nvec < 1 or nvec > VECTORS[-1] * MAX_THREADS:
        raise ValueError(f"rmsnorm: rows of {d} {dtype} values: the kernel "
                         f"takes 1 to {VECTORS[-1] * MAX_THREADS} 16-byte "
                         "vectors a row")

    def threads(nv):
        return 1 << max(-(-nvec // nv) - 1, 0).bit_length()

    few = rows * threads(4) < SMS * 128
    return next((nv, threads(nv)) for nv in VECTORS
                if nv >= (1 if few else 4) and threads(nv) <= MAX_THREADS)


@functools.cache
def _lib():
    """The built library, with its C signatures declared (pointers and the
    stream as ``c_void_p``, so ctypes does not cut them to 32 bits)."""
    lib = build.load("rmsnorm")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rmsnorm_launch.argtypes = ([i32, i32] + [ptr] * 3 + [i32] * 2
                                   + [ctypes.c_float] + [i32] * 3 + [ptr])
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
    nv, tpr = plan(rows, d, x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().rmsnorm_launch(
            DTYPES[x.dtype], DTYPES[scale.dtype], x.data_ptr(),
            scale.data_ptr(), out.data_ptr(), rows, d, float(eps),
            int(bool(zero_centered)), nv, tpr, stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: error {err}")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
