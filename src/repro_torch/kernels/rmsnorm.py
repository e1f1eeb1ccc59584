"""Fused RMSNorm: the wrappers of the hand-written CUDA kernels in
``csrc/rmsnorm.cu`` (forward and backward), their plain PyTorch versions
and the autograd Function that joins them.

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

Training: where grad mode is on and x or the scale requires grad,
``rmsnorm`` is the apply of ``RMSNorm``, a ``torch.autograd.Function``
whose backward is ``rmsnorm_bwd``: the backward kernels on CUDA tensors
(counted in ``rmsnorm.bwd_launches``, one a call), ``rmsnorm_bwd_ref`` on
CPU tensors.  It replaces XLA's autodiff of the JAX package's
``lm._norm`` and ``_head_rms``: dx in x's type, dscale in the scale's.
``bwd_variant`` names the backward kernel for a shape (rows held in
registers, or the first version past 8 vectors x 256 threads a row) and
``bwd_plan`` its launch, both from the shapes alone.
"""
from __future__ import annotations

import ctypes
import functools
import typing

import torch

from repro_torch.device import kernel_wrapper, on_cpu
from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # x and scale types
SMS = 132  # streaming multiprocessors of an H100 SXM
MAX_THREADS = 256  # threads a row at most (csrc/rmsnorm.cu kMaxThreads)
VECTORS = (1, 2, 4, 8)  # the instantiations: 16-byte vectors a thread


def _wide(x) -> torch.dtype:
    """The plain versions' arithmetic type: fp32, or float64 for float64
    inputs (so that gradcheck can hold the backward in float64)."""
    return torch.promote_types(x.dtype, torch.float32)


def rmsnorm_ref(x, scale, *, eps: float = 1e-6, zero_centered: bool = False):
    """Plain version: ``x * rsqrt(mean(x^2) + eps) * scale`` in fp32, in
    that order, cast back to x's type (``scale + 1`` when zero-centered,
    the gemma convention).  x [..., d]; scale [d]."""
    xf = x.to(_wide(x))
    var = (xf * xf).mean(-1, keepdim=True)
    s = scale.to(_wide(x))
    if zero_centered:
        s = s + 1.0
    return (xf * torch.rsqrt(var + eps) * s).to(x.dtype)


def rmsnorm_bwd_ref(x, scale, dy, *, eps: float = 1e-6,
                    zero_centered: bool = False):
    """Plain backward of ``rmsnorm_ref``: with ``r = rsqrt(mean(x^2) +
    eps)``, ``x^ = x r`` and ``s = scale (+ 1)``, ``dx = r (g s - x^
    mean(g s x^))`` and ``dscale = sum over rows of g x^``, in fp32; dx
    in x's type, dscale in the scale's."""
    d = x.shape[-1]
    xf, g = x.to(_wide(x)), dy.to(_wide(x))
    r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    s = scale.to(_wide(x))
    if zero_centered:
        s = s + 1.0
    xhat = xf * r
    gs = g * s
    dx = r * (gs - xhat * (gs * xhat).mean(-1, keepdim=True))
    dscale = (g * xhat).reshape(-1, d).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


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
    lib.rmsnorm_bwd_launch.argtypes = ([i32, i32] + [ptr] * 6 + [i32] * 2
                                       + [ctypes.c_float] + [i32] * 5
                                       + [ptr])
    lib.rmsnorm_bwd_launch.restype = i32
    lib.rmsnorm_bwd_launch_first.argtypes = ([i32, i32] + [ptr] * 6
                                             + [i32] * 2 + [ctypes.c_float]
                                             + [i32] * 3 + [ptr])
    lib.rmsnorm_bwd_launch_first.restype = i32
    return lib


BWD_THREADS = 256  # threads a CTA of the backward (csrc kBwdThreads)
BWD_TWO_CTAS_NV = 4  # vectors a thread at most for two CTAs an SM
BWD_MIN_GROUPS = 4  # row groups a CTA walks, where rows allow
BWD_SMEM_BYTES = 96 * 1024  # the first version's [warps + 1, d] fp32 at most
BWD_REGISTERS = ("rows in registers, one pass through a cp.async ring, "
                 "dscale by a second kernel")
BWD_FIRST = ("first version: one warp a row, two walks, dscale by a second "
             "kernel")


class BwdPlan(typing.NamedTuple):
    """The backward's launch, from the shapes alone: ``grid`` CTAs (and
    as many rows of dscale partials), ``tpr`` threads a row, ``in_flight``
    rows a CTA holds at once (a row group), ``vectors`` 16-byte vectors a
    thread holds (the first version: walks)."""
    grid: int
    tpr: int
    in_flight: int
    vectors: int


def _row_vectors(d: int, dtype) -> int:
    return d * (torch.finfo(dtype).bits // 8) // 16


def bwd_variant(rows: int, d: int, dtype) -> str:
    """The backward kernel for ``rows`` rows of d values of ``dtype``, by
    width: rows of at most ``VECTORS[-1] x BWD_THREADS`` 16-byte vectors
    (16384 bf16, 8192 fp32 values) are held in registers; wider rows take
    the first version."""
    if _row_vectors(d, dtype) <= VECTORS[-1] * BWD_THREADS:
        return BWD_REGISTERS
    return BWD_FIRST


@functools.lru_cache(maxsize=1024)
def bwd_plan(rows: int, d: int, dtype) -> BwdPlan:
    """The backward's launch for ``rows`` rows of d values of ``dtype``.
    Registers: the fewest threads a row (a power of two) that leave a
    thread at most ``BWD_TWO_CTAS_NV`` vectors up to 64 threads a row and
    at most 2 past it (or 256 threads and up to 8), doubled while a CTA
    would walk fewer than ``BWD_MIN_GROUPS`` row groups (a shallow walk
    leaves its loads unoverlapped); 256 / tpr rows a CTA at once; two CTAs
    an SM (one past ``BWD_TWO_CTAS_NV`` vectors, for the registers), no
    more CTAs than row groups; each CTA then takes a contiguous range of
    rows / grid rows.  The first version: ``first_plan``."""
    nvec = _row_vectors(d, dtype)
    if bwd_variant(rows, d, dtype) == BWD_FIRST:
        return first_plan(rows, d, dtype)
    tpr = next(t for t in (1 << k for k in range(9))
               if -(-nvec // t) <= (BWD_TWO_CTAS_NV if t <= 64 else 2)
               or t == BWD_THREADS)
    per_sm = 2 if -(-nvec // tpr) <= BWD_TWO_CTAS_NV else 1
    while tpr < BWD_THREADS and -(-rows // (per_sm * SMS)) < \
            BWD_MIN_GROUPS * (BWD_THREADS // tpr):
        tpr *= 2  # a CTA walks at least BWD_MIN_GROUPS row groups
    nv = next(v for v in VECTORS if v * tpr >= nvec)
    in_flight = BWD_THREADS // tpr
    return BwdPlan(max(1, min(per_sm * SMS, -(-rows // in_flight))), tpr,
                   in_flight, nv)


def first_plan(rows: int, d: int, dtype) -> BwdPlan:
    """The first version's launch: one warp a row, up to 8 warps a CTA
    while their [warps + 1, d] fp32 accumulators fit in
    ``BWD_SMEM_BYTES``, at most two CTAs an SM (each warp walks rows /
    (grid x warps) rows, ``vectors`` 16-byte vectors a lane a row)."""
    warps = max(1, min(MAX_THREADS // 32, BWD_SMEM_BYTES // (4 * d) - 1))
    return BwdPlan(max(1, min(-(-rows // warps), 2 * SMS)), 32, warps,
                   -(-_row_vectors(d, dtype) // 32))


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


def rmsnorm(x, scale, *, eps: float = 1e-6, zero_centered: bool = False,
            plan_rows: int | None = None):
    """x [..., d] fp32/bf16, scale [d] fp32/bf16 -> [..., d] in x's type.
    On the card a row must fill whole 16-byte vectors (d a multiple of 8
    in bf16, of 4 in fp32).  Differentiable (through ``RMSNorm``) where
    grad mode is on and x or the scale requires grad.  ``plan_rows``: see
    ``rmsnorm_fwd``."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        if plan_rows is not None:
            raise ValueError("rmsnorm: a plan of other rows than x's is a "
                             "serving (forward-only) call")
        return RMSNorm.apply(x, scale, eps, zero_centered)
    return rmsnorm_fwd(x, scale, eps=eps, zero_centered=zero_centered,
                       plan_rows=plan_rows)


@kernel_wrapper
def rmsnorm_fwd(x, scale, *, eps: float = 1e-6, zero_centered: bool = False,
                plan_rows: int | None = None):
    """The forward alone (no graph): the plain version on the CPU, the
    kernel on the card.  ``plan_rows`` (default x's rows): the row count
    the launch plan is made for; a tensor-parallel rank's per-head norm
    passes the rows of all the heads, so that a row is cut over threads
    as the unsharded call cuts it."""
    if on_cpu("rmsnorm", x, scale):
        return rmsnorm_ref(x, scale, eps=eps, zero_centered=zero_centered)
    out = torch.empty_like(x)
    _check(x, scale, out)
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    if rows == 0:  # nothing to normalize: a launch of 0 CTAs is refused
        return out
    nv, tpr = plan(plan_rows or rows, d, x.dtype)
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


@kernel_wrapper
def rmsnorm_bwd(x, scale, dy, *, eps: float = 1e-6,
                zero_centered: bool = False):
    """(dx in x's type, dscale in the scale's) from the forward's inputs
    and the output's gradient ``dy`` (x's type and shape): the plain
    version on the CPU, on the card the backward kernels ``bwd_variant``
    names (two launches: the rows, then dscale from the CTAs' partials),
    or raises."""
    if on_cpu("rmsnorm backward", x, scale, dy):
        return rmsnorm_bwd_ref(x, scale, dy, eps=eps,
                               zero_centered=zero_centered)
    dx = torch.empty_like(x)
    _check(x, scale, dx)
    if dy.shape != x.shape or dy.dtype != x.dtype or \
            not dy.is_contiguous() or dy.data_ptr() % 16:
        raise ValueError(f"rmsnorm backward: dy {tuple(dy.shape)} "
                         f"{dy.dtype} must be x's shape and type, "
                         "contiguous and 16-byte aligned")
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    dscale = torch.empty_like(scale)
    if rows == 0:
        return dx, dscale.zero_()
    plan = bwd_plan(rows, d, x.dtype)
    if bwd_variant(rows, d, x.dtype) == BWD_FIRST:
        err = _bwd_first(x, scale, dy, dx, dscale, plan, eps, zero_centered)
    else:
        partial = torch.empty(plan.grid, d, dtype=torch.float32,
                              device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _lib().rmsnorm_bwd_launch(
                DTYPES[x.dtype], DTYPES[scale.dtype], x.data_ptr(),
                scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                partial.data_ptr(), dscale.data_ptr(), rows, d, float(eps),
                int(bool(zero_centered)), *plan, stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm backward kernel launch failed: error "
                           f"{err}")
    rmsnorm.bwd_launches += 1
    return dx, dscale


def _bwd_first(x, scale, dy, dx, dscale, plan: BwdPlan, eps: float,
               zero_centered: bool) -> int:
    """The first version's two kernels with ``plan.grid`` CTAs of
    ``plan.in_flight`` warps (one warp a row) into dx and dscale; returns
    the C launch's error code."""
    d = x.shape[-1]
    partial = torch.empty(plan.grid, d, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        return _lib().rmsnorm_bwd_launch_first(
            DTYPES[x.dtype], DTYPES[scale.dtype], x.data_ptr(),
            scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            partial.data_ptr(), dscale.data_ptr(), x.numel() // d, d,
            float(eps), int(bool(zero_centered)), plan.grid, plan.in_flight,
            torch.cuda.current_stream().cuda_stream)


class RMSNorm(torch.autograd.Function):
    """RMSNorm with its hand-written backward (``rmsnorm_bwd``); saves x
    and the scale."""

    @staticmethod
    def forward(ctx, x, scale, eps, zero_centered):
        ctx.save_for_backward(x, scale)
        ctx.args = (eps, zero_centered)
        return rmsnorm_fwd(x, scale, eps=eps, zero_centered=zero_centered)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        eps, zero_centered = ctx.args
        dx, dscale = rmsnorm_bwd(x, scale, dy.contiguous(), eps=eps,
                                 zero_centered=zero_centered)
        return dx, dscale, None, None


rmsnorm.launches = 0  # forward kernel launches
rmsnorm.bwd_launches = 0  # backward calls (two kernels each)
