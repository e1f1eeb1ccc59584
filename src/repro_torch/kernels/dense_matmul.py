"""Dense product of the column-cut projections: the wrapper of the
hand-written CUDA kernel ``csrc/dense_matmul.cu`` and its plain PyTorch
version.

The kernel replaces no Pallas kernel.  The JAX package computes its
projections with jnp (``repro/models/lm.py:121-137, 289-291, 303-315``;
``moe.py:160-166``) and its tensor-parallel guarantee rests on XLA's dot
being column-sliceable; cuBLAS, which ``x @ w`` reaches on the card, is
not.  The port calls ``dense_matmul`` for every projection whose weight
tensor parallelism cuts by columns (``models/lm.py`` ``dense``), in the
unsharded and the sharded engines alike.  The source note in the ``.cu``
file says what bounds it on an H100 and what its design does about that.

``plan`` chooses the variant and the K split from (dtype, M, K, plan_n)
and the card's SM count alone; a tensor-parallel rank holding N / tp
columns passes the global N as ``plan_n``, so that its product equals
those columns of the unsharded product bit for bit.

``dense_matmul`` runs the plain version ``x @ w`` for tensors on the CPU
or on ``meta`` (so the dry run's counter sees an ``aten.mm``); for CUDA
tensors it launches the kernel or raises, never falling back.  It counts
its launches in its ``launches`` attribute (a plain integer).

Training: where grad mode is on and x or w requires grad, ``dense_matmul``
is the apply of ``DenseMatmul``, a ``torch.autograd.Function`` whose
backward is ``dx = dy w^T`` and ``dw = x^T dy`` in ``torch.matmul``: the
JAX package differentiates these products with XLA, and training under
tensor parallelism is a path of neither package.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools

import torch

from repro_torch.device import kernel_wrapper, on_cpu
from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # x, w and the output
VARIANTS = {"fp32": 0, "mma_sync": 1, "wgmma": 2}  # csrc enum Variant
SMS = 132  # streaming multiprocessors of an H100 SXM
SMALL_ROWS = 64  # bf16 rows up to which the mma.sync tiles run
# (rows of x a CTA or 0, columns a CTA, K depth of a step) of each variant
TILES = {"fp32": (32, 64, 32), "mma_sync": (None, 64, 64),
         "wgmma": (128, 256, 64)}


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch: ``variant`` (a key of VARIANTS), ``rows8`` (the mma.sync
    tile's rows of x, in blocks of 8: 1, 2, 4 or 8; 0 otherwise),
    ``splits`` of K and ``kt_per`` K steps a split."""
    variant: str
    rows8: int
    splits: int
    kt_per: int


def dense_matmul_ref(x, w):
    """Plain version: ``x @ w`` (the JAX package's ``jnp.dot`` of the
    projection; on the CPU the same call as before the kernel)."""
    return x @ w


def _rows8(M: int) -> int:
    return next(r for r in (1, 2, 4, 8) if M <= 8 * r or r == 8)


@functools.lru_cache(maxsize=4096)
def plan(dtype, M: int, K: int, N: int, sms: int = SMS) -> Plan:
    """The launch of an [M, K] x [K, N] product of ``dtype`` on a card of
    ``sms`` SMs, from those alone (N: the global columns, ``plan_n``).
    bf16 at M > 64 with rows TMA can describe (K and N multiples of 8)
    runs the wgmma kernel over the whole K; other bf16 the mma.sync tiles
    and fp32 the CUDA-core tiles, whose K is split where the grid has
    fewer CTAs than the card has SMs: enough splits to give every SM a
    CTA, each of at least one K step, none left empty."""
    if dtype not in DTYPES:
        raise ValueError(f"dense_matmul: {dtype} is neither fp32 nor bf16")
    if dtype == torch.bfloat16 and M > SMALL_ROWS and K % 8 == 0 \
            and N % 8 == 0:
        return Plan("wgmma", 0, 1, max(1, -(-K // TILES["wgmma"][2])))
    variant = "fp32" if dtype == torch.float32 else "mma_sync"
    rows8 = _rows8(M) if variant == "mma_sync" else 0
    tm, tn, bk = TILES[variant]
    tm = tm or 8 * rows8
    ctas = -(-M // tm) * -(-N // tn)
    ktiles = max(1, -(-K // bk))
    splits = 1
    if ctas < sms and ktiles > 1:
        splits = min(-(-sms // ctas), ktiles)
    per = -(-ktiles // splits)
    return Plan(variant, rows8, -(-ktiles // per), per)


@functools.cache
def _launch():
    """The built library's launch function, with its C signature declared
    (pointers and the stream as ``c_void_p``, so ctypes does not cut them
    to 32 bits)."""
    fn = build.load("dense_matmul").dense_matmul_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i32] * 3 + [ptr] * 4 + [i32] * 8 + [ptr]
    fn.restype = i32
    return fn


@functools.lru_cache(maxsize=16)
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _rows_aligned(t) -> bool:
    """Every row of ``t`` [rows, n] starts on a 16-byte boundary."""
    return (t.data_ptr() % 16 == 0
            and (t.shape[-1] * t.element_size()) % 16 == 0)


def launch_plan(x, w, plan_n: int | None = None, sms: int = SMS) -> Plan:
    """The plan a call on x [M, K] and w [K, N] launches under (``plan``
    of the global ``plan_n`` columns, default N), after the checks the
    kernel needs: raises ValueError for operands it does not take, and
    for a shard that cannot run the variant the global shape picks (the
    wgmma kernel's TMA reads 16-byte-aligned rows only) rather than
    switching quietly."""
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise ValueError(f"dense_matmul: x {x.dtype} and w {w.dtype} must "
                         "be both fp32 or both bf16")
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"dense_matmul: x {tuple(x.shape)} must be [M, K] "
                         f"and w {tuple(w.shape)} [K, N]")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("dense_matmul: x and w must be contiguous")
    (M, K), N = x.shape, w.shape[1]
    if plan_n is not None and plan_n < N:
        raise ValueError(f"dense_matmul: plan_n {plan_n} is below w's {N} "
                         "columns")
    p = plan(x.dtype, M, K, plan_n or N, sms)
    if p.variant == "wgmma" and not (_rows_aligned(x) and _rows_aligned(w)):
        raise ValueError(
            f"dense_matmul: the plan of [{M}, {K}] x [{K}, {plan_n or N}] "
            f"is the wgmma kernel, whose TMA loads need 16-byte-aligned "
            f"rows; x [{M}, {K}] or this w [{K}, {N}] has others")
    return p


def dense_matmul(x, w, *, plan_n: int | None = None):
    """x [M, K] @ w [K, N], both fp32 or both bf16 -> [M, N] in x's type,
    summed in fp32.  ``plan_n`` (default N): the columns the launch is
    planned for; a rank holding N / tp columns of w passes the global N.
    Differentiable (through ``DenseMatmul``) where grad mode is on and x
    or w requires grad."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        if plan_n not in (None, w.shape[-1]):
            raise ValueError("dense_matmul: a plan of another N is a "
                             "serving (forward-only) call")
        return DenseMatmul.apply(x, w)
    return dense_matmul_fwd(x, w, plan_n=plan_n)


@kernel_wrapper
def dense_matmul_fwd(x, w, *, plan_n: int | None = None):
    """The forward alone (no graph): the plain version on the CPU and on
    ``meta``, the kernel on the card."""
    if on_cpu("dense_matmul", x, w):
        return dense_matmul_ref(x, w)
    M, K = x.shape
    N = w.shape[1]
    sms = _sms(x.device.index)
    p = launch_plan(x, w, plan_n, sms)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:  # a launch of 0 CTAs is refused
        return out
    if K == 0:
        return out.zero_()
    # the fp32 partials of a split K, summed in order by the second pass
    work = (torch.empty((p.splits, M, N), dtype=torch.float32,
                        device=x.device) if p.splits > 1 else None)
    # the decode path calls this ~7 times a layer a step: the raw stream
    # handle, and the device switched only where it is not current, keep
    # the host's share of a call near cuBLAS's
    dev = x.device.index
    with (contextlib.nullcontext() if dev == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        err = _launch()(
            DTYPES[x.dtype], VARIANTS[p.variant], p.rows8, x.data_ptr(),
            w.data_ptr(), out.data_ptr(),
            work.data_ptr() if work is not None else None, M, K, N,
            int(_rows_aligned(x)), int(_rows_aligned(w)), p.splits,
            p.kt_per, sms, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"dense_matmul kernel launch failed: error {err}")
    dense_matmul.launches += 1
    return out


class DenseMatmul(torch.autograd.Function):
    """The dense product with the plain backward (``torch.matmul``);
    saves x and w."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return dense_matmul_fwd(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad
        return (dy @ w.T if need_x else None,
                x.T @ dy if need_w else None)


dense_matmul.launches = 0  # kernel calls (one or two kernels each)
