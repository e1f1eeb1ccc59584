"""Grouped matmul of the MoE experts: the wrapper of the hand-written CUDA
kernel ``csrc/moe_gmm.cu`` and its plain PyTorch version.

The kernel replaces the Pallas TPU kernel ``grouped_matmul_tpu``
(``repro/kernels/moe_gmm.py:38``).  The port calls it for the three
expert contractions of every MoE layer call (``models/moe.py``
``moe_apply``).  The source note in the ``.cu`` file says what bounds it
on an H100 and what its design does about that.

Which hand-written instantiation runs is chosen by (dtype, C) in the C
entry point (``variant`` names it): bf16 on the tensor cores, with a
small-C tile at C <= 16, fp32 on the CUDA cores.

``grouped_matmul`` takes the JAX signature.  For tensors on the CPU it
runs the plain version; for CUDA tensors it launches the kernel or raises,
never falling back.  It counts its kernel launches in its ``launches``
attribute (a plain integer).

Training: where grad mode is on and x or w requires grad,
``grouped_matmul`` is the apply of ``GroupedMatmul``, a
``torch.autograd.Function`` whose backward is ``grouped_matmul_bwd``: the
backward kernels ``csrc/moe_gmm_bwd.cu`` on CUDA tensors (counted in
``grouped_matmul.bwd_launches``), ``grouped_matmul_bwd_ref`` on CPU
tensors.  It replaces XLA's autodiff of the JAX package's expert einsums
(``repro/models/moe.py:128-146``): dx = dy w^T and dw = x^T dy per
expert, in the inputs' type.  Elsewhere (serving, ``no_grad``) nothing
is saved and no graph is built.  Which backward kernel runs is chosen by
the dtype and by whether TMA can describe every operand's rows
(``bwd_variant``): bf16 with 16-byte-aligned rows runs one persistent
``wgmma`` kernel fed by TMA over the tiles of ``bwd_tiles`` (dw's, then
dx's); other bf16 rows the ``mma.sync`` tiles; fp32 the CUDA cores.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.device import on_cpu
from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # x, w and the output


def _wide(x) -> torch.dtype:
    """The plain versions' arithmetic type: fp32, or float64 for float64
    inputs (so that gradcheck can hold the backward in float64)."""
    return torch.promote_types(x.dtype, torch.float32)


def grouped_matmul_ref(x, w):
    """Plain version: ``einsum("eck,ekn->ecn")`` of the operands widened to
    fp32, cast back to x's type (``repro/kernels/ref.py:70``)."""
    return torch.einsum("eck,ekn->ecn", x.to(_wide(x)),
                        w.to(_wide(x))).to(x.dtype)


def grouped_matmul_bwd_ref(x, w, dy):
    """Plain backward of ``grouped_matmul_ref``: ``dx = dy w^T`` [E, C, K]
    and ``dw = x^T dy`` [E, K, N] per expert, in fp32, each cast to its
    operand's type."""
    wide = _wide(x)
    dyw = dy.to(wide)
    dx = torch.einsum("ecn,ekn->eck", dyw, w.to(wide))
    dw = torch.einsum("eck,ecn->ekn", x.to(wide), dyw)
    return dx.to(x.dtype), dw.to(w.dtype)


@functools.cache
def _lib():
    """The built library, with its C signatures declared (pointers and the
    stream as ``c_void_p``, so ctypes does not cut them to 32 bits)."""
    lib = build.load("moe_gmm")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.grouped_matmul_launch.argtypes = ([i32] + [ptr] * 4 + [i32] * 7
                                          + [ptr])
    lib.grouped_matmul_launch.restype = i32
    lib.grouped_matmul_splits.argtypes = [i32] * 6
    lib.grouped_matmul_splits.restype = i32
    lib.grouped_matmul_variant.argtypes = [i32, i32]
    lib.grouped_matmul_variant.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=256)
def _splits(dtype: int, E: int, C: int, K: int, N: int, device: int) -> int:
    """How many ways the kernel splits K at these shapes on this card (1
    unless its grid has fewer CTAs than the card has SMs)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return _lib().grouped_matmul_splits(dtype, E, C, K, N, sms)


def variant(dtype, C: int) -> str:
    """The hand-written instantiation that runs for ``dtype`` and C (from
    the built library)."""
    return _lib().grouped_matmul_variant(DTYPES[dtype], C).decode()


def _check(x, w):
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise ValueError(f"grouped_matmul: x {x.dtype} and w {w.dtype} "
                         "must be both fp32 or both bf16")
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] \
            or w.shape[1] != x.shape[2]:
        raise ValueError(f"grouped_matmul: x {tuple(x.shape)} must be "
                         f"[E, C, K] and w {tuple(w.shape)} [E, K, N]")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("grouped_matmul: x and w must be contiguous")


def _rows_aligned(t) -> int:
    """1 when every row of ``t`` [..., n] starts on a 16-byte boundary."""
    return int(t.data_ptr() % 16 == 0
               and (t.shape[-1] * t.element_size()) % 16 == 0)


def grouped_matmul(x, w):
    """x [E, C, K], w [E, K, N], both fp32 or both bf16 -> [E, C, N] in
    x's type, accumulated in fp32.  Ragged C, K and N are masked in the
    kernel: no operand is padded or copied.  Differentiable (through
    ``GroupedMatmul``) where grad mode is on and x or w requires grad."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return GroupedMatmul.apply(x, w)
    return grouped_matmul_fwd(x, w)


def grouped_matmul_fwd(x, w):
    """The forward alone (no graph): the plain version on the CPU, the
    kernel on the card."""
    if on_cpu("grouped_matmul", x, w):
        return grouped_matmul_ref(x, w)
    _check(x, w)
    E, C, K = x.shape
    N = w.shape[2]
    out = torch.empty((E, C, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:  # a launch of 0 CTAs is refused
        return out
    dtype = DTYPES[x.dtype]
    splits = _splits(dtype, E, C, K, N, x.device.index)
    # the fp32 partials of a split K, summed in order by the kernel's
    # second pass
    work = (torch.empty((splits, E, C, N), dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().grouped_matmul_launch(
            dtype, x.data_ptr(), w.data_ptr(), out.data_ptr(),
            work.data_ptr() if work is not None else None, E, C, K, N,
            _rows_aligned(x), _rows_aligned(w), splits, stream)
    if err != 0:
        raise RuntimeError(f"grouped_matmul kernel launch failed: error "
                           f"{err}")
    grouped_matmul.launches += 1
    return out


@functools.cache
def _bwd_lib():
    lib = build.load("moe_gmm_bwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.grouped_matmul_bwd_launch.argtypes = ([i32] + [ptr] * 5 + [i32] * 8
                                              + [ptr])
    lib.grouped_matmul_bwd_launch.restype = i32
    lib.grouped_matmul_bwd_launch_mma_sync.argtypes = ([ptr] * 5 + [i32] * 7
                                                       + [ptr])
    lib.grouped_matmul_bwd_launch_mma_sync.restype = i32
    return lib


@functools.lru_cache(maxsize=16)
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# the persistent kernel's output tile [rows, columns] and reduction step
BWD_TILE, BWD_STEP = (128, 256), 64


def bwd_variant(dtype, K: int, N: int, aligned: bool = True) -> str:
    """The backward kernel that runs for ``dtype`` and rows of K and N
    elements (``aligned``: the three operands' bases on 16-byte
    boundaries, as every fresh allocation is): TMA describes a bf16 row
    whose stride is a multiple of 16 bytes."""
    if dtype == torch.float32:
        return "fp32 CUDA cores (two kernels)"
    if aligned and K % 8 == 0 and N % 8 == 0:
        return "wgmma + TMA, persistent (one kernel)"
    return "mma.sync tiles (rows not 16-byte aligned; two kernels)"


@dataclasses.dataclass(frozen=True)
class BwdTile:
    """One output tile of the persistent kernel: ``out`` ("dw" or "dx")
    of ``expert``, rows ``row`` .., columns ``col`` .., summed in
    ``steps`` reduction steps of BWD_STEP."""
    out: str
    expert: int
    row: int
    col: int
    steps: int


def bwd_tiles(E: int, C: int, K: int, N: int) -> list:
    """The persistent kernel's tile list in its order (``Sched`` in
    ``csrc/moe_gmm_bwd.cu``): every dw tile ([K, N] per expert, rows
    before columns, C / 64 steps), expert by expert, then every dx tile
    ([C, K], N / 64 steps).  CTA i of ``bwd_grid`` takes tiles i, i +
    grid, ..."""
    tm, tn = BWD_TILE
    out = []
    for name, rows, cols, red in (("dw", K, N, C), ("dx", C, K, N)):
        for e in range(E):
            for r in range(0, rows, tm):
                for c in range(0, cols, tn):
                    out.append(BwdTile(name, e, r, c, -(-red // BWD_STEP)))
    return out


def bwd_grid(E: int, C: int, K: int, N: int, sms: int) -> int:
    """The persistent kernel's CTAs: one an SM, at most one a tile."""
    tm, tn = BWD_TILE
    tiles = E * (-(-K // tm) * -(-N // tn) + -(-C // tm) * -(-K // tn))
    return min(tiles, sms)


def grouped_matmul_bwd(x, w, dy):
    """(dx [E, C, K], dw [E, K, N]) in the inputs' type from the forward's
    operands and the output's gradient ``dy`` [E, C, N] (x's type): the
    plain version on the CPU, the backward kernels on the card (or
    raises; ``bwd_variant`` names the kernel)."""
    if on_cpu("grouped_matmul backward", x, w, dy):
        return grouped_matmul_bwd_ref(x, w, dy)
    _check(x, w)
    E, C, K = x.shape
    N = w.shape[2]
    if tuple(dy.shape) != (E, C, N) or dy.dtype != x.dtype \
            or not dy.is_contiguous():
        raise ValueError(f"grouped_matmul backward: dy {tuple(dy.shape)} "
                         f"{dy.dtype} must be [{E}, {C}, {N}] in x's type "
                         "and contiguous")
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    if x.numel() == 0 or w.numel() == 0:  # a launch of 0 CTAs is refused
        return dx.zero_(), dw.zero_()
    if dy.numel() == 0:  # N == 0: nothing flows back
        return dx.zero_(), dw
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_lib().grouped_matmul_bwd_launch(
            DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), dw.data_ptr(), E, C, K, N, _rows_aligned(x),
            _rows_aligned(w), _rows_aligned(dy), _sms(x.device.index),
            stream)
    if err != 0:
        raise RuntimeError(f"grouped_matmul backward kernel launch failed: "
                           f"error {err}")
    grouped_matmul.bwd_launches += 1
    return dx, dw


class GroupedMatmul(torch.autograd.Function):
    """The grouped matmul with its hand-written backward
    (``grouped_matmul_bwd``); saves x and w."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return grouped_matmul_fwd(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        return grouped_matmul_bwd(x, w, dy.contiguous())


grouped_matmul.launches = 0  # forward kernel launches
grouped_matmul.bwd_launches = 0  # backward calls (one or two kernels)
