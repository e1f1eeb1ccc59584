"""Mamba2 SSD chunked scan: the wrapper of the hand-written CUDA kernel
``csrc/ssd_scan.cu`` and its plain PyTorch version.

The kernel replaces the Pallas TPU kernel ``ssd_scan_tpu``
(``repro/kernels/mamba2_scan.py:60``).  The port calls it from
``models/mamba2.py:mamba2_forward``, once per Mamba2 layer of a prefill.
Its contract is that of the JAX package's ``ssd_chunked``
(``repro/models/mamba2.py:51``), which ``mamba2_forward`` consumes: y in
fp32, the final state as a second output, and an optional initial state
(``ssd_scan_tpu`` rounds y to x's type, returns no state and starts from
zeros).  The source note in the ``.cu`` file says what bounds it on an
H100 and what its design does about that.

``ssd_scan`` takes ``ssd_chunked``'s signature.  For tensors on the CPU
it runs the plain version; for CUDA tensors it launches the kernel or
raises, never falling back.  It counts its kernel launches in its
``launches`` attribute (a plain integer).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import on_cpu
from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # x, B and C
MAX_SMEM_BYTES = 227 * 1024  # per-block dynamic shared memory on Hopper


def segsum(a):
    """Log-decay matrix: out[..., i, j] = sum(a[..., j+1:i+1]), -inf for
    j > i (``repro/models/mamba2.py:_segsum``)."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, -1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=a.device))
    return torch.where(mask, seg, -torch.inf)


def ssd_scan_ref(x, dt, a_neg, B, C, *, chunk: int, init_state=None):
    """Plain version, the chunked form in einsums, step by step as
    ``ssd_chunked`` computes it.

    x [b,S,h,p]; dt [b,S,h] (> 0, already softplus'ed); a_neg [h] (< 0);
    B, C [b,S,n]; init_state [b,h,p,n] or None (zeros); S a multiple of
    ``chunk``.  Returns (y [b,S,h,p] fp32, final_state [b,h,p,n] fp32).
    """
    b, S, h, p = x.shape
    n = B.shape[-1]
    nc = S // chunk
    assert nc * chunk == S, (S, chunk)
    a = dt * a_neg[None, None, :]  # [b,S,h] log-decay per step
    xd = (x * dt[..., None]).float()  # discretized input

    def r(t, shape):  # [b, S, ...] -> [nc, b, chunk, ...]
        return t.reshape((b, nc, chunk) + shape).transpose(0, 1)

    ac = r(a, (h,)).permute(0, 1, 3, 2)  # [nc,b,h,Q]
    xc, Bc, Cc = r(xd, (h, p)), r(B.float(), (n,)), r(C.float(), (n,))
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for x_k, B_k, C_k, a_k in zip(xc, Bc, Cc, ac):
        a_cum = torch.cumsum(a_k, -1)  # [b,h,Q]
        Lmat = torch.exp(segsum(a_k))  # [b,h,Q,Q]
        scores = torch.einsum("bln,bsn->bls", C_k, B_k)
        y = torch.einsum("bls,bhls,bshp->blhp", scores, Lmat, x_k)
        y = y + torch.einsum("bln,bhpn,bhl->blhp", C_k, state,
                             torch.exp(a_cum))
        decay_states = torch.exp(a_cum[..., -1:] - a_cum)  # [b,h,Q]
        new_state = torch.einsum("bsn,bhs,bshp->bhpn", B_k, decay_states,
                                 x_k)
        state = state * torch.exp(a_cum[..., -1])[..., None, None] \
            + new_state
        ys.append(y)
    y = torch.stack(ys, 0).transpose(0, 1).reshape(b, S, h, p)
    return y, state


@functools.cache
def _lib():
    """The built library, with its C signatures declared (pointers and the
    stream as ``c_void_p``, so ctypes does not cut them to 32 bits)."""
    lib = build.load("ssd_scan")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_launch.argtypes = [i32] + [ptr] * 8 + [i32] * 6 + [ptr]
    lib.ssd_scan_launch.restype = i32
    lib.ssd_scan_smem_bytes.argtypes = [i32, i32, i32]
    lib.ssd_scan_smem_bytes.restype = i32
    lib.ssd_scan_max_chunk.argtypes = []
    lib.ssd_scan_max_chunk.restype = i32
    return lib


def smem_bytes(Q: int, p: int, n: int) -> int:
    """Dynamic shared memory one CTA of the kernel takes for chunk Q, head
    dim p and state n (from the built library)."""
    return _lib().ssd_scan_smem_bytes(Q, p, n)


def chunk_length(S: int, chunk: int, what: str = "chunk") -> int:
    """The chunk the scan runs, ``min(chunk, S)``; raises ValueError when
    S is longer than ``chunk`` and not a multiple of it (the JAX package
    asserts the same, ``mamba2.py:60``).  ``what`` names ``chunk`` in the
    message (zamba2's ``scan_chunk``)."""
    Q = min(int(chunk), S)
    if Q < 1 or S % Q:
        raise ValueError(
            f"ssd_scan: a sequence of {S} tokens cannot be scanned: the "
            f"scan runs chunks of min({what}, S) tokens, so a sequence "
            f"longer than {what}={chunk} must be a multiple of it")
    return Q


def _check(x, dt, a_neg, B, C, init_state, Q):
    b, S, h, p = x.shape
    n = B.shape[-1]
    if x.dtype not in DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"ssd_scan: x {x.dtype}, B {B.dtype} and C "
                         f"{C.dtype} must be one type, fp32 or bf16")
    if dt.dtype != torch.float32 or a_neg.dtype != torch.float32:
        raise ValueError("ssd_scan: dt and a_neg must be fp32")
    if (tuple(dt.shape) != (b, S, h) or tuple(a_neg.shape) != (h,)
            or B.dim() != 3 or tuple(B.shape[:2]) != (b, S)
            or C.shape != B.shape):
        raise ValueError(f"ssd_scan: x {tuple(x.shape)} [b,S,h,p] does not "
                         f"fit dt {tuple(dt.shape)} [b,S,h], a_neg "
                         f"{tuple(a_neg.shape)} [h] or B/C "
                         f"{tuple(B.shape)}, {tuple(C.shape)} [b,S,n]")
    tensors = [x, dt, a_neg, B, C]
    if init_state is not None:
        if init_state.dtype != torch.float32 \
                or tuple(init_state.shape) != (b, h, p, n):
            raise ValueError(f"ssd_scan: init_state {init_state.dtype} "
                             f"{tuple(init_state.shape)} must be fp32 "
                             f"[{b},{h},{p},{n}]")
        tensors.append(init_state)
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("ssd_scan: every input must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("ssd_scan: every input must be 16-byte "
                             "aligned")
    lib = _lib()
    if Q > lib.ssd_scan_max_chunk():
        raise ValueError(f"ssd_scan: chunk {Q} over the kernel's "
                         f"{lib.ssd_scan_max_chunk()}")
    smem = smem_bytes(Q, p, n)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"ssd_scan: chunk {Q}, p {p}, n {n} need {smem} "
                         f"bytes of shared memory, over {MAX_SMEM_BYTES}")


def ssd_scan(x, dt, a_neg, B, C, *, chunk: int = 256, init_state=None):
    """x [b,S,h,p] fp32/bf16; dt [b,S,h] fp32 (> 0); a_neg [h] fp32 (< 0);
    B, C [b,S,n] in x's type; init_state [b,h,p,n] fp32 or None.  Runs in
    chunks of ``Q = min(chunk, S)`` (ValueError unless S is a multiple of
    Q).  Returns (y [b,S,h,p] fp32, final_state [b,h,p,n] fp32)."""
    b, S, h, p = x.shape
    Q = chunk_length(S, chunk)
    tensors = (x, dt, a_neg, B, C) + (
        () if init_state is None else (init_state,))
    if on_cpu("ssd_scan", *tensors):
        return ssd_scan_ref(x, dt, a_neg, B, C, chunk=Q,
                            init_state=init_state)
    _check(x, dt, a_neg, B, C, init_state, Q)
    n = B.shape[-1]
    y = torch.empty((b, S, h, p), dtype=torch.float32, device=x.device)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    if b == 0 or h == 0:  # a launch of 0 CTAs is refused
        return y, final
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().ssd_scan_launch(
            DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), a_neg.data_ptr(),
            B.data_ptr(), C.data_ptr(),
            None if init_state is None else init_state.data_ptr(),
            y.data_ptr(), final.data_ptr(), b, S, h, p, n, Q, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: error {err}")
    ssd_scan.launches += 1
    return y, final


ssd_scan.launches = 0
