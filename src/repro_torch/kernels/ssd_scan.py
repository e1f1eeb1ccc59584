"""Mamba2 SSD chunked scan: the wrapper of the hand-written CUDA kernels
``csrc/ssd_scan.cu``, their plain PyTorch version and the launch plan.

The kernels replace the Pallas TPU kernel ``ssd_scan_tpu``
(``repro/kernels/mamba2_scan.py:60``).  The port calls them from
``models/mamba2.py:mamba2_forward``, once per Mamba2 layer of a prefill.
Their contract is that of the JAX package's ``ssd_chunked``
(``repro/models/mamba2.py:51``), which ``mamba2_forward`` consumes: y in
fp32, the final state as a second output, and an optional initial state
(``ssd_scan_tpu`` rounds y to x's type, returns no state and starts from
zeros).  The source note in the ``.cu`` file says what bounds them on an
H100 and what the design does about that.

Two hand-written kernels, chosen by x's dtype (``variant`` names them):
bf16 x, B and C run three passes from one C call, each chunk cut into
blocks of 64 tokens, parallel over the blocks, every product on the
tensor cores: each block's own state, the state passing in block order,
and each block's outputs.  ``plan`` gives their grids and the scratch
the wrapper allocates for them (each block's own state and decay in
fp32 from pass 1, the state entering each block as bf16 hi and lo from
pass 2) from the shapes alone: the wrapper reads nothing on the host
and never synchronises.  fp32 x runs the first version's walk (one CTA
a head, chunks in order, fp32 FMAs), needing no scratch.

``ssd_scan`` takes ``ssd_chunked``'s signature.  For tensors on the CPU
it runs the plain version; for CUDA tensors it launches the kernels or
raises, never falling back.  It counts its calls that launch in its
``launches`` attribute (a plain integer): one per call, whether the call
runs one kernel or three.

Training: where grad mode is on and x, dt, a_neg, B or C requires grad,
``ssd_scan`` is the apply of ``SSDScan``, a ``torch.autograd.Function``
whose backward is ``ssd_scan_bwd``: the backward kernels
``csrc/ssd_scan_bwd.cu`` on CUDA tensors (counted in
``ssd_scan.bwd_launches``), ``ssd_scan_bwd_ref`` on CPU tensors.  It
replaces XLA's autodiff of the JAX package's ``ssd_chunked``
(``repro/models/mamba2.py:51``).  bf16 x with p and n up to 64 runs the
block terms and block gradients on the tensor cores, each fp32 factor
split into bf16 hi + lo against the exact bf16 operand; fp32 x, and bf16
past 64, the CUDA-core passes (``bwd_variant``).  The Function saves the
forward's inputs and nothing else: the backward recomputes the states it
needs, and the forward runs the serving kernels with their own scratch,
unchanged.  The initial state is not differentiated (no training path
passes one, ROADMAP item 18): a gradient asked through it raises
NotImplementedError.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.device import kernel_wrapper, on_cpu
from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # x, B and C
MAX_SMEM_BYTES = 227 * 1024  # per-block dynamic shared memory on Hopper
BLOCK = 64  # tokens of a block: the bf16 kernel cuts each chunk in these
PASS_THREADS = 256  # threads a CTA of the state passing
# the passes of each kernel, as ssd_scan_smem_bytes numbers them
PASSES = {torch.float32: {"walk": 0},
          torch.bfloat16: {"block states": 1, "state passing": 2,
                           "block outputs": 3}}


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the bf16 kernel cuts one call of chunk Q: ``chunks`` = S / Q,
    each in ``per_chunk`` blocks of up to ``block`` tokens, ``blocks`` in
    all; passes 1 and 3 run one CTA per (head, block, batch), ``ctas``;
    pass 2 ``passing_ctas`` of PASS_THREADS threads, one thread per
    (batch, head, state element), walking the blocks in order.  The
    scratch, ``scratch_bytes`` in all: the state entering each block as
    bf16 hi and lo ``split_shape`` [b, blocks, h, 2, p, n], each block's
    own state ``states_shape`` [b, blocks, h, p, n] and its decay
    exponent ``decay_shape`` [b, blocks, h] in fp32."""
    chunks: int
    block: int
    per_chunk: int
    blocks: int
    ctas: int
    passing_ctas: int
    split_shape: tuple
    states_shape: tuple
    decay_shape: tuple
    scratch_bytes: int


@functools.lru_cache(maxsize=None)
def plan(b: int, S: int, h: int, p: int, n: int, Q: int) -> Plan:
    """The bf16 kernel's launch plan from the shapes alone (S a multiple
    of Q, as ``chunk_length`` gives it)."""
    if Q < 1 or S % Q:
        raise ValueError(f"ssd_scan plan: S {S} is not a multiple of Q {Q}")
    nc = S // Q
    per_chunk = -(-Q // BLOCK)
    nb = nc * per_chunk
    units = b * nb * h
    return Plan(nc, BLOCK, per_chunk, nb, units,
                b * h * -(-(p * n) // PASS_THREADS),
                (b, nb, h, 2, p, n), (b, nb, h, p, n), (b, nb, h),
                units * (2 * 2 * p * n + 4 * p * n + 4))


def segsum(a):
    """Log-decay matrix: out[..., i, j] = sum(a[..., j+1:i+1]), -inf for
    j > i (``repro/models/mamba2.py:_segsum``)."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, -1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=a.device))
    return torch.where(mask, seg, -torch.inf)


def _wide(x) -> torch.dtype:
    """The plain versions' arithmetic type: fp32, or float64 for float64
    inputs (so that gradcheck can hold the backward in float64)."""
    return torch.promote_types(x.dtype, torch.float32)


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
    wide = _wide(x)
    a = dt * a_neg[None, None, :]  # [b,S,h] log-decay per step
    xd = (x * dt[..., None]).to(wide)  # discretized input

    def r(t, shape):  # [b, S, ...] -> [nc, b, chunk, ...]
        return t.reshape((b, nc, chunk) + shape).transpose(0, 1)

    ac = r(a, (h,)).permute(0, 1, 3, 2)  # [nc,b,h,Q]
    xc, Bc, Cc = r(xd, (h, p)), r(B.to(wide), (n,)), r(C.to(wide), (n,))
    state = (torch.zeros((b, h, p, n), dtype=wide, device=x.device)
             if init_state is None else init_state.to(wide))
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


def ssd_scan_bwd_ref(x, dt, a_neg, B, C, dy, dfinal=None, *, chunk: int,
                     init_state=None):
    """Plain backward of ``ssd_scan_ref``, the chunked form written out by
    hand: the states entering each chunk (the forward's recurrence), then
    the chunks in reverse with the gradient of the state leaving each
    (from ``dfinal`` [b,h,p,n], or zeros), per chunk the gradients of C, B,
    the discretised input xd = x dt and the log-decays' cumulative sum.
    With L[t, s] = exp(acum[t] - acum[s]) (s <= t), CB = C[t].B[s], DX =
    dy[t].xd[s], S the entering state, G the leaving state's gradient and
    e the chunk's last token::

        dxd[s] = sum_t L CB dy[t] + exp(acum[e] - acum[s]) G B[s]
        dC[t]  = sum_s L DX B[s] + exp(acum[t]) dy[t] S
        dB[s]  = sum_t L DX C[t] + exp(acum[e] - acum[s]) xd[s] G
        dacum  = rows(M) - cols(M) + Y0 - W  (+ exp(acum[e]) <G, S> +
                 sum W at e), M = L CB DX, Y0[t] = exp(acum[t])
                 C[t].(dy[t] S), W[s] = exp(acum[e] - acum[s]) B[s].(xd[s] G)

    and G of the chunk before = exp(acum[e]) G + sum_t exp(acum[t]) dy[t]
    (x) C[t].  da is dacum's reverse cumulative sum; ddt = da a_neg + dxd.x,
    dx = dxd dt, da_neg = sum da dt.  Returns (dx in x's type, ddt [b,S,h],
    da_neg [h] in dt's, dB, dC in B's); the initial state gets none."""
    b, S, h, p = x.shape
    n = B.shape[-1]
    nc = S // chunk
    assert nc * chunk == S, (S, chunk)
    wide = _wide(x)
    dtw = dt.to(wide)
    a = dtw * a_neg.to(wide)[None, None, :]
    xf = x.to(wide)
    xd = xf * dtw[..., None]

    def r(t, shape):  # [b, S, ...] -> [nc, b, chunk, ...]
        return t.reshape((b, nc, chunk) + shape).transpose(0, 1)

    ac = r(a, (h,)).permute(0, 1, 3, 2)  # [nc,b,h,Q]
    xc, dyc = r(xd, (h, p)), r(dy.to(wide), (h, p))
    Bc, Cc = r(B.to(wide), (n,)), r(C.to(wide), (n,))
    state = (torch.zeros((b, h, p, n), dtype=wide, device=x.device)
             if init_state is None else init_state.to(wide))
    entering = []
    for x_k, B_k, a_k in zip(xc, Bc, ac):
        entering.append(state)
        a_cum = torch.cumsum(a_k, -1)
        decay_states = torch.exp(a_cum[..., -1:] - a_cum)
        state = state * torch.exp(a_cum[..., -1])[..., None, None] + \
            torch.einsum("bsn,bhs,bshp->bhpn", B_k, decay_states, x_k)
    g = (torch.zeros((b, h, p, n), dtype=wide, device=x.device)
         if dfinal is None else dfinal.to(wide))
    dxds, das, dBs, dCs = [], [], [], []
    for k in reversed(range(nc)):
        x_k, dy_k, B_k, C_k, a_k = xc[k], dyc[k], Bc[k], Cc[k], ac[k]
        S_in = entering[k]
        a_cum = torch.cumsum(a_k, -1)  # [b,h,Q]
        a_e = a_cum[..., -1]  # [b,h]
        L = torch.exp(segsum(a_k))  # [b,h,Q(t),Q(s)]
        to_end = torch.exp(a_e[..., None] - a_cum)  # [b,h,Q]
        from_start = torch.exp(a_cum)
        CB = torch.einsum("btn,bsn->bts", C_k, B_k)
        DX = torch.einsum("bthp,bshp->bhts", dy_k, x_k)
        Lcb, Ldx = L * CB[:, None], L * DX
        M = Lcb * DX
        gB = torch.einsum("bhpn,bsn->bshp", g, B_k)  # (G B[s])[p]
        dxd = torch.einsum("bhts,bthp->bshp", Lcb, dy_k) \
            + to_end.transpose(1, 2)[..., None] * gB
        dyS = torch.einsum("bthp,bhpn->bthn", dy_k, S_in)  # (dy[t] S)[n]
        dC = torch.einsum("bhts,bsn->btn", Ldx, B_k) \
            + torch.einsum("bht,bthn->btn", from_start, dyS)
        xG = torch.einsum("bshp,bhpn->bshn", x_k, g)  # (xd[s] G)[n]
        dB = torch.einsum("bhts,btn->bsn", Ldx, C_k) \
            + torch.einsum("bhs,bshn->bsn", to_end, xG)
        Y0 = from_start * torch.einsum("bthn,btn->bht", dyS, C_k)
        W = to_end * torch.einsum("bshn,bsn->bhs", xG, B_k)
        dac = M.sum(-1) - M.sum(-2) + Y0 - W
        last = torch.exp(a_e) * (g * S_in).sum((-2, -1)) + W.sum(-1)
        dac = torch.cat([dac[..., :-1], dac[..., -1:] + last[..., None]], -1)
        da = torch.flip(torch.cumsum(torch.flip(dac, (-1,)), -1), (-1,))
        g = g * torch.exp(a_e)[..., None, None] + torch.einsum(
            "bht,bthp,btn->bhpn", from_start, dy_k, C_k)
        dxds.append(dxd)
        das.append(da.transpose(1, 2))  # [b,Q,h]
        dBs.append(dB)
        dCs.append(dC)

    def cat(ts, shape):  # chunks (reversed) -> [b, S, ...]
        return torch.stack(ts[::-1], 1).reshape((b, S) + shape)

    dxd = cat(dxds, (h, p))
    da = cat(das, (h,))
    dx = (dxd * dtw[..., None]).to(x.dtype)
    ddt = da * a_neg.to(wide)[None, None, :] + (dxd * xf).sum(-1)
    da_neg = (da * dtw).sum((0, 1))
    return (dx, ddt.to(dt.dtype), da_neg.to(a_neg.dtype),
            cat(dBs, (n,)).to(B.dtype), cat(dCs, (n,)).to(C.dtype))


@functools.cache
def _lib():
    """The built library, with its C signatures declared (pointers and the
    stream as ``c_void_p``, so ctypes does not cut them to 32 bits)."""
    lib = build.load("ssd_scan")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_launch.argtypes = [i32] + [ptr] * 9 + [i32] * 6 + [ptr]
    lib.ssd_scan_launch.restype = i32
    lib.ssd_scan_smem_bytes.argtypes = [i32] * 4
    lib.ssd_scan_smem_bytes.restype = i32
    lib.ssd_scan_max_chunk.argtypes = []
    lib.ssd_scan_max_chunk.restype = i32
    lib.ssd_scan_block.argtypes = []
    lib.ssd_scan_block.restype = i32
    lib.ssd_scan_variant.argtypes = [i32]
    lib.ssd_scan_variant.restype = ctypes.c_char_p
    lib.ssd_scan_scratch_bytes.argtypes = [i32] * 6
    lib.ssd_scan_scratch_bytes.restype = ctypes.c_longlong
    if lib.ssd_scan_block() != BLOCK:
        raise RuntimeError("ssd_scan: the library's block differs from the "
                           "plan's")
    return lib


@functools.lru_cache(maxsize=None)
def smem_bytes(Q: int, p: int, n: int, dtype=torch.bfloat16) -> dict:
    """Dynamic shared memory one CTA of each pass of x's ``dtype`` takes
    for chunk Q, head dim p and state n (from the built library): pass
    name -> bytes."""
    lib = _lib()
    return {name: lib.ssd_scan_smem_bytes(code, Q, p, n)
            for name, code in PASSES[dtype].items()}


def variant(dtype=torch.bfloat16) -> str:
    """Which hand-written kernel runs for x's ``dtype``."""
    return _lib().ssd_scan_variant(DTYPES[dtype]).decode()


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
    smem = max(smem_bytes(Q, p, n, x.dtype).values())
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"ssd_scan: chunk {Q}, p {p}, n {n} need {smem} "
                         f"bytes of shared memory, over {MAX_SMEM_BYTES}")


def ssd_scan(x, dt, a_neg, B, C, *, chunk: int = 256, init_state=None):
    """x [b,S,h,p] fp32/bf16; dt [b,S,h] fp32 (> 0); a_neg [h] fp32 (< 0);
    B, C [b,S,n] in x's type; init_state [b,h,p,n] fp32 or None.  Runs in
    chunks of ``Q = min(chunk, S)`` (ValueError unless S is a multiple of
    Q).  Returns (y [b,S,h,p] fp32, final_state [b,h,p,n] fp32).
    Differentiable in x, dt, a_neg, B and C (through ``SSDScan``) where
    grad mode is on and one of them requires grad."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, a_neg, B, C, init_state)
            if t is not None):
        if init_state is not None and init_state.requires_grad:
            raise NotImplementedError(
                "ssd_scan: the initial state is not differentiated (no "
                "training path passes one; ROADMAP queue 1 item 18)")
        return SSDScan.apply(x, dt, a_neg, B, C, chunk, init_state)
    return ssd_scan_fwd(x, dt, a_neg, B, C, chunk=chunk,
                        init_state=init_state)


@kernel_wrapper
def ssd_scan_fwd(x, dt, a_neg, B, C, *, chunk: int = 256, init_state=None):
    """The forward alone (no graph): the plain version on the CPU, the
    kernels on the card."""
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
    scratch = None
    if x.dtype == torch.bfloat16:
        scratch = torch.empty(plan(b, S, h, p, n, Q).scratch_bytes,
                              dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().ssd_scan_launch(
            DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), a_neg.data_ptr(),
            B.data_ptr(), C.data_ptr(),
            None if init_state is None else init_state.data_ptr(),
            y.data_ptr(), final.data_ptr(),
            None if scratch is None else scratch.data_ptr(), b, S, h, p, n,
            Q, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: error {err}")
    ssd_scan.launches += 1
    return y, final


@functools.cache
def _bwd_lib():
    lib = build.load("ssd_scan_bwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_bwd_launch.argtypes = [i32] + [ptr] * 14 + [i32] * 6 + [ptr]
    lib.ssd_scan_bwd_launch.restype = i32
    lib.ssd_scan_bwd_launch_cuda_cores.argtypes = [ptr] * 14 + [i32] * 6 \
        + [ptr]
    lib.ssd_scan_bwd_launch_cuda_cores.restype = i32
    lib.ssd_scan_bwd_smem_bytes.argtypes = [i32] * 4
    lib.ssd_scan_bwd_smem_bytes.restype = i32
    lib.ssd_scan_bwd_tensor_cores.argtypes = [i32] * 2
    lib.ssd_scan_bwd_tensor_cores.restype = i32
    lib.ssd_scan_bwd_scratch_bytes.argtypes = [i32] * 6
    lib.ssd_scan_bwd_scratch_bytes.restype = ctypes.c_longlong
    lib.ssd_scan_bwd_block.argtypes = []
    lib.ssd_scan_bwd_block.restype = i32
    if lib.ssd_scan_bwd_block() != BLOCK:
        raise RuntimeError("ssd_scan backward: the library's block differs "
                           "from the plan's")
    if lib.ssd_scan_bwd_tensor_cores(BWD_TC_MAX, BWD_TC_MAX) != 1 or \
            lib.ssd_scan_bwd_tensor_cores(BWD_TC_MAX + 1, 16) != 0:
        raise RuntimeError("ssd_scan backward: the library's tensor-core "
                           "limit differs from bwd_variant's")
    return lib


BWD_TC_MAX = 64  # p and n (rounded up to 16) the tensor-core passes take


def bwd_variant(dtype, p: int, n: int) -> str:
    """The backward kernels that run for x's ``dtype``, head dim p and
    state n: bf16 with p and n (rounded up to 16) at most BWD_TC_MAX runs
    passes 1 and 3 on the tensor cores; other bf16 shapes and fp32 the
    CUDA-core passes."""
    tc = -(-p // 16) * 16 <= BWD_TC_MAX and -(-n // 16) * 16 <= BWD_TC_MAX
    if dtype == torch.bfloat16 and tc:
        return ("tensor cores (mma.sync; fp32 factors as bf16 hi + lo), "
                "four passes")
    if dtype == torch.bfloat16:
        return "fp32 CUDA cores, four passes (p or n past 64)"
    return "fp32 CUDA cores, four passes"


def bwd_block(Q: int) -> int:
    """Tokens of a block of the backward for chunk Q: ``min(Q, BLOCK)``
    (a chunk of BLOCK or fewer is one block, as the plain version cuts
    it)."""
    return min(Q, BLOCK)


def bwd_scratch_bytes(b: int, S: int, h: int, p: int, n: int,
                      Q: int) -> int:
    """The backward's fp32 scratch for chunk Q, from the shapes alone: each
    block's entering state and its leaving state's gradient [b, blocks,
    h, p, n], its decay exponent and da_neg partial [b, blocks, h], and
    the per-head partials of dB and dC [b, S, h, n]."""
    nb = -(-S // bwd_block(Q))
    return 4 * (2 * b * nb * h * p * n + 2 * b * nb * h + 2 * b * S * h * n)


def bwd_smem_bytes(p: int, n: int, dtype=torch.bfloat16) -> dict:
    """Dynamic shared memory one CTA of the backward's block-terms pass and
    block-gradients pass takes for x's ``dtype`` (from the built
    library)."""
    lib, code = _bwd_lib(), DTYPES[dtype]
    return {"block terms": lib.ssd_scan_bwd_smem_bytes(code, 1, p, n),
            "block gradients": lib.ssd_scan_bwd_smem_bytes(code, 3, p, n)}


@kernel_wrapper
def ssd_scan_bwd(x, dt, a_neg, B, C, dy, dfinal=None, *, chunk: int = 256,
                 init_state=None):
    """(dx in x's type, ddt [b,S,h] fp32, da_neg [h] fp32, dB, dC in B's
    type) from the forward's inputs, y's gradient ``dy`` [b,S,h,p] fp32 and
    the final state's ``dfinal`` [b,h,p,n] fp32 (None: zeros): the plain
    version on the CPU, the backward kernels on the card (or raises;
    ``bwd_variant`` names them).  The kernels cut the sequence into blocks
    of ``bwd_block(Q)`` tokens (the same function as the plain version's
    chunks of Q)."""
    b, S, h, p = x.shape
    Q = chunk_length(S, chunk)
    tensors = (x, dt, a_neg, B, C, dy) + tuple(
        t for t in (dfinal, init_state) if t is not None)
    if on_cpu("ssd_scan backward", *tensors):
        return ssd_scan_bwd_ref(x, dt, a_neg, B, C, dy, dfinal, chunk=Q,
                                init_state=init_state)
    _check(x, dt, a_neg, B, C, init_state, Q)
    n = B.shape[-1]
    for t, shape in ((dy, (b, S, h, p)), (dfinal, (b, h, p, n))):
        if t is not None and (tuple(t.shape) != shape or t.dtype !=
                              torch.float32 or not t.is_contiguous()):
            raise ValueError(f"ssd_scan backward: a gradient {t.dtype} "
                             f"{tuple(t.shape)} must be fp32 {shape} and "
                             "contiguous")
    lib = _bwd_lib()
    smem = max(bwd_smem_bytes(p, n, x.dtype).values())
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"ssd_scan backward: p {p}, n {n} need {smem} "
                         f"bytes of shared memory, over {MAX_SMEM_BYTES}")
    dx, dB, dC = torch.empty_like(x), torch.empty_like(B), torch.empty_like(C)
    ddt, da_neg = torch.empty_like(dt), torch.empty_like(a_neg)
    if b == 0 or S == 0 or h == 0:  # a launch of 0 CTAs is refused
        return dx.zero_(), ddt.zero_(), da_neg.zero_(), dB.zero_(), \
            dC.zero_()
    scratch = torch.empty(bwd_scratch_bytes(b, S, h, p, n, Q) // 4,
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_scan_bwd_launch(
            DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), a_neg.data_ptr(),
            B.data_ptr(), C.data_ptr(),
            None if init_state is None else init_state.data_ptr(),
            dy.data_ptr(), None if dfinal is None else dfinal.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), da_neg.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), scratch.data_ptr(), b, S, h, p, n, Q, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan backward kernel launch failed: error "
                           f"{err}")
    ssd_scan.bwd_launches += 1
    return dx, ddt, da_neg, dB, dC


class SSDScan(torch.autograd.Function):
    """The SSD scan with its hand-written backward (``ssd_scan_bwd``):
    saves the forward's inputs (the backward recomputes the states)."""

    @staticmethod
    def forward(ctx, x, dt, a_neg, B, C, chunk, init_state):
        ctx.save_for_backward(x, dt, a_neg, B, C, init_state)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)  # an unused final state: None
        return ssd_scan_fwd(x, dt, a_neg, B, C, chunk=chunk,
                            init_state=init_state)

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, a_neg, B, C, init_state = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32 if x.dtype !=
                             torch.float64 else x.dtype, device=x.device)
        grads = ssd_scan_bwd(x, dt, a_neg, B, C, dy.contiguous(),
                             None if dfinal is None else dfinal.contiguous(),
                             chunk=ctx.chunk, init_state=init_state)
        return grads + (None, None)


ssd_scan.launches = 0  # forward calls that launch
ssd_scan.bwd_launches = 0  # backward calls (four kernels each)
