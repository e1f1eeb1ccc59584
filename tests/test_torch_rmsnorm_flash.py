"""The fp32 flash-attention kernel (CUDA cores, register-tiled, keys split
over a cluster) and the fused RMSNorm kernel: their launch plans, CPU
emulations of their orders of operations held to the plain versions,
and - on a CUDA card only - the kernels at the edges of those plans.

The emulations repeat each kernel's arithmetic in its own order, on the
CPU: flash attention's 64-key tiles, its q.k sums over D in order, the
online (max, sum) rescale in log2 units, p.v in key order and the merge of
a split's partials in split order (``_flash_fp32_emulation``); RMSNorm's
sums of squares per thread over its 16-byte vectors, the xor tree over a
row's lanes and the warps' partials in warp order
(``_rmsnorm_emulation``).  Both are held within EXACT_TOL["float32"] (1e-4
relative, 1e-5 absolute: summation order only) of the plain versions on
the same fp32 values; a kernel that follows the emulated order is then as
close as the card's fp32 FMAs and exp2 allow.  The plain versions are
held to the JAX package in test_torch_multimodal.py; here the flash
emulation is also held to the JAX plain reference on one case.

Inputs are made with numpy from a seed.  Tolerances on the card (each
with its reason, as in test_torch_multimodal.py): the kernel against the
plain version on the same values widened to fp32, EXACT_TOL (summation
order and the final rounding to x's / q's type); in the working type
test_kernels.py's ``_tol``.
"""
import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from repro.kernels import ref as jref
except ImportError:  # JAX (the reference) is not installed
    jax = None

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.rmsnorm import rmsnorm_ref

EXACT_TOL = {"float32": dict(atol=1e-5, rtol=1e-4),
             "bfloat16": dict(atol=1e-5, rtol=2 ** -7)}
TOL = {"float32": dict(atol=2e-4, rtol=2e-4),
       "bfloat16": dict(atol=5e-2, rtol=5e-2)}
NEG_INF, MASKED = -1e30, -1e29  # the kernel's fill and masked threshold
LOG2E = 1.4426950408889634

# (B, Sq, Sk, H, Hkv, D, causal, window): test_kernels.py's sweep and the
# encoder's non-causal D 448 (test_torch_multimodal.py FLASH_CASES), the
# encoder's full shape at batch 1 (four splits), and a ragged causal D 80
FLASH_CASES = [
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 128, 128, 4, 4, 32, True, 48),
    (2, 64, 192, 2, 1, 64, True, 0),
    (2, 96, 160, 2, 2, 64, False, 0),
    (1, 100, 100, 4, 2, 32, True, 0),
    (2, 40, 40, 2, 2, 448, False, 0),
    (1, 256, 256, 2, 2, 448, False, 0),
    (1, 70, 150, 2, 1, 80, True, 0),
]
# every width the port normalizes, at the rows its paths give them:
# qwen2-0.5b / the encoder 896 (a decode tick, a prefill chunk, the
# encoder's 1024 rows), granite-moe 1024, gemma3-1b 1152 and its qk-norm
# D 256 (tokens x heads), llama3.2-3b 3072, zamba2-2.7b 2560 and 5120 (its
# gated and concat norms), one row, and test_kernels.py's shapes
RMS_SHAPES = [(8, 896), (64, 896), (1024, 896), (1, 896), (8, 1024),
              (8, 1152), (56, 256), (8, 3072), (8, 2560), (768, 2560),
              (8, 5120), (1, 5120), (3, 50, 96), (7, 128), (260, 64)]


@pytest.fixture
def need_jax():
    """JAX, with the reference computed on the CPU on any host."""
    if jax is None:
        pytest.skip("JAX (the reference package) is not installed here")
    with jax.default_device(jax.devices("cpu")[0]):
        yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _t(a, dtype=None, device="cpu"):
    t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def _np(x):
    return np.asarray(x.float().cpu(), np.float32)


def _flash_inputs(B, Sq, Sk, H, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, D)).astype(np.float32),
            rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32),
            rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32))


# ---------------------------------- flash attention's order, emulated


def _flash_fp32_emulation(q, k, v, *, causal, window=0, q_offset=None,
                          splits=None):
    """The CUDA-core instantiation of ``csrc/flash_attention.cu`` in its own
    order, on the CPU, fp32: scores summed over D in order (each thread's
    FMA chain), scaled to log2 units (``fp32(D ** -0.5) * fp32(log2 e)``)
    and masked to -1e30; per 32-row query tile, its visible 64-key tiles
    cut into ``splits`` (``plan``'s by default) runs of ``per`` tiles; per
    key tile the online max, rescale ``exp2(m - m_new)`` (1 for a row with
    no key yet) and sum, and p.v added key by key; each split's (m, l,
    acc) merged in split order (weights ``exp2(m_r - M)``, L = sum of w_r
    l_r, the weighted partials summed from split 0) and normalized by
    max(L, 1e-30).  q [B, Sq, H, D], k/v [B, Sk, Hkv, D] fp32."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    if q_offset is None:
        q_offset = Sk - Sq if causal else 0
    if splits is None:
        splits = fa.plan(B, Sq, Sk, H)
    rows, keys = fa.CC_ROWS, fa.CC_KEYS
    qf = q.float().transpose(1, 2)                      # [B, H, Sq, D]
    kf = k.float().repeat_interleave(G, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(G, dim=2).transpose(1, 2)
    s = torch.zeros(B, H, Sq, Sk)
    for d in range(D):
        s = s + qf[..., d:d + 1] * kf[..., d][:, :, None, :]
    scale_log2 = (torch.tensor(D ** -0.5, dtype=torch.float32)
                  * torch.tensor(LOG2E, dtype=torch.float32))
    x = s * scale_log2
    qpos = q_offset + torch.arange(Sq)[:, None]
    kpos = torch.arange(Sk)[None, :]
    live = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        live &= kpos <= qpos
    if window:
        live &= (qpos - kpos) < window
    x = torch.where(live, x, torch.tensor(NEG_INF))
    out = torch.zeros(B, H, Sq, D)
    for i0 in range(0, Sq, rows):
        n_rows = min(rows, Sq - i0)
        q_lo, q_hi = q_offset + i0, q_offset + i0 + n_rows - 1
        j_hi = -(-Sk // keys) - 1
        if causal:
            j_hi = -1 if q_hi < 0 else min(j_hi, q_hi // keys)
        j_lo = 0
        if window and q_lo - window + 1 > 0:
            j_lo = (q_lo - window + 1) // keys
        n = max(j_hi - j_lo + 1, 0)
        per = -(-n // splits)
        parts = []
        for r in range(splits):
            t_lo = j_lo + r * per
            m = torch.full((B, H, n_rows, 1), NEG_INF)
            l = torch.zeros(B, H, n_rows, 1)
            acc = torch.zeros(B, H, n_rows, D)
            for j in range(t_lo, min(t_lo + per, j_lo + n)):
                xt = x[:, :, i0:i0 + n_rows, j * keys:(j + 1) * keys]
                m_new = torch.maximum(m, xt.amax(-1, keepdim=True))
                corr = torch.where(m > MASKED, torch.exp2(m - m_new),
                                   torch.ones(()))
                p = torch.where(xt > MASKED, torch.exp2(xt - m_new),
                                torch.zeros(()))
                l = l * corr + p.sum(-1, keepdim=True)
                m = m_new
                acc = acc * corr
                for t in range(xt.shape[-1]):
                    acc = acc + p[..., t:t + 1] * vf[:, :, j * keys + t][
                        :, :, None, :]
            parts.append((m, l, acc))
        if splits == 1:
            o = parts[0][2] / parts[0][1].clamp(min=1e-30)
        else:
            M = torch.stack([m for m, _, _ in parts]).amax(0)
            w = [torch.where(m > MASKED, torch.exp2(m - M), torch.zeros(()))
                 for m, _, _ in parts]
            L = torch.zeros_like(M)
            for wr, (_, lr, _) in zip(w, parts):
                L = L + wr * lr
            o = parts[0][2] * w[0]
            for wr, (_, _, ar) in zip(w[1:], parts[1:]):
                o = o + ar * wr
            o = o / L.clamp(min=1e-30)
        out[:, :, i0:i0 + n_rows] = o
    return out.transpose(1, 2)


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal,window", FLASH_CASES)
def test_flash_fp32_arithmetic_within_exact_tol(B, Sq, Sk, H, Hkv, D,
                                                causal, window):
    """The fp32 kernel's order of operations with ``plan``'s splits,
    emulated on the CPU, stays within EXACT_TOL of the fp32 plain
    version (what the card's kernel is held to)."""
    q, k, v = (_t(a) for a in _flash_inputs(B, Sq, Sk, H, Hkv, D, seed=42))
    got = _flash_fp32_emulation(q, k, v, causal=causal, window=window)
    assert got.shape == (B, Sq, H, D)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(want), **EXACT_TOL["float32"])


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("q_offset,window", [(None, 0), (40, 0), (120, 24)])
def test_flash_fp32_split_merge_within_exact_tol(splits, q_offset, window):
    """The split's merge at every cluster size, against a cached prefix
    (query row i at q_offset + i, q_offset below Sk - Sq too) and a
    window: the same result as one walk, within EXACT_TOL."""
    q, k, v = (_t(a) for a in _flash_inputs(2, 70, 520, 4, 2, 32, seed=5))
    kw = dict(causal=True, window=window, q_offset=q_offset)
    got = _flash_fp32_emulation(q, k, v, splits=splits, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    np.testing.assert_allclose(_np(got), _np(want), **EXACT_TOL["float32"])


def test_flash_fp32_emulation_matches_jax(need_jax):
    """The emulated kernel order against the JAX package's plain reference
    (``repro.kernels.ref.flash_attention_ref``) at the encoder's width."""
    q, k, v = _flash_inputs(1, 96, 96, 2, 2, 448, seed=8)
    got = _flash_fp32_emulation(_t(q), _t(k), _t(v), causal=False)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=False)
    np.testing.assert_allclose(_np(got), np.asarray(want),
                               **EXACT_TOL["float32"])


@pytest.mark.parametrize("B,Sq,Sk,H,want", [
    (4, 256, 256, 2, 2),    # the encoder's 128x128 batch: 64 tiles, 128 CTAs
    (4, 16, 16, 2, 1),      # its 32x32 batch: one key tile
    (1, 256, 256, 2, 4),    # one image: 16 tiles, 64 CTAs
    (1, 1024, 1024, 14, 1),  # a causal prefill: 448 tiles fill the card
    (1, 70, 520, 4, 8),     # 12 CTAs over 9 key tiles: the most splits
])
def test_flash_plan_from_shapes(B, Sq, Sk, H, want):
    """Splits double while the grid stays within the card's SMs and each
    split keeps a key tile, up to MAX_SPLITS."""
    splits = fa.plan(B, Sq, Sk, H)
    assert splits == want
    ctas = -(-Sq // fa.CC_ROWS) * H * B
    assert splits == 1 or splits * ctas <= fa.SMS
    assert splits <= min(-(-Sk // fa.CC_KEYS), fa.MAX_SPLITS)
    assert fa.uses_cuda_cores(448, torch.bfloat16)
    assert fa.uses_cuda_cores(64, torch.float32)
    assert not fa.uses_cuda_cores(64, torch.bfloat16)


# -------------------------------------------- RMSNorm's order, emulated


def _rmsnorm_emulation(x, scale, *, eps=1e-6, zero_centered=False):
    """``csrc/rmsnorm.cu`` in its own order, on the CPU, fp32 (before the
    final rounding to x's type): ``plan``'s tpr threads a row, thread t
    summing the squares of its vectors t, t + tpr, ... element by element;
    the xor tree over min(tpr, 32) lanes (offsets from 16 down to 1); past
    32 threads a row the warps' sums added in warp order; then
    ``x * rsqrt(ss / d + eps) * (scale [+ 1])``.  x [..., d]; scale
    [d]."""
    d = x.shape[-1]
    xf = x.reshape(-1, d).float()
    rows = xf.shape[0]
    nv, tpr = rn.plan(rows, d, x.dtype)
    vec = 16 // x.element_size()
    nvec = d // vec
    pad = torch.zeros(rows, nv * tpr * vec)
    pad[:, :d] = xf
    # [rows, nv, tpr, vec]: vector t + j * tpr is thread t's j-th
    parts = pad.reshape(rows, nv, tpr, vec)
    ss = torch.zeros(rows, tpr)
    for j in range(nv):
        for e in range(vec):
            f = parts[:, j, :, e]
            ss = ss + f * f
    lanes = torch.arange(tpr)
    off = min(tpr, 32) // 2
    while off:
        ss = ss + ss[:, lanes ^ off]
        off //= 2
    total = ss[:, 0]
    if tpr > 32:
        total = ss[:, 0]
        for w in range(1, tpr // 32):
            total = total + ss[:, 32 * w]
    r = torch.rsqrt(total / d + eps)[:, None]
    s = scale.float() + (1.0 if zero_centered else 0.0)
    assert nvec <= nv * tpr
    return (xf * r * s).reshape(x.shape)


@pytest.mark.parametrize("zero_centered", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", RMS_SHAPES)
def test_rmsnorm_split_reduction_within_exact_tol(shape, dtype,
                                                  zero_centered):
    """The kernel's split sum of squares (per thread, the xor tree, the
    warps in order), emulated on the CPU with ``plan``'s split of the row,
    stays within fp32 EXACT_TOL of the plain version on the same values,
    and rounded to bf16 within one bf16 ulp of the plain bf16 output."""
    rng = np.random.default_rng(3)
    tdt = getattr(torch, dtype)
    x = _t(rng.normal(size=shape), tdt)
    s = _t(rng.normal(size=shape[-1:]), tdt)
    got = _rmsnorm_emulation(x, s, zero_centered=zero_centered)
    want = rmsnorm_ref(x.float(), s.float(), zero_centered=zero_centered)
    np.testing.assert_allclose(_np(got), _np(want), **EXACT_TOL["float32"])
    same = rmsnorm_ref(x, s, zero_centered=zero_centered)
    np.testing.assert_allclose(_np(got.to(tdt)), _np(same),
                               **EXACT_TOL[dtype])


@pytest.mark.parametrize("rows,d,dtype,want", [
    (8, 896, torch.bfloat16, (1, 128)),     # a decode tick: 8 CTAs a row
    (64, 896, torch.bfloat16, (1, 128)),    # a prefill chunk
    (1024, 896, torch.float32, (4, 64)),    # the encoder: 4 vectors a thread
    (8, 5120, torch.float32, (8, 256)),     # zamba2's widest, few rows
    (768, 5120, torch.bfloat16, (4, 256)),  # ... at a prompt
    (5, 8, torch.bfloat16, (1, 1)),         # one vector a row
])
def test_rmsnorm_plan_from_shapes(rows, d, dtype, want):
    """Few rows spread a row over more threads, one vector each; many
    rows keep 4 vectors a thread; a thread holds more only where a row
    would need over MAX_THREADS threads; the plan covers the row."""
    nv, tpr = rn.plan(rows, d, dtype)
    assert (nv, tpr) == want
    vec = 16 * 8 // torch.finfo(dtype).bits
    assert nv in rn.VECTORS and tpr <= rn.MAX_THREADS
    assert tpr & (tpr - 1) == 0 and nv * tpr * vec >= d


def test_rmsnorm_plan_refuses_rows_past_its_reach():
    """A row of more than 8 x 256 16-byte vectors (16384 bf16, 8192 fp32
    values) is refused up front, not launched."""
    assert rn.plan(1, 8192, torch.float32) == (8, 256)
    assert rn.plan(1, 16384, torch.bfloat16) == (8, 256)
    with pytest.raises(ValueError, match="vectors a row"):
        rn.plan(1, 8196, torch.float32)


# ------------------------------------------------ the kernels (card)


def _widened(args):
    return [t.float() if t.is_floating_point() else t for t in args]


# fp32 at every head dim, a suffix against a cached prefix whose query
# rows start below Sk - Sq (q_offset 40 of Sk 150, Sq 70), with and without
# a window (test_torch_multimodal.py's kernel test takes the other edges)
GPU_FLASH_EDGES = [(2, 70, 150, 4, 2, D, True, window, 40)
                   for D in fa.HEAD_DIMS for window in (0, 24)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal,window,q_offset",
                         GPU_FLASH_EDGES)
def test_flash_fp32_kernel_at_its_edges(cuda, B, Sq, Sk, H, Hkv, D, causal,
                                        window, q_offset):
    args = [_t(a, None, cuda)
            for a in _flash_inputs(B, Sq, Sk, H, Hkv, D, seed=9)]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = ops.flash_attention.launches
    out = ops.flash_attention(*args, **kw)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (B, Sq, H, D)
    want = flash_attention_ref(*args, **kw)
    np.testing.assert_allclose(_np(out), _np(want), **EXACT_TOL["float32"])


@pytest.mark.gpu
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_flash_fp32_kernel_every_cluster_size(cuda, splits):
    """The C entry point at each split count on one input: every cluster
    size merges to the plain version (the wrapper's plan picks one)."""
    q, k, v = (_t(a, None, cuda)
               for a in _flash_inputs(2, 70, 520, 4, 2, 64, seed=6))
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    err = fa._lib().flash_attention_launch(
        0, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 2, 70,
        520, 4, 2, 64, 1, 0, 40, 64 ** -0.5, splits, stream)
    torch.cuda.synchronize()
    assert err == 0
    want = flash_attention_ref(q, k, v, q_offset=40)
    np.testing.assert_allclose(_np(out), _np(want), **EXACT_TOL["float32"])
    bad = fa._lib().flash_attention_launch(
        0, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 2, 70,
        520, 4, 2, 64, 1, 0, 40, 64 ** -0.5, 3, stream)
    assert bad == -2  # a cluster size that does not divide 32 rows


@pytest.mark.gpu
def test_rmsnorm_kernel_unaligned_scale(cuda):
    """A scale that does not start on a 16-byte boundary is read one value
    at a time in the same pass (no caller passes one; the old kernel took
    it, so the new one does)."""
    x = torch.randn(8, 896, device=cuda)
    big = torch.randn(897, device=cuda)
    out = ops.rmsnorm(x, big[1:])
    torch.cuda.synchronize()
    np.testing.assert_allclose(_np(out), _np(rmsnorm_ref(x, big[1:])),
                               **EXACT_TOL["float32"])
