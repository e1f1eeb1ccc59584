"""Port kernels: int8 KV quantization bit-equal to the JAX package, the
plain paged-decode versions held to the JAX kernels (interpret mode) and
to their jnp oracles, and — on a CUDA card only — the hand-written CUDA
kernel held to its plain version.

Inputs are made with numpy from a seed and handed to both packages.  JAX
is imported when present; without it the JAX comparisons skip and the card
tests still run.  The JAX side runs on the CPU wherever the tests run (the
``need_jax`` fixture pins it there): JAX on a GPU computes fp32 products
at a lower default precision than these tolerances allow for."""
import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.kernels.quant import dequantize_kv as jdequant
    from repro.kernels.quant import quantize_kv as jquant
except ImportError:  # JAX (the reference) is not installed
    jnp = None

from repro_torch.kernels import ops
from repro_torch.kernels.paged_decode import (paged_decode_quant_ref,
                                              paged_decode_ref)
from repro_torch.kernels.quant import dequantize_kv, quantize_kv


@pytest.fixture
def need_jax():
    """JAX, with the reference computed on the CPU on any host."""
    if jnp is None:
        pytest.skip("JAX (the reference package) is not installed here")
    with jax.default_device(jax.devices("cpu")[0]):
        yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


# tolerances: fp32 plain-vs-plain differs only in summation order; a bf16
# output may round the other way by one bf16 ulp (2^-7 relative); the
# port's plain versions vs the JAX kernels follow test_kv_cache.py:137 and
# test_kv_quant.py:85
PLAIN_TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
             "bfloat16": dict(atol=1e-2, rtol=2 ** -7)}
KERNEL_TOL = {"float32": dict(atol=2e-4, rtol=2e-4),
              "bfloat16": dict(atol=5e-2, rtol=5e-2)}
QUANT_TOL = dict(atol=5e-3, rtol=5e-3)
# the CUDA kernel vs its plain version on the same values widened to fp32:
# they differ in summation order and in the kernel's rounding of its fp32
# result to q's type (at most half a bf16 ulp), nothing else
EXACT_TOL = {"float32": dict(atol=1e-5, rtol=1e-4),
             "bfloat16": dict(atol=1e-5, rtol=2 ** -7)}

# (B, H, Hkv, D, bs, NB, window): the sweeps of test_kv_cache.py:130-135
# plus the qwen2-0.5b (G=7, D=64) and gemma3-1b (MQA, D=256) head layouts
BF16_CASES = [
    (2, 8, 2, 64, 16, 5, 0),
    (2, 4, 4, 32, 8, 5, 24),
    (1, 8, 1, 64, 32, 5, 0),
    (3, 14, 2, 64, 16, 8, 0),
    (2, 4, 1, 256, 16, 6, 40),
]
# the sweeps of test_kv_quant.py:65-69 (NB = S / bs) plus the same two
QUANT_CASES = [
    (2, 8, 2, 64, 16, 6, 0),
    (1, 4, 4, 32, 8, 8, 24),
    (3, 14, 2, 64, 16, 8, 0),
    (2, 4, 1, 256, 16, 6, 40),
]


def _paged_inputs(B, H, Hkv, D, bs, NB, seed):
    """q, pages, block tables with -1 tails, positions: every slot sees at
    least one full block of keys."""
    rng = np.random.default_rng(seed)
    P = 1 + 2 * B * NB
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    kp = rng.normal(size=(P, bs, Hkv, D)).astype(np.float32)
    vp = rng.normal(size=(P, bs, Hkv, D)).astype(np.float32)
    lens = rng.integers(bs, NB * bs, B)
    bt = np.full((B, NB), -1, np.int32)
    perm = rng.permutation(np.arange(1, P))
    used = 0
    for b, n in enumerate(lens):
        nb = -(-int(n) // bs)
        bt[b, :nb] = perm[used:used + nb]
        used += nb
    return q, kp, vp, bt, (lens - 1).astype(np.int32)


def _t(a, dtype=None, device="cpu"):
    t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def _np(x):
    return np.asarray(x.float().cpu() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32), np.float32)


# ---------------------------------------------------------------- quant


@pytest.mark.parametrize("shape,scale", [((3, 5, 4, 32), 7.0),
                                         ((2, 16, 2, 64), 1e-3),
                                         ((4, 8, 1, 256), 300.0)])
def test_quantize_kv_bit_equal(need_jax, shape, scale):
    x = (np.random.default_rng(1).normal(size=shape) * scale
         ).astype(np.float32)
    x[0, 0] = 0.0  # all-zero rows: scale 1.0
    x[1, 0, 0, :4] = [0.5, -0.5, 1.5, 127.0]  # ties at the row's own scale
    q, s = quantize_kv(torch.from_numpy(x))
    jq, js = jquant(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    back = dequantize_kv(q, s)
    jback = jdequant(jq, js)
    np.testing.assert_array_equal(back.numpy().view(np.int32),
                                  np.asarray(jback).view(np.int32))
    assert bool((s[0, 0] == 1.0).all())


def test_quantize_kv_rounds_half_to_even():
    x = torch.tensor([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0]])
    q, s = quantize_kv(x)  # scale = 1.0 exactly
    assert float(s[0]) == 1.0
    assert q.tolist() == [[0, 2, 2, 0, -2, 127]]


# --------------------------------------------- plain versions vs the JAX


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,D,bs,NB,window", BF16_CASES)
def test_paged_decode_plain_matches_jax(need_jax, B, H, Hkv, D, bs, NB,
                                        window, dtype):
    q, kp, vp, bt, pos = _paged_inputs(B, H, Hkv, D, bs, NB, seed=7)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = (jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
             jnp.asarray(bt), jnp.asarray(pos))
    out = ops.paged_decode(_t(q, tdt), _t(kp, tdt), _t(vp, tdt), _t(bt),
                           _t(pos), window=window)
    assert out.dtype == tdt and out.shape == (B, H, D)
    want = jref.paged_decode_ref(*jargs, window=window)
    np.testing.assert_allclose(_np(out), _np(want), **PLAIN_TOL[dtype])
    kern = jops.paged_decode(*jargs, window=window)  # Pallas, interpreted
    np.testing.assert_allclose(_np(out), _np(kern), **KERNEL_TOL[dtype])


def _quant_inputs(case, seed, poison=False):
    B, H, Hkv, D, bs, NB, window = case
    q, kp, vp, bt, pos = _paged_inputs(B, H, Hkv, D, bs, NB, seed)
    # bf16-rounded K/V quantized by the JAX package, as the engine stores
    kb = np.asarray(jnp.asarray(kp, jnp.bfloat16).astype(jnp.float32))
    vb = np.asarray(jnp.asarray(vp, jnp.bfloat16).astype(jnp.float32))
    k8, ks = (np.asarray(a) for a in jquant(jnp.asarray(kb)))
    v8, vs = (np.asarray(a) for a in jquant(jnp.asarray(vb)))
    if poison:  # garbage scales on the null page must never be read
        ks, vs = ks.copy(), vs.copy()
        ks[0], vs[0] = 1e6, 1e6
    return q, k8, v8, ks, vs, bt, pos


@pytest.mark.parametrize("poison", [False, True])
@pytest.mark.parametrize("B,H,Hkv,D,bs,NB,window", QUANT_CASES)
def test_paged_decode_quant_plain_matches_jax(need_jax, B, H, Hkv, D, bs,
                                              NB, window, poison):
    case = (B, H, Hkv, D, bs, NB, window)
    q, k8, v8, ks, vs, bt, pos = _quant_inputs(case, 11, poison)
    jargs = (jnp.asarray(q, jnp.bfloat16), jnp.asarray(k8), jnp.asarray(v8),
             jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(bt),
             jnp.asarray(pos))
    targs = (_t(q, torch.bfloat16), _t(k8), _t(v8), _t(ks), _t(vs), _t(bt),
             _t(pos))
    out = ops.paged_decode_quant(*targs, window=window)
    assert out.dtype == torch.bfloat16
    want = jref.paged_decode_quant_ref(*jargs, window=window)
    np.testing.assert_allclose(_np(out), _np(want), **PLAIN_TOL["bfloat16"])
    kern = jops.paged_decode_quant(*jargs, window=window)
    np.testing.assert_allclose(_np(out), _np(kern), **QUANT_TOL)
    assert bool(torch.isfinite(out.float()).all())


def test_paged_decode_quant_masks_unallocated(need_jax):
    """The poisoned null page of test_kv_quant.py:93-114: a [1, -1, -1]
    table must not leak page 0's garbage values or scales."""
    rng = np.random.default_rng(3)
    B, H, Hkv, D, bs, P = 1, 4, 2, 32, 8, 4
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k = rng.normal(size=(P, bs, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(P, bs, Hkv, D)).astype(np.float32)
    k8, ks = quantize_kv(_t(k, torch.bfloat16))
    v8, vs = quantize_kv(_t(v, torch.bfloat16))
    ks[0], vs[0] = 1e6, 1e6
    bt = np.asarray([[1, -1, -1]], np.int32)
    pos = np.asarray([bs - 1], np.int32)
    out = ops.paged_decode_quant(_t(q, torch.bfloat16), k8, v8, ks, vs,
                                 _t(bt), _t(pos))
    want = jref.paged_decode_quant_ref(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k8.numpy()),
        jnp.asarray(v8.numpy()), jnp.asarray(ks.numpy()),
        jnp.asarray(vs.numpy()), jnp.asarray(bt), jnp.asarray(pos))
    np.testing.assert_allclose(_np(out), _np(want), **QUANT_TOL)
    assert bool(torch.isfinite(out.float()).all())


def test_wrapper_runs_plain_version_on_cpu_only():
    q, kp, vp, bt, pos = _paged_inputs(2, 8, 2, 64, 16, 5, seed=0)
    before = ops.paged_decode.launches
    out = ops.paged_decode(_t(q), _t(kp), _t(vp), _t(bt), _t(pos))
    want = paged_decode_ref(_t(q), _t(kp), _t(vp), _t(bt), _t(pos))
    assert torch.equal(out, want)
    assert ops.paged_decode.launches == before  # no kernel on the CPU
    with pytest.raises(ValueError):
        ops.paged_decode(_t(q), _t(kp).to("meta"), _t(vp), _t(bt), _t(pos))


# -------------------------------------------- CUDA kernel vs plain (card)


def _rows_with_keys(pos, bt, bs, window):
    """Rows whose slot sees at least one key (the kernel writes zeros for
    the others, the plain version a uniform average of garbage)."""
    ok = []
    for b, p in enumerate(pos):
        keys = [j * bs + t for j in range(bt.shape[1]) if bt[b, j] >= 0
                for t in range(bs)]
        ok.append(any(k <= p and (not window or p - k < window)
                      for k in keys))
    return np.asarray(ok)


def _widened(args):
    return [t.float() if t.is_floating_point() else t for t in args]


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,D,bs,NB,window", BF16_CASES + [
    (8, 14, 2, 64, 16, 128, 0),     # qwen2-0.5b widths, 2048 context
    (8, 4, 1, 256, 16, 128, 512),   # gemma3-1b local layers
    (1, 24, 8, 128, 16, 128, 0),    # llama3.2-3b widths
])
def test_paged_decode_kernel_matches_plain(cuda, B, H, Hkv, D, bs, NB,
                                           window, q_dtype):
    q, kp, vp, bt, pos = _paged_inputs(B, H, Hkv, D, bs, NB, seed=5)
    qdt, pdt = getattr(torch, q_dtype), torch.bfloat16
    args = [_t(a, d, cuda) for a, d in ((q, qdt), (kp, pdt), (vp, pdt),
                                        (bt, None), (pos, None))]
    before = ops.paged_decode.launches
    out = ops.paged_decode(*args, window=window)
    torch.cuda.synchronize()
    assert ops.paged_decode.launches == before + 1
    assert out.dtype == qdt
    want = paged_decode_ref(*_widened(args), window=window)
    np.testing.assert_allclose(_np(out), _np(want), **EXACT_TOL[q_dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Hkv,D,bs,NB,window", QUANT_CASES + [
    (8, 14, 2, 64, 16, 128, 0),
    (8, 4, 1, 256, 16, 128, 512),
    (1, 24, 8, 128, 16, 128, 0),
])
def test_paged_decode_quant_kernel_matches_plain(cuda, B, H, Hkv, D, bs, NB,
                                                 window):
    q, kp, vp, bt, pos = _paged_inputs(B, H, Hkv, D, bs, NB, seed=9)
    k8, ks = quantize_kv(_t(kp, torch.bfloat16, cuda))
    v8, vs = quantize_kv(_t(vp, torch.bfloat16, cuda))
    ks[0], vs[0] = 1e6, 1e6  # poisoned null page
    bt[:, -1] = -1
    args = (_t(q, torch.bfloat16, cuda), k8, v8, ks, vs, _t(bt, None, cuda),
            _t(pos, None, cuda))
    out = ops.paged_decode_quant(*args, window=window)
    torch.cuda.synchronize()
    want = paged_decode_quant_ref(*_widened(args), window=window)
    rows = _rows_with_keys(pos, bt, bs, window)
    np.testing.assert_allclose(_np(out)[rows], _np(want)[rows],
                               **EXACT_TOL["bfloat16"])
    assert bool(torch.isfinite(out.float()).all())


@pytest.mark.gpu
def test_paged_decode_kernel_rejects_what_it_cannot_take(cuda):
    def args(H, D, page_dtype=torch.bfloat16):
        q, kp, vp, bt, pos = _paged_inputs(1, H, 2, D, 16, 2, seed=0)
        return [_t(a, d, cuda) for a, d in ((q, None), (kp, page_dtype),
                                            (vp, page_dtype), (bt, None),
                                            (pos, None))]
    with pytest.raises(ValueError):  # head dim 48 is not supported
        ops.paged_decode(*args(8, 48))
    with pytest.raises(ValueError):  # G = 17 query heads per kv head
        ops.paged_decode(*args(34, 64))
    bad = args(8, 64)
    bad[3] = bad[3].long()
    with pytest.raises(ValueError):  # int64 block tables
        ops.paged_decode(*bad)
    with pytest.raises(ValueError):  # fp32 pages: no serving pool has them
        ops.paged_decode(*args(8, 64, torch.float32))
    ops.paged_decode(*args(8, 64))  # and the same call with bf16 pages runs
