"""Port of speculative decoding against the JAX package: the plain paged
multi-token verify versions held to the JAX kernels (interpret mode) and
to their jnp oracles; the verify rows held to paged decode and to
chunked-prefill attention; ``Model.prefill`` (bucketed), the dense
``serve_step`` and ``verify_step_paged`` held to JAX on the same fp32
weights; the speculative engine's tokens and accept counts held to the
JAX speculative engine (bf16 and int8 pools, int8 held to int8 only);
the validation errors; the kernel's launch plan and a CPU emulation of
its order of operations (split-KV, two passes) held to the plain version;
and, on a CUDA card only, the hand-written verify kernel held to its
plain version.

Inputs are made with numpy from a seed and handed to both packages.  The
JAX side runs on the CPU on any host (the ``need_jax`` fixture pins it
there): JAX on a GPU computes fp32 products at a lower default precision
than these tolerances allow for.

Tolerances (each with its reason):
* plain verify vs the JAX oracle: fp32 differs in summation order only
  (1e-5); a bf16 output may round the other way by one bf16 ulp (2^-7
  relative, 1e-2 absolute near the largest outputs) - test_torch_kernels.py;
* plain vs the JAX Pallas kernel (interpret mode): the kernel's online
  softmax keeps the probabilities in fp32 where the oracle rounds them to
  the page type - 2e-4 fp32, 5e-2 bf16 (test_kv_cache.py:137), 5e-3 int8
  (test_kv_quant.py:85);
* verify row t vs paged decode at pos+t, fp32: two einsum orders, 1e-5;
* model steps: logits 1e-3, for the reason test_torch_model.py states
  (both pools round fp32 values that differ in their last bits between
  the packages); pages within one bf16 ulp of the value plus one of the
  layer's RMS, or one int8 step (``_hold_pages`` says why);
* the CUDA kernel vs its plain version on the same values widened to fp32:
  summation order and the kernel's final rounding to q's type only -
  EXACT_TOL, as test_torch_kernels.py; over bf16 pages, whose
  probabilities both round to bf16, ROUNDED_TOL on the plain version on
  |v| (test_torch_kernels.py says why); the emulation of the kernel's
  order is held the same way.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

try:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.kernels.quant import quantize_kv as jquant
    from repro.models import build_model as jbuild
    from repro.serving.engine import Request as JRequest
    from repro.serving.engine import ServingEngine as JEngine
except ImportError:  # JAX (the reference) is not installed
    jax = None

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.kernels import paged_verify as pv
from repro_torch.kernels.paged_decode import paged_decode_ref
from repro_torch.kernels.paged_verify import (paged_verify_quant_ref,
                                              paged_verify_ref)
from repro_torch.kernels.quant import quantize_kv
from repro_torch.models.api import build_model
from repro_torch.models.attention import (
    paged_chunk_prefill_attention, paged_chunk_prefill_attention_quant)
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.weights import from_jax_params
from test_torch_kernels import ROUNDED_TOL, hold_rounded

PLAIN_TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
             "bfloat16": dict(atol=1e-2, rtol=2 ** -7)}
KERNEL_TOL = {"float32": dict(atol=2e-4, rtol=2e-4),
              "bfloat16": dict(atol=5e-2, rtol=5e-2)}
QUANT_TOL = dict(atol=5e-3, rtol=5e-3)
EXACT_TOL = {"float32": dict(atol=1e-5, rtol=1e-4),
             "bfloat16": dict(atol=1e-5, rtol=2 ** -7)}

# (B, S, H, Hkv, D, bs, T, window): the sweeps of test_speculative.py:44-48,
# qwen2-0.5b widths at the speculative T = k+1 = 4, a T = 64 chunk of
# qwen2-0.5b heads, and a gemma3-1b (MQA, D 256) local-window case
CASES = [
    (2, 96, 8, 2, 64, 16, 4, 0),
    (1, 64, 4, 4, 32, 8, 3, 24),
    (2, 72, 8, 1, 64, 8, 5, 0),
    (2, 128, 14, 2, 64, 16, 4, 0),
    (1, 160, 14, 2, 64, 16, 64, 0),
    (2, 96, 4, 1, 256, 16, 6, 40),
]


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


def _verify_inputs(B, S, H, Hkv, D, bs, T, seed, *, inactive=(),
                   short=()):
    """q [B,T,H,D], fp32 pools, block tables with -1 tails covering each
    slot's pos+T positions, first-query positions; slots in ``inactive``
    get an all -1 row (and position 0), slots in ``short`` position 3 (a
    context of T + 3 keys)."""
    rng = np.random.default_rng(seed)
    NB = S // bs
    P = 1 + B * NB
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    kp = rng.normal(size=(P, bs, Hkv, D)).astype(np.float32)
    vp = rng.normal(size=(P, bs, Hkv, D)).astype(np.float32)
    pos = rng.integers(max(S // 2 - T, 0), S - T + 1, B).astype(np.int32)
    bt = np.full((B, NB), -1, np.int32)
    perm = rng.permutation(np.arange(1, P))
    used = 0
    for b in range(B):
        if b in inactive:
            pos[b] = 0
            continue
        if b in short:
            pos[b] = 3
        nb = -(-int(pos[b] + T) // bs)
        bt[b, :nb] = perm[used:used + nb]
        used += nb
    return q, kp, vp, bt, pos


def _t(a, dtype=None, device="cpu"):
    t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def _np(x):
    return np.asarray(x.float().cpu() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32), np.float32)


def _quantized(kp, vp, poison):
    """bf16-rounded K/V quantized by the JAX package, as the engine
    stores them; the null page's scales poisoned on request."""
    kb = np.asarray(jnp.asarray(kp, jnp.bfloat16).astype(jnp.float32))
    vb = np.asarray(jnp.asarray(vp, jnp.bfloat16).astype(jnp.float32))
    k8, ks = (np.array(a) for a in jquant(jnp.asarray(kb)))
    v8, vs = (np.array(a) for a in jquant(jnp.asarray(vb)))
    if poison:  # garbage scales on the null page must never be read
        ks[0], vs[0] = 1e6, 1e6
    return k8, v8, ks, vs


# --------------------------------------------- plain versions vs the JAX


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,Hkv,D,bs,T,window", CASES)
def test_paged_verify_plain_matches_jax(need_jax, B, S, H, Hkv, D, bs, T,
                                        window, dtype):
    q, kp, vp, bt, pos = _verify_inputs(B, S, H, Hkv, D, bs, T, seed=7)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = (jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
             jnp.asarray(bt), jnp.asarray(pos))
    out = ops.paged_verify(_t(q, tdt), _t(kp, tdt), _t(vp, tdt), _t(bt),
                           _t(pos), window=window)
    assert out.dtype == tdt and out.shape == (B, T, H, D)
    want = jref.paged_verify_ref(*jargs, window=window)
    np.testing.assert_allclose(_np(out), _np(want), **PLAIN_TOL[dtype])
    kern = jops.paged_verify(*jargs, window=window)  # Pallas, interpreted
    np.testing.assert_allclose(_np(out), _np(kern), **KERNEL_TOL[dtype])


@pytest.mark.parametrize("poison", [False, True])
@pytest.mark.parametrize("B,S,H,Hkv,D,bs,T,window",
                         [CASES[0], CASES[1], CASES[3], CASES[5]])
def test_paged_verify_quant_plain_matches_jax(need_jax, B, S, H, Hkv, D, bs,
                                              T, window, poison):
    q, kp, vp, bt, pos = _verify_inputs(B, S, H, Hkv, D, bs, T, seed=11)
    k8, v8, ks, vs = _quantized(kp, vp, poison)
    jargs = (jnp.asarray(q, jnp.bfloat16), jnp.asarray(k8), jnp.asarray(v8),
             jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(bt),
             jnp.asarray(pos))
    targs = (_t(q, torch.bfloat16), _t(k8), _t(v8), _t(ks), _t(vs), _t(bt),
             _t(pos))
    out = ops.paged_verify_quant(*targs, window=window)
    assert out.dtype == torch.bfloat16
    want = jref.paged_verify_quant_ref(*jargs, window=window)
    np.testing.assert_allclose(_np(out), _np(want), **PLAIN_TOL["bfloat16"])
    kern = jops.paged_verify_quant(*jargs, window=window)
    np.testing.assert_allclose(_np(out), _np(kern), **QUANT_TOL)
    assert bool(torch.isfinite(out.float()).all())


def test_verify_rows_match_sequential_decode():
    """Row t of one verify pass equals a paged decode at pos + t over the
    same pool: what makes the emitted prefix the sequential one."""
    q, kp, vp, bt, pos = _verify_inputs(2, 64, 4, 2, 32, 8, 4, seed=5)
    args = (_t(kp), _t(vp), _t(bt))
    out = ops.paged_verify(_t(q), *args, _t(pos))
    for t in range(q.shape[1]):
        step = ops.paged_decode(_t(q[:, t]), *args, _t(pos + t))
        np.testing.assert_allclose(_np(out[:, t]), _np(step),
                                   **PLAIN_TOL["float32"])


@pytest.mark.parametrize("quant", [False, True])
def test_verify_is_chunk_prefill_attention(quant):
    """The plain verify is chunked-prefill attention with qpos = pos +
    arange(T), bit for bit: so routing prefill_chunk_paged through
    ops.paged_verify changes nothing on the CPU."""
    q, kp, vp, bt, pos = _verify_inputs(2, 128, 14, 2, 64, 16, 64, seed=2)
    qpos = _t(pos)[:, None].long() + torch.arange(q.shape[1])[None]
    if quant:
        k8, ks = quantize_kv(_t(kp, torch.bfloat16))
        v8, vs = quantize_kv(_t(vp, torch.bfloat16))
        args = (_t(q, torch.bfloat16), k8, v8, ks, vs, _t(bt))
        got = ops.paged_verify_quant(*args, _t(pos), window=48)
        want = paged_chunk_prefill_attention_quant(*args, qpos, window=48)
    else:
        args = (_t(q, torch.bfloat16), _t(kp, torch.bfloat16),
                _t(vp, torch.bfloat16), _t(bt))
        got = ops.paged_verify(*args, _t(pos), window=48)
        want = paged_chunk_prefill_attention(*args, qpos, window=48)
    assert torch.equal(got, want)


def test_wrappers_run_plain_versions_on_cpu_only():
    q, kp, vp, bt, pos = _verify_inputs(2, 96, 8, 2, 64, 16, 4, seed=0)
    k8, ks = quantize_kv(_t(kp, torch.bfloat16))
    v8, vs = quantize_kv(_t(vp, torch.bfloat16))
    before = (ops.paged_verify.launches, ops.paged_verify_quant.launches)
    out = ops.paged_verify(_t(q), _t(kp), _t(vp), _t(bt), _t(pos))
    assert torch.equal(out, paged_verify_ref(_t(q), _t(kp), _t(vp), _t(bt),
                                             _t(pos)))
    qargs = (_t(q), k8, v8, ks, vs, _t(bt), _t(pos))
    assert torch.equal(ops.paged_verify_quant(*qargs),
                       paged_verify_quant_ref(*qargs))
    assert (ops.paged_verify.launches,
            ops.paged_verify_quant.launches) == before  # no kernel here
    with pytest.raises(ValueError):
        ops.paged_verify(_t(q), _t(kp).to("meta"), _t(vp), _t(bt), _t(pos))


# ------------------------- the kernel's launch plan and order, on the CPU


@pytest.mark.parametrize("B,T,G,Hkv,NB,bs,D", [
    (8, 4, 7, 2, 64, 16, 64),     # the speculative shape (qwen2-0.5b)
    (1, 64, 7, 2, 64, 16, 64),    # a prefill chunk
    (2, 4, 4, 1, 65, 16, 256),    # gemma3-1b heads, a ragged last split
    (3, 5, 4, 2, 9, 8, 16),       # the reduced configs' D 16, 72 keys
    (1, 1, 1, 1, 1, 16, 32),      # one page, one row
    (64, 64, 16, 8, 256, 16, 128),  # many pairs: one split
])
def test_verify_plan_covers_every_key_once(B, T, G, Hkv, NB, bs, D):
    """Every key of the table lies in exactly one split (the last may be
    ragged), splits are whole key tiles, every query row in one tile, and
    the plan depends on the shapes alone."""
    p = pv.plan(B, T, G, Hkv, NB, bs, D)
    S = NB * bs
    assert p.rows in (16, 32, 64) and p.tiles * p.rows >= T * G
    assert (p.tiles - 1) * p.rows < T * G
    assert p.split_keys % p.key_tile == 0 and p.key_tile == pv.key_tile(D)
    assert 1 <= p.splits <= pv.MAX_SPLITS
    covered = np.zeros(S, int)
    for s in range(p.splits):  # the kernel's split s
        k0, k1 = s * p.split_keys, min((s + 1) * p.split_keys, S)
        assert 0 <= k0 < k1 <= S
        assert k1 - k0 == p.split_keys or s == p.splits - 1
        covered[k0:k1] += 1
    assert (covered == 1).all()
    assert p.ctas == B * Hkv * p.tiles * p.splits
    assert p.ml_floats == 2 * p.ctas * p.rows
    assert p.partial_floats == (p.ctas * p.rows * D if p.splits > 1 else 0)


def test_verify_plan_fills_the_card_at_the_speculative_shape():
    """B 8, T 4, G 7, Hkv 2, NB 64 (16 slot x kv-head pairs of 28 rows):
    one 32-row tile a pair, keys split into 128 or more CTAs."""
    p = pv.plan(8, 4, 7, 2, 64, 16, 64)
    assert p.rows == 32 and p.tiles == 1
    assert p.ctas >= 128
    chunk = pv.plan(1, 64, 7, 2, 64, 16, 64)
    assert chunk.rows == 64 and chunk.tiles == 7 and chunk.ctas >= 128


NEG_INF, MASKED = -1e30, -1e29  # the kernel's fill and masked threshold
LOG2E = 1.4426950408889634


def _verify_emulation(q, k_pages, v_pages, block_tables, pos, *, window=0,
                      scales=None, online=False):
    """The bf16-q instantiation of ``csrc/paged_verify.cu`` in its own
    order, on the CPU.  Scores: exact bf16 products with fp32 sums (times
    the key's scale for int8 pages), in exp2 units, masked.  Per split of
    ``plan(...).split_keys`` keys: the row max m_i and sum l_i of exp2(s -
    m_i), online over the split's key tiles; merged in split order
    (splits with l_i = 0 skipped); p = exp2(s - m) / l rounded to bf16
    (bf16 pages) or, int8 pages, p * v_scale split into bf16 hi + lo; a
    row with no visible key p = 1/(NB*bs) on every key of the table; the
    [rows, D] partials summed in split order and rounded to q's type.
    ``online``: one pass instead, p rounded against the running max (bf16
    pages), what the kernel does not do."""
    B, T, H, D = q.shape
    _, bs, Hkv, _ = k_pages.shape
    NB = block_tables.shape[1]
    G, S = H // Hkv, NB * bs
    p = pv.plan(B, T, G, Hkv, NB, bs, D)
    SK, NS, KT = p.split_keys, p.splits, p.key_tile
    pad = NS * SK - S
    idx = block_tables.long().clamp(min=0)  # -1: the null page 0
    K = k_pages[idx].reshape(B, S, Hkv, D).float()
    V = v_pages[idx].reshape(B, S, Hkv, D).float()
    s = torch.einsum("btkgd,bskd->bkgts", q.float().reshape(B, T, Hkv, G, D),
                     K)
    if scales is not None:
        ks = scales[0][idx].reshape(B, S, Hkv).permute(0, 2, 1)
        s = s * ks[:, :, None, None, :]
    s = s * torch.tensor(D ** -0.5) * torch.tensor(LOG2E)
    alloc = (block_tables >= 0)[:, :, None].expand(B, NB, bs).reshape(B, S)
    qpos = pos[:, None].long() + torch.arange(T)[None]
    kpos = torch.arange(S)
    vis = alloc[:, None, :] & (kpos[None, None] <= qpos[:, :, None])
    if window:
        vis &= (qpos[:, :, None] - kpos[None, None]) < window
    x = torch.where(vis[:, None, None], s, torch.tensor(NEG_INF))
    zero, one = torch.zeros(()), torch.ones(())
    Vt = V.permute(0, 2, 1, 3)[:, :, None]  # [B, Hkv, 1, S, D]
    if online:
        m = torch.full(x.shape[:-1], NEG_INF)
        l = torch.zeros(x.shape[:-1])
        o = torch.zeros(x.shape[:-1] + (D,))
        for k0 in range(0, S, KT):
            xt = x[..., k0:k0 + KT]
            m_new = torch.maximum(m, xt.amax(-1))
            corr = torch.where(m > MASKED, torch.exp2(m - m_new), one)
            e = torch.where(xt > MASKED, torch.exp2(xt - m_new[..., None]),
                            zero)
            l = l * corr + e.sum(-1)
            o = o * corr[..., None] + e.bfloat16().float() @ \
                Vt[..., k0:k0 + KT, :]
            m = m_new
        out = o / l.clamp(min=1e-30)[..., None]
        return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, D).to(q.dtype)
    xs = F.pad(x, (0, pad), value=NEG_INF).reshape(x.shape[:-1] + (NS, SK))
    ms = torch.full(xs.shape[:-1], NEG_INF)
    ls = torch.zeros(xs.shape[:-1])
    for j in range(SK // KT):  # pass 1: online over a split's key tiles
        xt = xs[..., j * KT:(j + 1) * KT]
        m_new = torch.maximum(ms, xt.amax(-1))
        corr = torch.where(ms > MASKED, torch.exp2(ms - m_new), one)
        e = torch.where(xt > MASKED, torch.exp2(xt - m_new[..., None]), zero)
        ls = ls * corr + e.sum(-1)
        ms = m_new
    m = torch.full(x.shape[:-1], NEG_INF)
    l = torch.zeros(x.shape[:-1])
    for t in range(NS):  # pass 2: the merge, in split order
        m = torch.where(ls[..., t] > 0, torch.maximum(m, ms[..., t]), m)
    for t in range(NS):
        l = l + torch.where(ls[..., t] > 0,
                            ls[..., t] * torch.exp2(ms[..., t] - m), zero)
    dead = l == 0
    inv_l = torch.where(dead, zero, 1 / torch.where(dead, one, l))
    prob = torch.exp2(xs - m[..., None, None]) * inv_l[..., None, None]
    inside = F.pad(torch.ones(S, dtype=torch.bool), (0, pad)).reshape(NS, SK)
    uniform = torch.tensor(1.0) / S
    prob = torch.where(dead[..., None, None],
                       torch.where(inside, uniform, zero), prob)[..., None, :]
    Vs = F.pad(V, (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3).reshape(
        B, Hkv, 1, 1, NS, SK, D)
    if scales is not None:
        vs = F.pad(scales[1][idx].reshape(B, S, Hkv), (0, 0, 0, pad))
        pp = prob * vs.permute(0, 2, 1).reshape(B, Hkv, 1, 1, NS, 1, SK)
        hi = pp.bfloat16().float()
        part = hi @ Vs + (pp - hi).bfloat16().float() @ Vs
    else:
        part = prob.bfloat16().float() @ Vs
    out = torch.zeros(x.shape[:-1] + (D,))
    for t in range(NS):  # pass 3: the partials, in split order
        out = out + part[..., t, 0, :]
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, D).to(q.dtype)


def _emulation_inputs(B, S, H, Hkv, D, bs, T, window, pages):
    """bf16 q and pages (or int8 pages with the null page's scales
    poisoned), a free last slot, and the rows that see a key."""
    inactive = (B - 1,) if B > 1 else ()
    q, kp, vp, bt, pos = _verify_inputs(B, S, H, Hkv, D, bs, T, seed=5,
                                        inactive=inactive)
    args = [_t(q, torch.bfloat16), _t(kp, torch.bfloat16),
            _t(vp, torch.bfloat16), _t(bt), _t(pos)]
    if pages == "int8":
        k8, ks = quantize_kv(args[1])
        v8, vs = quantize_kv(args[2])
        ks[0], vs[0] = 1e6, 1e6
        args = [args[0], k8, v8, ks, vs] + args[3:]
    return args, _rows_with_keys(pos, bt, bs, T, window)


@pytest.mark.parametrize("pages", ["bf16", "int8"])
@pytest.mark.parametrize("B,S,H,Hkv,D,bs,T,window", CASES)
def test_verify_split_order_within_tolerance(B, S, H, Hkv, D, bs, T, window,
                                             pages):
    """The kernel's order (per-split m and l merged in split order, p
    rounded with the merged m and l, partials summed in split order; int8
    p * v_scale as bf16 hi + lo), emulated on the CPU, against the plain
    version on the values widened to fp32: ROUNDED_TOL on |v| over bf16
    pages, EXACT_TOL over int8 pages (whose p stays fp32); rows with no
    visible key (the free slot) as on the card."""
    args, rows = _emulation_inputs(B, S, H, Hkv, D, bs, T, window, pages)
    kw = dict(window=window)
    if pages == "bf16":
        got = _verify_emulation(*args, **kw)
        plain = paged_verify_ref
        hold_rounded(got, plain, args, kw, rows)
    else:
        got = _verify_emulation(*args[:3], *args[5:],
                                scales=(args[3], args[4]), **kw)
        plain = paged_verify_quant_ref
        want = _np(plain(*_widened(args), **kw))
        np.testing.assert_allclose(_np(got)[rows], want[rows],
                                   **EXACT_TOL["bfloat16"])
    assert got.dtype == torch.bfloat16 and got.shape == (B, T, H, D)
    assert (~rows).any() == (B > 1)
    _hold_dead_rows(got, plain, args, ~rows, kw, "bfloat16")


def _online_departure(B, S, H, Hkv, D, bs, T, window):
    """(share of outputs that differ from the plain version in the
    working type, largest error over EXACT_TOL's bound) of the split order
    and of one online pass, on the rows that see a key (bf16 pages)."""
    args, rows = _emulation_inputs(B, S, H, Hkv, D, bs, T, window, "bf16")
    want = paged_verify_ref(*args, window=window).float()[rows]
    tol = EXACT_TOL["bfloat16"]
    res = []
    for online in (False, True):
        got = _verify_emulation(*args, window=window,
                                online=online).float()[rows]
        err = (got - want).abs()
        res.append((float((err > 0).float().mean()),
                    float((err / (tol["atol"] + tol["rtol"]
                                  * want.abs())).max())))
    return res


@pytest.mark.parametrize("B,S,H,Hkv,D,bs,T,window", CASES)
def test_online_rounding_leaves_the_plain_versions_rounding(
        B, S, H, Hkv, D, bs, T, window):
    """Why two passes: rounding p to bf16 against a running max (one
    online pass) rounds about half the probabilities otherwise than the
    plain version (the CPU engine), which rounds softmax(s) with the final
    max and sum; against it in the working type the output then leaves
    EXACT_TOL by 10x or more and about half its elements differ.  The
    split order rounds as the plain version does: under 1 % of the
    elements differ (where fp32 p differs in its last bit at a rounding
    boundary).  Both stay within ROUNDED_TOL of the widened plain version,
    which bounds the size of each rounding, not where it falls."""
    (split_share, _), (online_share, online_err) = _online_departure(
        B, S, H, Hkv, D, bs, T, window)
    assert split_share < 0.01
    assert online_share > 0.3 and online_err > 10


# ----------------------------------------------------- model steps vs JAX


def _models(arch):
    cfg = jreduced(jget_config(arch), act_dtype="float32")
    jm = jbuild(cfg)
    jp = jm.init(jax.random.PRNGKey(0), param_dtype=jnp.float32)
    tm = build_model(reduced(get_config(arch), act_dtype="float32"))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jm, jp, tm, tp


def _hold_pages(jcache, tcache):
    """Pages (null page 0 excluded) within one bf16 ulp of the larger
    value plus one bf16 ulp of the layer's RMS (int8: one step), scales
    to a few fp32 ulps.  The RMS term is there because layer l's K/V
    inherit layer l-1's attention, whose probabilities are rounded to the
    page type: an fp32 probability that differs in its last bits between
    the packages can round to the neighbouring bf16 value and move a
    later layer's K/V by a few bf16 ulps of the row (a 45-token chunk
    showed 2 ulps, 2e-3 against values of 0.21 and an RMS near 1); a
    wrong mask, rope or page moves them by the RMS itself.  Where the
    pages differ at all, the JAX pages are copied into the port's pool
    so the next step starts equal."""
    differ = False
    for name, leaf in jcache.items():
        a = np.asarray(leaf.astype(jnp.float32))[:, 1:]
        b = tcache[name].float().numpy()[:, 1:]
        if name.endswith("scales"):
            np.testing.assert_allclose(b, a, rtol=4e-6, atol=0)
        elif leaf.dtype == jnp.int8:
            assert np.abs(a - b).max() <= 1, name
        else:
            rms = np.sqrt((a.reshape(len(a), -1) ** 2).mean(-1))
            bound = 2.0 ** -7 * (np.maximum(np.abs(a), np.abs(b))
                                 + rms[:, None, None, None, None])
            assert bool((np.abs(a - b) <= bound).all()), name
        differ |= bool((a != b).any())
    if differ:
        for name, leaf in from_jax_params(dict(jcache), device="cpu").items():
            tcache[name].copy_(leaf)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma3-1b"])
def test_prefill_and_dense_decode_match_jax(need_jax, arch):
    """Bucketed monolithic prefill and three dense decode steps (slot 1
    parked at pos = max_seq, whose writes must drop): logits and the
    written dense cache against the JAX package's."""
    cfg, jm, jp, tm, tp = _models(arch)
    B, Sa, Sb = 3, 48, 32
    rng = np.random.default_rng(1)
    lengths = np.asarray([21, 32, 9], np.int32)
    toks = np.zeros((B, Sb), np.int64)
    for b, n in enumerate(lengths):
        toks[b, :n] = rng.integers(0, cfg.vocab, n)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32),
                             "length": jnp.asarray(lengths)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                             "length": torch.from_numpy(lengths)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-3,
                               rtol=1e-3)
    np.testing.assert_array_equal(tc["pos_map"].numpy(),
                                  np.asarray(jc["pos_map"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=1e-4, rtol=1e-4)
    # splice into a bf16 dense cache of Sa positions, as the engine does
    jcache = {n: jnp.zeros(s.shape, s.dtype) if n != "pos_map"
              else jnp.full(s.shape, -1, s.dtype)
              for n, s in jm.abstract_cache(B, Sa).items()}
    jcache = {n: leaf.at[:, :, :Sb].set(jc[n].astype(leaf.dtype))
              if n != "pos_map" else leaf.at[:, :Sb].set(jc[n])
              for n, leaf in jcache.items()}
    tcache = {n: torch.from_numpy(np.array(leaf.astype(jnp.float32)))
              .to(tm.abstract_cache(B, Sa)[n].dtype)
              for n, leaf in jcache.items()}
    assert {n: tuple(t.shape) for n, t in tcache.items()} == \
        {n: tuple(s.shape) for n, s in jm.abstract_cache(B, Sa).items()}
    pos = lengths.astype(np.int64)
    pos[1] = Sa  # parked: every write drops
    last = np.asarray(jnp.argmax(jl, -1))
    for _ in range(3):
        jl, jcache = jm.serve_step(jp, jcache, {
            "tokens": jnp.asarray(last, jnp.int32),
            "pos": jnp.asarray(pos, jnp.int32)})
        tl, tcache = tm.serve_step(tp, tcache, {
            "tokens": torch.from_numpy(last.astype(np.int64)),
            "pos": torch.from_numpy(pos)})
        live = [0, 2]
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   atol=1e-3, rtol=1e-3)
        np.testing.assert_array_equal(tcache["pos_map"].numpy(),
                                      np.asarray(jcache["pos_map"]))
        for name in ("k", "v"):
            a = np.array(jcache[name].astype(jnp.float32))
            b = tcache[name].float().numpy()
            bound = 2.0 ** -7 * np.maximum(np.abs(a), np.abs(b))
            assert bool((np.abs(a - b) <= bound).all()), name
            tcache[name].copy_(torch.from_numpy(a))
        last = np.asarray(jnp.argmax(jl, -1))
        pos[live] += 1


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma3-1b"])
def test_verify_step_matches_jax(need_jax, arch, kv_dtype):
    """Two verify passes of T = 4 tokens over a paged pool holding two
    prefilled slots, a parked slot (null table, pos = max_seq) and a slot
    whose last rows run past its block table: logits of the live rows and
    every written page against the JAX package's."""
    cfg, jm, jp, tm, tp = _models(arch)
    NB, bs, P, T = 6, 8, 16, 4
    abstract = jm.abstract_paged_cache(P, bs, kv_dtype=kv_dtype)
    jcache = {n: jnp.zeros(s.shape, s.dtype) for n, s in abstract.items()}
    tcache = {n: torch.zeros(s.shape, dtype=s.dtype)
              for n, s in tm.abstract_paged_cache(P, bs, kv_dtype).items()}
    rows = {0: [3, 1, 5, 7], 2: [2, 4, 6, 8, 9, 10], 3: [11, 12, 13]}
    tables = np.full((4, NB), -1, np.int32)
    for slot, pages in rows.items():
        tables[slot, :len(pages)] = pages
    rng = np.random.default_rng(0)
    lengths = {0: 21, 2: 45, 3: 14}
    for slot, n in lengths.items():  # one prefill chunk per slot
        C = 64
        padded = np.zeros(C, np.int64)
        padded[:n] = rng.integers(0, cfg.vocab, n)
        jl, jcache = jm.prefill_chunk_paged(jp, jcache, {
            "tokens": jnp.asarray(padded, jnp.int32)[None],
            "block_tables": jnp.asarray(tables[slot])[None],
            "pos": jnp.asarray(0, jnp.int32),
            "length": jnp.asarray(n, jnp.int32)})
        tl, tcache = tm.prefill_chunk_paged(tp, tcache, {
            "tokens": torch.from_numpy(padded)[None],
            "block_tables": torch.from_numpy(tables[slot])[None],
            "pos": 0, "length": n})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-3,
                                   rtol=1e-3)
        _hold_pages(jcache, tcache)
    # slot 2 ends at 45 + T > NB * bs - 1 on the second pass: its rows
    # past the table must drop; slot 1 is parked at pos = max_seq = 48
    pos = np.asarray([21, NB * bs, 42, 14], np.int32)
    live = [0, 2, 3]
    for _ in range(2):
        toks = rng.integers(0, cfg.vocab, (4, T))
        jl, jcache = jm.verify_step_paged(jp, jcache, {
            "tokens": jnp.asarray(toks, jnp.int32),
            "pos": jnp.asarray(pos), "block_tables": jnp.asarray(tables)})
        tl, tcache = tm.verify_step_paged(tp, tcache, {
            "tokens": torch.from_numpy(toks), "pos": torch.from_numpy(pos),
            "block_tables": torch.from_numpy(tables)})
        assert tl.shape == (4, T, cfg.vocab)
        want = np.asarray(jl)
        for b in live:  # rows inside the table: positions < NB * bs
            n = min(T, NB * bs - int(pos[b]))
            np.testing.assert_allclose(tl.numpy()[b, :n], want[b, :n],
                                       atol=1e-3, rtol=1e-3)
        _hold_pages(jcache, tcache)
        pos[live] += 3


# ------------------------------------------------ the speculative engine


def _draft(cfg, jp, kind):
    """The draft model: the target itself, or its first layer alone (the
    target's embed, layer 0 and final norm)."""
    if kind == "self":
        return cfg, jp
    one = dataclasses.replace(cfg, n_layers=1)
    return one, {**jp, "layers": jax.tree.map(lambda a: a[:1],
                                              jp["layers"])}


def _serve(engine_cls, request_cls, model, params, prompts, **kw):
    eng = engine_cls(model, params, max_batch=2, max_seq=64, page_size=8,
                     **kw)
    reqs = [request_cls(i, p, max_new_tokens=10)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return eng, [tuple(r.output) for r in reqs]


SPEC_STATS = ("spec_tokens_drafted", "spec_tokens_accepted",
              "spec_tokens_wasted", "decode_tokens", "prefix_hits",
              "prefill_tokens_computed", "pages_in_use")


@pytest.mark.parametrize("draft", ["self", "one_layer"])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_spec_engine_matches_jax(need_jax, kv_dtype, draft):
    """Same tokens and the same drafted/accepted/wasted counts as the JAX
    speculative engine, spec_k = 3; and spec-on equals spec-off in the
    port.  int8 is held to the JAX int8 engine only."""
    cfg, jm, jp, tm, tp = _models("qwen2-0.5b")
    dcfg, djp = _draft(cfg, jp, draft)
    dtp = from_jax_params(jax.tree.map(np.asarray, djp), device="cpu")
    tdcfg = dataclasses.replace(tm.cfg, n_layers=dcfg.n_layers)
    rng = np.random.default_rng(3)
    shared = rng.integers(0, cfg.vocab, 16)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (6, 21, 33, 9)]
    prompts += [np.concatenate([shared, rng.integers(0, cfg.vocab, 3)])
                .astype(np.int32) for _ in range(2)]
    kw = dict(kv_dtype=kv_dtype, spec_k=3, prefill_chunk=16)
    jeng, want = _serve(JEngine, JRequest, jm, jp, prompts,
                        draft_config=dcfg, draft_params=djp, **kw)
    eng, got = _serve(ServingEngine, Request, tm, tp, prompts,
                      draft_config=tdcfg, draft_params=dtp, device="cpu",
                      **kw)
    assert got == want
    js, ts = jeng.stats(), eng.stats()
    assert {k: ts[k] for k in SPEC_STATS} == {k: js[k] for k in SPEC_STATS}
    assert ts["speculative"] and ts["spec_k"] == 3
    assert ts["spec_tokens_accepted"] > 0 and ts["prefix_hits"] > 0
    assert eng.acceptance_rate() == pytest.approx(js["acceptance_rate"])
    assert ts["verify_steps"] > 0 and ts["decode_steps"] == 0
    _, plain = _serve(ServingEngine, Request, tm, tp, prompts, device="cpu",
                      kv_dtype=kv_dtype, prefill_chunk=16)
    assert got == plain
    assert eng.pool.pages_in_use() == 0


def _reduced(**kw):
    model = build_model(reduced(get_config("qwen2-0.5b"),
                                act_dtype="float32"))
    params = model.init(0, param_dtype=torch.float32, device="cpu")
    return model, params


def test_spec_validation_errors():
    """The errors of test_speculative.py:200-206, plus the draft checks."""
    model, params = _reduced()
    cfg = model.cfg
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(model, params, paged=False, draft_config=cfg,
                      device="cpu")
    with pytest.raises(ValueError, match="spec_k"):
        ServingEngine(model, params, draft_config=cfg, spec_k=0,
                      device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        ServingEngine(model, params, device="cpu",
                      draft_config=dataclasses.replace(cfg, vocab=256))
    with pytest.raises(ValueError, match="attention-family"):
        ServingEngine(model, params, device="cpu",
                      draft_config=reduced(get_config("zamba2-2.7b")))


def test_spec_engine_streams_and_counts():
    """Multi-token ticks stream one event per token with contiguous
    indices; verify passes and prefill chunks are counted (the kernel's
    launches on the card are n_layers per each)."""
    model, params = _reduced()
    kw = dict(max_batch=2, max_seq=64, page_size=8, device="cpu")
    plain = ServingEngine(model, params, **kw)
    eng = ServingEngine(model, params, draft_config=model.cfg,
                        draft_params=params, spec_k=3, **kw)
    events = []
    for e, sink in ((plain, None), (eng, events.append)):
        reqs = [Request(i, np.arange(5 + 9 * i) % 97, max_new_tokens=9,
                        stream=sink) for i in range(3)]
        for r in reqs:
            e.submit(r)
        e.run_until_drained()
    st = eng.stats()
    assert all(len(r.output) == 9 for r in reqs)
    for r in reqs:
        mine = [e for e in events if e.uid == r.uid]
        assert [e.index for e in mine] == list(range(9))
        assert [e.token for e in mine] == r.output
        assert [e.final for e in mine] == [False] * 8 + [True]
    assert st["decode_tokens"] == 3 * 8 and st["decode_steps"] == 0
    # some ticks emitted several tokens per slot
    assert st["verify_steps"] < plain.stats()["decode_steps"]
    assert st["prefill_chunks"] == 3
    assert 0 < eng.acceptance_rate() <= 1


# -------------------------------------------- CUDA kernel vs plain (card)


def _rows_with_keys(pos, bt, bs, T, window):
    """[B, T] rows that see at least one key (the others get the uniform
    average of the value rows their table addresses)."""
    B, NB = bt.shape
    ok = np.zeros((B, T), bool)
    for b in range(B):
        keys = [j * bs + i for j in range(NB) if bt[b, j] >= 0
                for i in range(bs)]
        for t in range(T):
            p = pos[b] + t
            ok[b, t] = any(k <= p and (not window or p - k < window)
                           for k in keys)
    return ok


def _widened(args):
    return [t.float() if t.is_floating_point() else t for t in args]


def _hold_dead_rows(out, plain, args, dead, kw, q_dtype):
    """Rows with no visible key against the plain version on the same
    inputs: the uniform softmax over every key it reads (a free slot's
    token is routed by an MoE layer, so the kernel gives these rows the
    plain version's output).  The kernel sums the same weighted value rows
    in another order, so the tolerance is EXACT_TOL's relative part times
    the plain version on |v| (args[2])."""
    if not dead.any():
        return
    want = _np(plain(*args, **kw))[dead]
    absargs = list(args)
    absargs[2] = args[2].abs()
    scale = _np(plain(*absargs, **kw))[dead]
    tol = EXACT_TOL[q_dtype]
    assert bool((np.abs(_np(out)[dead] - want)
                 <= tol["atol"] + tol["rtol"] * scale).all())


GPU_CASES = CASES + [
    (3, 128, 14, 2, 64, 16, 1, 0),     # T = 1: a decode step
    (8, 2048, 14, 2, 64, 16, 4, 0),    # qwen2-0.5b, the speculative shape
    (1, 1024, 14, 2, 64, 16, 64, 0),   # qwen2-0.5b, a prefill chunk
    (2, 1024, 4, 1, 256, 16, 64, 512),  # gemma3-1b local layers, a chunk
    (2, 512, 24, 8, 128, 16, 4, 0),    # llama3.2-3b widths
    (2, 4096, 14, 2, 64, 16, 4, 0),    # 4096 keys: 32 splits (bf16 q),
                                       # scores in global memory (fp32)
    (2, 1040, 14, 2, 64, 16, 4, 0),    # 65 pages: the last split ragged
    (2, 2048, 4, 1, 256, 16, 4, 512),  # gemma3-1b window: splits skipped
]


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,Hkv,D,bs,T,window", GPU_CASES)
def test_paged_verify_kernel_matches_plain(cuda, B, S, H, Hkv, D, bs, T,
                                           window, q_dtype):
    inactive = (B - 1,) if B > 1 else ()
    q, kp, vp, bt, pos = _verify_inputs(B, S, H, Hkv, D, bs, T, seed=5,
                                        inactive=inactive)
    qdt, pdt = getattr(torch, q_dtype), torch.bfloat16
    args = [_t(a, d, cuda) for a, d in ((q, qdt), (kp, pdt), (vp, pdt),
                                        (bt, None), (pos, None))]
    before = ops.paged_verify.launches
    kw = dict(window=window)
    out = ops.paged_verify(*args, **kw)
    torch.cuda.synchronize()
    assert ops.paged_verify.launches == before + 1
    assert out.dtype == qdt and out.shape == (B, T, H, D)
    rows = _rows_with_keys(pos, bt, bs, T, window)
    hold_rounded(out, paged_verify_ref, args, kw, rows)
    _hold_dead_rows(out, paged_verify_ref, args, ~rows, kw, q_dtype)
    # against the plain version in the working type: both round the
    # probabilities to bf16 (either may round one the other way), so the
    # bf16 tolerance of test_kv_cache.py
    np.testing.assert_allclose(_np(out), _np(paged_verify_ref(*args, **kw)),
                               **KERNEL_TOL["bfloat16"])


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,Hkv,D,bs,T,window", GPU_CASES)
def test_paged_verify_quant_kernel_matches_plain(cuda, B, S, H, Hkv, D, bs,
                                                 T, window, q_dtype):
    inactive = (B - 1,) if B > 1 else ()
    q, kp, vp, bt, pos = _verify_inputs(B, S, H, Hkv, D, bs, T, seed=9,
                                        inactive=inactive)
    k8, ks = quantize_kv(_t(kp, torch.bfloat16, cuda))
    v8, vs = quantize_kv(_t(vp, torch.bfloat16, cuda))
    ks[0], vs[0] = 1e6, 1e6  # poisoned null page
    args = (_t(q, getattr(torch, q_dtype), cuda), k8, v8, ks, vs,
            _t(bt, None, cuda), _t(pos, None, cuda))
    before = ops.paged_verify_quant.launches
    out = ops.paged_verify_quant(*args, window=window)
    torch.cuda.synchronize()
    assert ops.paged_verify_quant.launches == before + 1
    want = paged_verify_quant_ref(*_widened(args), window=window)
    rows = _rows_with_keys(pos, bt, bs, T, window)
    np.testing.assert_allclose(_np(out)[rows], _np(want)[rows],
                               **EXACT_TOL[q_dtype])
    _hold_dead_rows(out, paged_verify_quant_ref, args, ~rows,
                    dict(window=window), q_dtype)
    assert bool(torch.isfinite(out.float()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pages", ["bf16", "int8"])
@pytest.mark.parametrize("B,free,short", [
    (8, (6, 7), ()),   # the speculative shape with two free slots
    (3, (), (1,)),     # a slot shorter than one split
])
def test_paged_verify_kernels_free_and_short_slots(cuda, B, free, short,
                                                   pages, q_dtype):
    """qwen2-0.5b heads, 1024-key tables (16 splits of 64 keys): slots
    with no key (every split averages its keys for them) and a slot whose
    keys all lie in the first split, held as in the tests above; and the
    wrapper makes no device-to-host sync (it never reads pos or the
    tables on the host)."""
    S, H, Hkv, D, bs, T = 1024, 14, 2, 64, 16, 4
    q, kp, vp, bt, pos = _verify_inputs(B, S, H, Hkv, D, bs, T, seed=13,
                                        inactive=free, short=short)
    qdt = getattr(torch, q_dtype)
    kb, vb = _t(kp, torch.bfloat16, cuda), _t(vp, torch.bfloat16, cuda)
    if pages == "bf16":
        fn, plain, args = ops.paged_verify, paged_verify_ref, [kb, vb]
    else:
        k8, ks = quantize_kv(kb)
        v8, vs = quantize_kv(vb)
        ks[0], vs[0] = 1e6, 1e6  # poisoned null page
        fn, plain, args = ops.paged_verify_quant, paged_verify_quant_ref, [
            k8, v8, ks, vs]
    args = [_t(q, qdt, cuda)] + args + [_t(bt, None, cuda),
                                        _t(pos, None, cuda)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    rows = _rows_with_keys(pos, bt, bs, T, 0)
    assert rows[list(short)].all() and not rows[list(free)].any()
    if pages == "bf16":
        hold_rounded(out, plain, args, {}, rows)
    else:
        np.testing.assert_allclose(_np(out)[rows],
                                   _np(plain(*_widened(args)))[rows],
                                   **EXACT_TOL[q_dtype])
    _hold_dead_rows(out, plain, args, ~rows, {}, q_dtype)
    assert bool(torch.isfinite(out.float()).all())


@pytest.mark.gpu
def test_paged_verify_kernel_bf16_row_t_is_decode(cuda):
    """With bf16 queries (the tensor-core instantiation) verify row t
    stays within ROUNDED_TOL, on |v|, of the decode kernel at pos + t
    (CUDA-core products): both round their probabilities to bf16 from
    fp32 scores summed in other orders, so either may round one the
    other way."""
    q, kp, vp, bt, pos = _verify_inputs(4, 256, 14, 2, 64, 16, 4, seed=3)
    args = [_t(a, torch.bfloat16, cuda) for a in (kp, vp)]
    bt_c, pos_c = _t(bt, None, cuda), _t(pos, None, cuda)
    qb = _t(q, torch.bfloat16, cuda)
    out = ops.paged_verify(qb, *args, bt_c, pos_c)
    absv = args[1].float().abs()
    for t in range(q.shape[1]):
        qt = qb[:, t].contiguous()
        step = ops.paged_decode(qt, *args, bt_c, pos_c + t)
        scale = paged_decode_ref(qt.float(), args[0].float(), absv, bt_c,
                                 pos_c + t)
        err = (out[:, t].float() - step.float()).abs()
        assert bool((err <= ROUNDED_TOL["atol"]
                     + ROUNDED_TOL["rtol"] * scale).all()), float(err.max())


@pytest.mark.gpu
def test_paged_verify_kernel_row_t_is_decode(cuda):
    """On the card too, verify row t equals the decode kernel at pos + t
    (fp32 queries: both form each probability from their stored fp32
    scores and round it to bf16 alike, and differ in summation order
    only)."""
    q, kp, vp, bt, pos = _verify_inputs(4, 256, 14, 2, 64, 16, 4, seed=3)
    args = [_t(a, torch.bfloat16, cuda) for a in (kp, vp)]
    bt_c, pos_c = _t(bt, None, cuda), _t(pos, None, cuda)
    out = ops.paged_verify(_t(q, None, cuda), *args, bt_c, pos_c)
    for t in range(q.shape[1]):
        step = ops.paged_decode(_t(q[:, t], None, cuda), *args, bt_c,
                                pos_c + t)
        np.testing.assert_allclose(_np(out[:, t]), _np(step),
                                   **EXACT_TOL["float32"])


@pytest.mark.gpu
def test_paged_verify_kernel_rejects_what_it_cannot_take(cuda):
    def args(H, D, T=4, page_dtype=torch.bfloat16):
        q, kp, vp, bt, pos = _verify_inputs(1, 64, H, 2, D, 16, T, seed=0)
        return [_t(a, d, cuda) for a, d in ((q, None), (kp, page_dtype),
                                            (vp, page_dtype), (bt, None),
                                            (pos, None))]
    with pytest.raises(ValueError):  # head dim 48 is not supported
        ops.paged_verify(*args(8, 48))
    with pytest.raises(ValueError):  # G = 17 query heads per kv head
        ops.paged_verify(*args(34, 64))
    with pytest.raises(ValueError):  # fp32 pages: no serving pool has them
        ops.paged_verify(*args(8, 64, page_dtype=torch.float32))
    bad = args(8, 64)
    bad[0] = bad[0][:, 0]  # a decode-shaped q
    with pytest.raises(ValueError):
        ops.paged_verify(*bad)
    ops.paged_verify(*args(8, 64))  # and the same call at [B,T,H,D] runs


if __name__ == "__main__":
    # why two passes, on CASES (seed 5, bf16 pages, the rows that see a
    # key): (share of outputs that differ from the plain version in the
    # working type, largest error over EXACT_TOL's bound) of the kernel's
    # split order and of one online pass that rounds p against a running
    # max
    for case in CASES:
        (s_share, s_err), (o_share, o_err) = _online_departure(*case)
        print(case, f"split order: {s_share:.4f} of outputs differ, "
              f"{s_err:.2f} x EXACT_TOL; online: {o_share:.4f}, "
              f"{o_err:.2f} x EXACT_TOL")
