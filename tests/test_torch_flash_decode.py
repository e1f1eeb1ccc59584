"""Flash decode's split-KV kernel (bf16 queries over bf16 and int8 dense
caches): its launch plan, a CPU emulation of its order of operations held
to the plain version, and - on a CUDA card only - the kernel held to its
plain version at the shapes that stress the split (a ragged last split, a
split whose only visible key is its last, stale entries past pos, free
slots among live ones, one slot at 1024 keys, G 16 at D 64 and D 80, D
16, zamba2-2.7b's shared attention, gemma3-1b's window at D 256, int8
caches with the empty entries' scales poisoned), with its launch count,
its two kernels and without a device-to-host sync.

The plain versions are held to the JAX package in test_torch_dense.py.
Inputs are made with numpy from a seed.  Tolerances (each with its
reason, as in test_torch_kernels.py): over bf16 caches, whose
probabilities the kernel and the plain version both round to bf16 from
fp32 scores summed in other orders, ROUNDED_TOL on the plain version on
|v|; over int8 caches (fp32 probabilities) EXACT_TOL, summation order and
the final rounding to bf16 only; rows with no visible key (free slots)
EXACT_TOL's parts on the plain version on |v|.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode as pd
from repro_torch.kernels.flash_decode import (flash_decode_quant_ref,
                                              flash_decode_ref)
from repro_torch.kernels.quant import quantize_kv
from test_torch_kernels import EXACT_TOL, hold_rounded
from test_torch_paged_decode import _hold_dead, _np, _t, _widened

NEG_INF, MASKED = -1e30, -1e29  # the kernel's fill and masked threshold
LOG2E = 1.4426950408889634


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _dense_inputs(B, S, H, Hkv, D, seed, *, ctx=None, holes=0, stale=0,
                  free=(), parked=(), last_only=None):
    """q [B,H,D], fp32 caches [B,S,Hkv,D], cache_positions [B,S] and pos
    [B], as the engines leave a dense cache: slot b holds ``ctx[b]``
    entries (random if None; slot 0 the whole row), -1 past them and
    ``holes`` random empty entries inside, the query ``stale`` positions
    before the last entry (the entries past it are stale, as a rejected
    draft chain leaves them).  Slots in ``free`` are all -1 at pos 0 (no
    visible key), slots in ``parked`` sit at pos = S.  ``last_only`` = (b,
    k0, k1): keys k0 .. k1 - 2 of slot b are emptied, so the only visible
    key of that split is its last."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    kc = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    vc = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    if ctx is None:
        ctx = rng.integers(S // 4, S + 1, B)
        ctx[0] = S
    cpos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    pos = np.zeros(B, np.int32)
    for b, n in enumerate(ctx):
        cpos[b, n:] = -1
        if holes:
            cpos[b, rng.choice(n, size=min(holes, n - 1), replace=False)] = -1
        pos[b] = max(int(n) - 1 - stale, 0)
    if last_only is not None:
        b, k0, k1 = last_only
        cpos[b, k0:k1 - 1] = -1
        cpos[b, k1 - 1] = k1 - 1
        assert pos[b] >= k1 - 1
    for b in free:
        cpos[b], pos[b] = -1, 0
    for b in parked:
        pos[b] = S
    return q, kc, vc, cpos, pos


def _rows_with_keys(cpos, pos, window):
    """[B] slots that see at least one key (the others get the uniform
    average of their slot's value rows)."""
    ok = (cpos >= 0) & (cpos <= pos[:, None])
    if window:
        ok &= (pos[:, None] - cpos) < window
    return ok.any(1)


def _args(q, kc, vc, cpos, pos, cache, device="cpu"):
    """bf16 q and caches (or int8 caches with the empty entries' scales
    poisoned) in the order the wrapper takes them."""
    kb = _t(kc, torch.bfloat16, device)
    vb = _t(vc, torch.bfloat16, device)
    tail = [_t(cpos, None, device), _t(pos, None, device)]
    qb = _t(q, torch.bfloat16, device)
    if cache == "bf16":
        return [qb, kb, vb] + tail
    k8, ks = quantize_kv(kb)
    v8, vs = quantize_kv(vb)
    empty = _t(cpos < 0, None, device)
    ks[empty], vs[empty] = 1e6, 1e6  # read only for rows with no key
    return [qb, k8, v8, ks, vs] + tail


def _hold(out, args, cache, rows, window):
    """The kernel's (or its emulation's) output against the plain version:
    the rows that see a key, then the others."""
    kw = dict(window=window)
    if cache == "bf16":
        plain = flash_decode_ref
        hold_rounded(out, plain, args, kw, rows)
    else:
        plain = flash_decode_quant_ref
        want = _np(plain(*_widened(args), **kw))
        np.testing.assert_allclose(_np(out)[rows], want[rows],
                                   **EXACT_TOL["bfloat16"])
    _hold_dead(out, plain, args, ~rows, kw)
    assert bool(torch.isfinite(out.float()).all())


# ------------------------------------------------------------- the plan


# (B, G, Hkv, S, D, splits, split_keys): qwen2-0.5b's dense tick and
# draft, one slot, zamba2-2.7b's shared attention, gemma3-1b's local
# layers, then a ragged last split (1000 keys) and the tests' S 8192
PLAN_CASES = [
    (8, 7, 2, 1024, 64, 16, 64),
    (1, 7, 2, 1024, 64, 16, 64),
    (8, 1, 32, 1024, 80, 2, 512),
    (8, 4, 1, 1024, 256, 32, 32),
    (3, 7, 2, 1000, 64, 16, 64),
    (3, 8, 2, 8192, 64, 32, 256),
]


@pytest.mark.parametrize("B,G,Hkv,S,D,splits,split_keys", PLAN_CASES)
def test_flash_decode_plan_covers_every_key_once(B, G, Hkv, S, D, splits,
                                                 split_keys):
    """Every key of a row lies in exactly one split (the last may be
    ragged), splits are whole key tiles, the cut is the expected one, and
    the scratch holds every CTA's (m, l) and [G, D] partial."""
    p = fd.plan(B, G, Hkv, S, D)
    assert (p.splits, p.split_keys) == (splits, split_keys)
    assert p.split_keys % p.key_tile == 0 and p.key_tile == pd.key_tile(D)
    assert 1 <= p.splits <= pd.MAX_SPLITS
    covered = np.zeros(S, int)
    for s in range(p.splits):  # the kernel's split s
        k0, k1 = s * p.split_keys, min((s + 1) * p.split_keys, S)
        assert 0 <= k0 < k1 <= S
        assert k1 - k0 == p.split_keys or s == p.splits - 1
        covered[k0:k1] += 1
    assert (covered == 1).all()
    assert p.ctas == B * Hkv * p.splits
    assert p.ml_floats == 2 * p.ctas * G
    many = p.splits > 1
    assert p.partial_floats == (p.ctas * G * D if many else 0)
    assert p.counters == (B * Hkv if many else 0)


@pytest.mark.parametrize("B,G,Hkv,NB,bs,D", [
    (8, 7, 2, 64, 16, 64), (1, 7, 2, 128, 16, 64), (2, 4, 1, 65, 16, 256),
    (8, 1, 32, 64, 16, 80), (3, 16, 8, 33, 8, 128)])
def test_flash_decode_plan_is_paged_decode_plan(B, G, Hkv, NB, bs, D):
    """One split rule: a dense row of S keys is cut as a paged table of
    S = NB * bs keys is."""
    p, q = fd.plan(B, G, Hkv, NB * bs, D), pd.plan(B, G, Hkv, NB, bs, D)
    assert p == q


def test_flash_decode_uses_splits_for_serving_types():
    """bf16 q over bf16 or int8 caches takes the split passes; fp32 q, or
    fp32 caches, the two-walk kernel."""
    bf16, fp32, int8 = torch.bfloat16, torch.float32, torch.int8
    assert fd.uses_splits(bf16, bf16) and fd.uses_splits(bf16, int8)
    assert not fd.uses_splits(bf16, fp32)
    assert not any(fd.uses_splits(fp32, c) for c in (bf16, int8, fp32))


# ------------------------------------- the kernel's order, on the CPU


def _flash_decode_emulation(q, k_cache, v_cache, cache_positions, pos, *,
                            window=0, scales=None):
    """The bf16-q instantiation of ``csrc/flash_decode.cu`` in its own
    order, on the CPU.  Scores: exact bf16 products with fp32 sums (times
    the key's scale for int8 caches), in exp2 units, masked by
    cache_positions.  Per split of ``plan(...).split_keys`` keys: each
    head's max m_i and sum l_i of exp2(s - m_i), online over the split's
    key tiles (pass 1); merged in split order, splits with l_i = 0
    skipped; p = exp2(s - m) / l rounded to bf16 (bf16 caches) or times
    v_scale in fp32 (int8 caches); a slot with no visible key p = 1/S on
    every key of its row; the [G, D] partials summed in split order (pass
    2's last CTA) and rounded to bf16."""
    B, H, D = q.shape
    _, S, Hkv, _ = k_cache.shape
    G = H // Hkv
    p = fd.plan(B, G, Hkv, S, D)
    SK, NS, KT = p.split_keys, p.splits, p.key_tile
    pad = NS * SK - S
    K, V = k_cache.float(), v_cache.float()
    s = torch.einsum("bkgd,bskd->bkgs", q.float().reshape(B, Hkv, G, D), K)
    if scales is not None:
        s = s * scales[0].permute(0, 2, 1)[:, :, None, :]
    s = s * torch.tensor(D ** -0.5 * LOG2E, dtype=torch.float32)
    c, pp = cache_positions.long(), pos[:, None].long()
    vis = (c >= 0) & (c <= pp)
    if window:
        vis &= (pp - c) < window
    x = torch.where(vis[:, None, None], s, torch.tensor(NEG_INF))
    zero, one = torch.zeros(()), torch.ones(())
    xs = F.pad(x, (0, pad), value=NEG_INF).reshape(B, Hkv, G, NS, SK)
    ms = torch.full((B, Hkv, G, NS), NEG_INF)
    ls = torch.zeros((B, Hkv, G, NS))
    for j in range(SK // KT):  # pass 1: online over a split's key tiles
        xt = xs[..., j * KT:(j + 1) * KT]
        m_new = torch.maximum(ms, xt.amax(-1))
        corr = torch.where(ms > MASKED, torch.exp2(ms - m_new), one)
        e = torch.where(xt > MASKED, torch.exp2(xt - m_new[..., None]), zero)
        ls = ls * corr + e.sum(-1)
        ms = m_new
    m = torch.full((B, Hkv, G), NEG_INF)
    l = torch.zeros((B, Hkv, G))
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
    if scales is None:
        prob = prob.bfloat16().float()
        uniform = uniform.bfloat16().float()
    prob = torch.where(dead[..., None, None],
                       torch.where(inside, uniform, zero), prob)
    if scales is not None:
        vs = F.pad(scales[1], (0, 0, 0, pad))
        prob = prob * vs.permute(0, 2, 1).reshape(B, Hkv, 1, NS, SK)
    Vs = F.pad(V, (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3).reshape(
        B, Hkv, 1, NS, SK, D)
    part = (prob[..., None, :] @ Vs)[..., 0, :]  # [B, Hkv, G, NS, D]
    out = torch.zeros((B, Hkv, G, D))
    for t in range(NS):  # the partials, in split order
        out = out + part[..., t, :]
    return out.reshape(B, H, D).to(q.dtype)


# (B, S, H, Hkv, D, window, inputs): qwen2-0.5b's heads over a ragged last
# split with holes inside the splits and stale entries past pos, the
# serving shape with a free slot and a parked one, gemma3-1b's window at D
# 256 (and a free slot), G 16 at D 80, D 16 with a free slot
EMULATION_CASES = [
    (3, 1000, 14, 2, 64, 0, dict(holes=40, stale=3)),
    (8, 1024, 14, 2, 64, 0, dict(holes=8, stale=2, free=(6,),
                                 parked=(7,))),
    (3, 1024, 4, 1, 256, 512, dict(holes=30, stale=1, free=(1,))),
    (2, 300, 16, 1, 80, 0, dict(holes=5, stale=3)),
    (4, 144, 4, 2, 16, 0, dict(holes=4, stale=2, free=(1, 3))),
]


@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("B,S,H,Hkv,D,window,kw", EMULATION_CASES)
def test_flash_decode_split_order_within_tolerance(B, S, H, Hkv, D, window,
                                                   kw, cache):
    """The kernel's order (per-split m and l merged in split order, p
    rounded with the merged m and l, partials summed in split order),
    emulated on the CPU, against the plain version on the values widened
    to fp32: ROUNDED_TOL on |v| over bf16 caches, EXACT_TOL over int8
    caches (whose p stays fp32, the poisoned scales of empty entries read
    only by rows with no key); free slots as on the card."""
    q, kc, vc, cpos, pos = _dense_inputs(B, S, H, Hkv, D, seed=5, **kw)
    args = _args(q, kc, vc, cpos, pos, cache)
    rows = _rows_with_keys(cpos, pos, window)
    free = list(kw.get("free", ()))
    assert not rows[free].any() and rows.any()
    if kw.get("stale"):  # the entries past pos are there, and masked
        assert ((cpos > pos[:, None]) & (cpos >= 0)).any()
    if cache == "bf16":
        got = _flash_decode_emulation(*args, window=window)
    else:
        got = _flash_decode_emulation(*args[:3], *args[5:],
                                      scales=(args[3], args[4]),
                                      window=window)
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, D)
    _hold(got, args, cache, rows, window)


# -------------------------------------------- CUDA kernel vs plain (card)


# (B, S, H, Hkv, D, window, inputs)
GPU_SPLIT_CASES = {
    "ragged last split": (3, 1000, 14, 2, 64, 0, dict(holes=20, stale=1)),
    "split whose only key is its last": (
        2, 1024, 14, 2, 64, 0, dict(ctx=[1024, 700],
                                    last_only=(0, 128, 192))),
    "stale entries past pos": (4, 1024, 14, 2, 64, 0, dict(stale=9)),
    "free slots among live": (8, 1024, 14, 2, 64, 0,
                              dict(holes=8, stale=2, free=(2, 6, 7))),
    "B 1 at 1024 keys": (1, 1024, 14, 2, 64, 0, dict(ctx=[1000])),
    "G 16 at D 64": (2, 1024, 16, 1, 64, 0, dict(holes=8, stale=1)),
    "G 16 at D 80": (2, 1024, 16, 1, 80, 0, dict(holes=8, stale=1)),
    "D 16": (3, 144, 4, 2, 16, 0, dict(holes=4, stale=2, free=(2,))),
    "zamba2 shared attention": (8, 1024, 32, 32, 80, 0,
                                dict(stale=1, parked=(7,))),
    "gemma3-1b window": (8, 1024, 4, 1, 256, 512,
                         dict(holes=16, stale=1, free=(5,))),
}


@pytest.mark.gpu
@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("case", list(GPU_SPLIT_CASES))
def test_flash_decode_split_kernel_matches_plain(cuda, case, cache):
    """The bf16-q kernel against its plain version (int8 caches with the
    empty entries' scales poisoned); one count a call on its wrapper; no
    device-to-host sync on the call (the wrapper never reads pos or
    cache_positions on the host)."""
    B, S, H, Hkv, D, window, kw = GPU_SPLIT_CASES[case]
    q, kc, vc, cpos, pos = _dense_inputs(B, S, H, Hkv, D, seed=21, **kw)
    args = _args(q, kc, vc, cpos, pos, cache, cuda)
    fn = ops.flash_decode if cache == "bf16" else ops.flash_decode_quant
    before = fn.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn(*args, window=window)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == (B, H, D)
    rows = _rows_with_keys(cpos, pos, window)
    assert not rows[list(kw.get("free", ()))].any()
    _hold(out, [a.cpu() for a in args], cache, rows, window)


@pytest.mark.gpu
def test_flash_decode_split_call_is_two_kernels(cuda):
    """A bf16-q call launches the two split passes and nothing else (the
    scratch comes from ``torch.empty``; no copy, no host read)."""
    q, kc, vc, cpos, pos = _dense_inputs(8, 1024, 14, 2, 64, seed=3,
                                         holes=8, stale=1)
    args = _args(q, kc, vc, cpos, pos, "bf16", cuda)
    ops.flash_decode(*args)
    torch.cuda.synchronize()
    kernels = []
    for _ in range(3):  # a profiling session now and then records nothing
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        with prof:
            for _ in range(4):
                ops.flash_decode(*args)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    assert kernels and len(kernels) <= 8
    assert all("decode_split" in e.name and "DenseKeys" in e.name
               for e in kernels), {e.name for e in kernels}


@pytest.mark.gpu
def test_flash_decode_bf16_rejects_what_it_cannot_take(cuda):
    """bf16 queries raise on what the split kernel cannot take, before any
    launch."""
    def args(H, D, cache_dtype=torch.bfloat16):
        q, kc, vc, cpos, pos = _dense_inputs(2, 64, H, 2, D, seed=0)
        return [_t(q, torch.bfloat16, cuda), _t(kc, cache_dtype, cuda),
                _t(vc, cache_dtype, cuda), _t(cpos, None, cuda),
                _t(pos, None, cuda)]
    before = ops.flash_decode.launches
    with pytest.raises(ValueError):  # head dim 48 is not supported
        ops.flash_decode(*args(8, 48))
    with pytest.raises(ValueError):  # G = 17 query heads per kv head
        ops.flash_decode(*args(34, 64))
    with pytest.raises(ValueError):  # int8 caches need the quant wrapper
        ops.flash_decode(*args(8, 64, torch.int8))
    assert ops.flash_decode.launches == before


@pytest.mark.gpu
def test_flash_decode_variant(cuda):
    """bf16 q over bf16 and int8 caches takes the split kernel; fp32 q, or
    an fp32 cache, the two-walk one."""
    bf16, fp32, int8 = torch.bfloat16, torch.float32, torch.int8
    assert "split-KV" in fd.variant(bf16, bf16)
    assert "split-KV" in fd.variant(bf16, int8)
    assert "two walks" in fd.variant(bf16, fp32)
    assert "two walks" in fd.variant(fp32, bf16)
