"""Paged decode's split-KV kernel (bf16 queries): its launch plan, a CPU
emulation of its order of operations held to the plain version, and — on
a CUDA card only — the kernel held to its plain version at the shapes
that stress the split (a ragged last split, gemma3-1b's window at D 256,
free slots among live ones, one slot at 1024 keys, G 16, D 16, pos 0),
with its launch count and without a device-to-host sync.

The plain versions are held to the JAX package in test_torch_kernels.py.
Inputs are made with numpy from a seed.  Tolerances (each with its
reason, as in test_torch_kernels.py): over bf16 pages, whose
probabilities the kernel and the plain version both round to bf16 from
fp32 scores summed in other orders, ROUNDED_TOL on the plain version on
|v|; over int8 pages (fp32 probabilities) EXACT_TOL, summation order and
the final rounding to bf16 only; rows with no visible key (free slots)
EXACT_TOL's parts on the plain version on |v|.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode as pd
from repro_torch.kernels import paged_verify as pv
from repro_torch.kernels.paged_decode import (paged_decode_quant_ref,
                                              paged_decode_ref)
from repro_torch.kernels.quant import quantize_kv
from test_torch_kernels import EXACT_TOL, hold_rounded

NEG_INF, MASKED = -1e30, -1e29  # the kernel's fill and masked threshold
LOG2E = 1.4426950408889634


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


def _decode_inputs(B, H, Hkv, D, bs, NB, seed, *, free=(), pos0=()):
    """q [B,H,D], fp32 pools, block tables with -1 tails, positions: slot
    0 sees the whole table (its last split), the others random contexts;
    slots in ``free`` get an all -1 row and position 0, slots in ``pos0``
    one page and position 0 (one visible key)."""
    rng = np.random.default_rng(seed)
    P = 1 + B * NB
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    kp = rng.normal(size=(P, bs, Hkv, D)).astype(np.float32)
    vp = rng.normal(size=(P, bs, Hkv, D)).astype(np.float32)
    ctx = rng.integers(1, NB * bs + 1, B)
    ctx[0] = NB * bs
    ctx[list(pos0)] = 1
    bt = np.full((B, NB), -1, np.int32)
    perm = rng.permutation(np.arange(1, P))
    used = 0
    for b in range(B):
        if b in free:
            continue
        nb = -(-int(ctx[b]) // bs)
        bt[b, :nb] = perm[used:used + nb]
        used += nb
    pos = np.where(np.isin(np.arange(B), free), 0, ctx - 1).astype(np.int32)
    return q, kp, vp, bt, pos


def _rows_with_keys(pos, bt, bs, window):
    """[B] slots that see at least one key (the others get the uniform
    average of the value rows their table addresses)."""
    ok = []
    for b, p in enumerate(pos):
        keys = [j * bs + t for j in range(bt.shape[1]) if bt[b, j] >= 0
                for t in range(bs)]
        ok.append(any(k <= p and (not window or p - k < window)
                      for k in keys))
    return np.asarray(ok)


def _hold_dead(out, plain, args, dead, kw):
    """Rows with no visible key against the plain version's uniform
    softmax, summed by the kernel in another order: EXACT_TOL's parts on
    the plain version on |v| (args[2])."""
    if not dead.any():
        return
    want = _np(plain(*args, **kw))[dead]
    absargs = list(args)
    absargs[2] = args[2].abs()
    scale = _np(plain(*absargs, **kw))[dead]
    tol = EXACT_TOL["bfloat16"]
    err = np.abs(_np(out)[dead] - want)
    assert bool((err <= tol["atol"] + tol["rtol"] * scale).all()), \
        float(err.max())


def _widened(args):
    return [t.float() if t.is_floating_point() else t for t in args]


def _args(q, kp, vp, bt, pos, pages, device="cpu"):
    """bf16 q and pages (or int8 pages with the null page's scales
    poisoned) in the order the wrapper takes them."""
    kb = _t(kp, torch.bfloat16, device)
    vb = _t(vp, torch.bfloat16, device)
    tail = [_t(bt, None, device), _t(pos, None, device)]
    if pages == "bf16":
        return [_t(q, torch.bfloat16, device), kb, vb] + tail
    k8, ks = quantize_kv(kb)
    v8, vs = quantize_kv(vb)
    ks[0], vs[0] = 1e6, 1e6  # garbage scales that must never be read
    return [_t(q, torch.bfloat16, device), k8, v8, ks, vs] + tail


def _hold(out, args, pages, rows, window):
    """The kernel's (or its emulation's) output against the plain version:
    the rows that see a key, then the free ones."""
    kw = dict(window=window)
    if pages == "bf16":
        plain = paged_decode_ref
        hold_rounded(out, plain, args, kw, rows)
    else:
        plain = paged_decode_quant_ref
        want = _np(plain(*_widened(args), **kw))
        np.testing.assert_allclose(_np(out)[rows], want[rows],
                                   **EXACT_TOL["bfloat16"])
    _hold_dead(out, plain, args, ~rows, kw)
    assert bool(torch.isfinite(out.float()).all())


# ------------------------------------------------------------- the plan


@pytest.mark.parametrize("B,G,Hkv,NB,bs,D", [
    (8, 7, 2, 64, 16, 64),      # the decode shape (qwen2-0.5b)
    (1, 7, 2, 64, 16, 64),      # one slot, 1024 keys
    (1, 7, 2, 128, 16, 64),     # one slot, 2048 keys: 32 splits
    (3, 7, 2, 65, 16, 64),      # 1040 keys: the last split ragged
    (2, 4, 1, 65, 16, 256),     # gemma3-1b heads, 32-key tiles, ragged
    (4, 16, 1, 8, 16, 16),      # G 16, D 16
    (1, 1, 1, 1, 16, 32),       # one page
    (64, 16, 8, 256, 16, 128),  # many pairs: one split
])
def test_decode_plan_covers_every_key_once(B, G, Hkv, NB, bs, D):
    """Every key of the table lies in exactly one split (the last may be
    ragged), splits are whole key tiles, and the scratch holds every
    CTA's (m, l) and [G, D] partial."""
    p = pd.plan(B, G, Hkv, NB, bs, D)
    S = NB * bs
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


def test_decode_plan_fills_the_card():
    """B 8, Hkv 2, 1024-key tables: 16 splits of 64 keys, 256 CTAs (16
    before the split) on the 132 SMs."""
    p = pd.plan(8, 7, 2, 64, 16, 64)
    assert (p.splits, p.split_keys, p.ctas) == (16, 64, 256)
    assert p.ctas >= 128


def test_decode_plan_caps_splits_at_b1():
    """One slot: splits are capped at MAX_SPLITS (32) and are whole 64-key
    tiles, so a 1024-key table takes 16 and longer tables 32."""
    assert pd.plan(1, 7, 2, 64, 16, 64).splits == 16
    assert pd.plan(1, 7, 2, 128, 16, 64).splits == pd.MAX_SPLITS == 32
    p = pd.plan(1, 7, 2, 512, 16, 64)
    assert (p.splits, p.split_keys) == (32, 256)


@pytest.mark.parametrize("B,G,Hkv,NB,bs,D", [
    (8, 7, 2, 64, 16, 64), (1, 7, 2, 128, 16, 64), (2, 4, 1, 65, 16, 256),
    (3, 16, 8, 33, 8, 128)])
def test_decode_plan_is_verify_plan_at_t1(B, G, Hkv, NB, bs, D):
    """One split rule: a decode step cuts its keys as a verify call with
    T = 1 does."""
    p, v = pd.plan(B, G, Hkv, NB, bs, D), pv.plan(B, 1, G, Hkv, NB, bs, D)
    assert (p.split_keys, p.splits, p.ctas) == (v.split_keys, v.splits,
                                                v.ctas)


# ------------------------------------- the kernel's order, on the CPU


def _decode_emulation(q, k_pages, v_pages, block_tables, pos, *, window=0,
                      scales=None):
    """The bf16-q instantiation of ``csrc/paged_decode.cu`` in its own
    order, on the CPU.  Scores: exact bf16 products with fp32 sums (times
    the key's scale for int8 pages), in exp2 units, masked.  Per split of
    ``plan(...).split_keys`` keys: each head's max m_i and sum l_i of
    exp2(s - m_i), online over the split's key tiles (pass 1); merged in
    split order, splits with l_i = 0 skipped; p = exp2(s - m) / l rounded
    to bf16 (bf16 pages) or times v_scale in fp32 (int8 pages); a slot
    with no visible key p = 1/(NB*bs) on every key of the table; the
    [G, D] partials summed in split order (pass 2's last CTA) and rounded
    to bf16."""
    B, H, D = q.shape
    _, bs, Hkv, _ = k_pages.shape
    NB = block_tables.shape[1]
    G, S = H // Hkv, NB * bs
    p = pd.plan(B, G, Hkv, NB, bs, D)
    SK, NS, KT = p.split_keys, p.splits, p.key_tile
    pad = NS * SK - S
    idx = block_tables.long().clamp(min=0)  # -1: the null page 0
    K = k_pages[idx].reshape(B, S, Hkv, D).float()
    V = v_pages[idx].reshape(B, S, Hkv, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", q.float().reshape(B, Hkv, G, D), K)
    if scales is not None:
        ks = scales[0][idx].reshape(B, S, Hkv).permute(0, 2, 1)
        s = s * ks[:, :, None, :]
    s = s * torch.tensor(D ** -0.5 * LOG2E, dtype=torch.float32)
    alloc = (block_tables >= 0)[:, :, None].expand(B, NB, bs).reshape(B, S)
    kpos = torch.arange(S)
    vis = alloc & (kpos[None] <= pos[:, None].long())
    if window:
        vis &= (pos[:, None].long() - kpos[None]) < window
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
        vs = F.pad(scales[1][idx].reshape(B, S, Hkv), (0, 0, 0, pad))
        prob = prob * vs.permute(0, 2, 1).reshape(B, Hkv, 1, NS, SK)
    Vs = F.pad(V, (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3).reshape(
        B, Hkv, 1, NS, SK, D)
    part = (prob[..., None, :] @ Vs)[..., 0, :]  # [B, Hkv, G, NS, D]
    out = torch.zeros((B, Hkv, G, D))
    for t in range(NS):  # the partials, in split order
        out = out + part[..., t, :]
    return out.reshape(B, H, D).to(q.dtype)


# (B, H, Hkv, D, bs, NB, window, free slots): qwen2-0.5b heads over a
# ragged last split, the sweeps of test_torch_kernels.py, gemma3-1b's
# window at D 256, G 16 at D 16; each with free slots among live ones
EMULATION_CASES = [
    (3, 14, 2, 64, 16, 65, 0, (1,)),
    (2, 8, 2, 64, 16, 5, 0, (1,)),
    (3, 4, 4, 32, 8, 5, 24, (2,)),
    (3, 4, 1, 256, 16, 40, 300, (1,)),
    (4, 16, 1, 16, 16, 8, 0, (1, 3)),
    (8, 14, 2, 64, 16, 64, 0, (6, 7)),
]


@pytest.mark.parametrize("pages", ["bf16", "int8"])
@pytest.mark.parametrize("B,H,Hkv,D,bs,NB,window,free", EMULATION_CASES)
def test_decode_split_order_within_tolerance(B, H, Hkv, D, bs, NB, window,
                                             free, pages):
    """The kernel's order (per-split m and l merged in split order, p
    rounded with the merged m and l, partials summed in split order),
    emulated on the CPU, against the plain version on the values widened
    to fp32: ROUNDED_TOL on |v| over bf16 pages, EXACT_TOL over int8
    pages (whose p stays fp32); free slots as on the card."""
    q, kp, vp, bt, pos = _decode_inputs(B, H, Hkv, D, bs, NB, seed=5,
                                        free=free)
    args = _args(q, kp, vp, bt, pos, pages)
    rows = _rows_with_keys(pos, bt, bs, window)
    assert not rows[list(free)].any() and rows.any()
    if pages == "bf16":
        got = _decode_emulation(*args, window=window)
    else:
        got = _decode_emulation(*args[:3], *args[5:],
                                scales=(args[3], args[4]), window=window)
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, D)
    _hold(got, args, pages, rows, window)


# -------------------------------------------- CUDA kernel vs plain (card)


# (B, H, Hkv, D, bs, NB, window, free slots, slots at pos 0)
GPU_SPLIT_CASES = {
    "ragged last split": (3, 14, 2, 64, 16, 65, 0, (), ()),
    "gemma3-1b window": (8, 4, 1, 256, 16, 64, 512, (5,), ()),
    "free slots among live": (8, 14, 2, 64, 16, 64, 0, (2, 6, 7), ()),
    "B 1 at 1024 keys": (1, 14, 2, 64, 16, 64, 0, (), ()),
    "G 16": (2, 16, 1, 64, 16, 64, 0, (), ()),
    "D 16": (3, 4, 2, 16, 16, 9, 0, (2,), ()),
    "pos 0": (4, 14, 2, 64, 16, 64, 0, (), (1, 2)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("pages", ["bf16", "int8"])
@pytest.mark.parametrize("case", list(GPU_SPLIT_CASES))
def test_paged_decode_split_kernel_matches_plain(cuda, case, pages):
    """The bf16-q kernel against its plain version; one count a call on
    its wrapper; no device-to-host sync on the call (the wrapper never
    reads pos or the tables on the host)."""
    B, H, Hkv, D, bs, NB, window, free, pos0 = GPU_SPLIT_CASES[case]
    q, kp, vp, bt, pos = _decode_inputs(B, H, Hkv, D, bs, NB, seed=21,
                                        free=free, pos0=pos0)
    args = _args(q, kp, vp, bt, pos, pages, cuda)
    fn = ops.paged_decode if pages == "bf16" else ops.paged_decode_quant
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
    rows = _rows_with_keys(pos, bt, bs, window)
    assert not rows[list(free)].any() and rows[list(pos0)].all()
    _hold(out, [a.cpu() for a in args], pages, rows, window)


@pytest.mark.gpu
def test_paged_decode_variant(cuda):
    """bf16 queries take the split kernel, fp32 queries the two-walk one."""
    bf16, fp32 = pd.variant(torch.bfloat16), pd.variant(torch.float32)
    assert "split-KV" in bf16 and "two walks" in fp32
