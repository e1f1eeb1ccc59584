"""The bf16 flash-attention backward's arithmetic on the CPU, and its split
plan.

``csrc/flash_attention_bwd.cu`` runs bf16 on the tensor cores, which this
host does not have, so ``_tc_emulation`` repeats the kernel's arithmetic
here in its own tiles and order: Dv = rowsum(do * o) in fp32; s = q k^T and
dp = do v^T as sums of 16-deep blocks of exact bf16 products in fp32; p =
exp2(s scale log2(e) - lse log2(e)) on visible pairs, ds = p (dp - Dv)
scale; dv = p^T do, dk = ds^T q (key tiles of 64, walking their split's
share of the (query head, query tile) walk, the splits' fp32 partials
summed in split order) and dq = ds k (query tiles of 64, key tiles in
order), each fp32 p and ds split into bf16 hi + lo and both put through
the product, 16 rows or keys at a time, hi first; dq, dk and dv rounded
once to bf16.  Inputs are made with numpy from a seed.

Tolerances, each with its reason:
* the emulation against ``flash_attention_bwd_ref`` on the same bf16
  inputs: ``BWD_TOL``, 2^-7 of each output's largest magnitude (one bf16
  rounding of each output, from fp32 sums that differ in their order and
  in the 2^-16 that hi + lo leaves of p and ds), the bound the card's
  kernel is held to in ``chip_smoke.py`` and the gpu tests;
* the emulation against ``jax.vjp`` of the JAX package's flash attention
  (``repro/models/attention.py``: the custom_vjp ``_flash_bwd`` where a
  mask is causal or windowed, XLA's autodiff of its key scan where not) on
  the same values in fp32: the same 2^-7, the JAX side unrounded.
"""
import functools

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from repro.models import attention as jattn
except ImportError:  # JAX (the reference) is not installed
    jax = None

from repro_torch.kernels import flash_attention as fa


@pytest.fixture
def need_jax():
    """JAX, with the reference computed on the CPU on any host."""
    if jax is None:
        pytest.skip("JAX (the reference package) is not installed here")
    with jax.default_device(jax.devices("cpu")[0]):
        yield


BWD_TOL = 2.0 ** -7
LOG2E = 1.4426950408889634

# (B, Sq, Sk, H, Hkv, D, causal, window, q_offset): causal GQA at two
# query tiles (split 4 ways), a window, a suffix at q_offset, a ragged D 80
# tile, non-causal Sq != Sk (whisper's cross-attention), the key pass's
# 32-row steps at D 128 with a window
CASES = [(2, 96, 96, 4, 2, 64, True, 0, None),
         (1, 70, 70, 4, 1, 16, True, 24, None),
         (2, 40, 96, 4, 2, 32, True, 0, 50),
         (1, 37, 37, 2, 2, 80, True, 0, None),
         (2, 21, 77, 4, 4, 16, False, 0, None),
         (1, 50, 90, 4, 2, 80, False, 0, None),
         (1, 72, 72, 2, 1, 128, True, 40, None)]


def _inputs(B, Sq, Sk, H, Hkv, D, seed):
    """q, k, v, do as numpy fp32 holding bf16 values."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            .bfloat16().float().numpy()
            for s in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D),
                      (B, Sq, H, D))]


def _hi_lo(x, hi_lo=True):
    """x as bf16 hi + lo (the kernel), or one bf16 rounding (``hi_lo``
    False: what the kernel does not do)."""
    hi = x.bfloat16().float()
    return (hi, (x - hi).bfloat16().float()) if hi_lo else (hi,)


def _blocks16(a, b):
    """a [..., m, D] . b [..., n, D]^T as a sum of 16-deep blocks in fp32,
    in block order (the mma's k steps)."""
    out = torch.zeros(*a.shape[:-1], b.shape[-2])
    for d0 in range(0, a.shape[-1], 16):
        out = out + a[..., d0:d0 + 16] @ b[..., d0:d0 + 16].transpose(-1, -2)
    return out


def _live(qpos, kpos, Sk, causal, window):
    """Visible (row, key) pairs: positions [r], keys [c] -> [r, c]."""
    live = (kpos[None, :] < Sk).repeat(len(qpos), 1)
    if causal:
        live &= kpos[None, :] <= qpos[:, None]
    if window:
        live &= (qpos[:, None] - kpos[None, :]) < window
    return live


def _tc_emulation(q, k, v, o, lse, do, *, causal, window, q_offset, splits,
                  hi_lo=True, out=torch.bfloat16):
    """The tensor-core kernels' arithmetic (bf16 q, k, v, do; o; fp32 lse
    [B, H, Sq]) -> dq, dk, dv in ``out`` (the kernel: bf16)."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    q_offset = fa._offset(q, k, causal, q_offset)
    KN, KM = fa.BWD_KEYS, fa.bwd_rows(D)
    QM, QN = 64, 32 if D > 128 else 64
    f32 = torch.float32
    scale = torch.tensor(D ** -0.5, dtype=f32)
    scale_log2 = scale * torch.tensor(LOG2E, dtype=f32)
    # [B, Hkv, G, S, D] and [B, Hkv, S, D]
    qg = q.float().reshape(B, Sq, Hkv, G, D).permute(0, 2, 3, 1, 4)
    dog = do.float().reshape(B, Sq, Hkv, G, D).permute(0, 2, 3, 1, 4)
    kh, vh = (t.float().permute(0, 2, 1, 3) for t in (k, v))
    dvec = (do.float() * o.float()).sum(-1)                  # [B, Sq, H]
    dvec = dvec.reshape(B, Sq, Hkv, G).permute(0, 2, 3, 1)   # [B, Hkv, G, Sq]
    lse2 = lse.reshape(B, Hkv, G, Sq) * torch.tensor(LOG2E, dtype=f32)

    def p_ds(s, dp, live, l2, dv_rows):
        """p and ds from the scores s and dp [..., rows, keys], the rows'
        lse (log2 units) and Dv [..., rows]."""
        p = torch.where(live, torch.exp2(s * scale_log2 - l2[..., None]),
                        0.0)
        return p, p * (dp - dv_rows[..., None]) * scale

    # pass 2: key tiles, each split's share of the (head, query tile) walk
    dk = torch.zeros(B, Hkv, Sk, D)
    dv = torch.zeros(B, Hkv, Sk, D)
    for k0 in range(0, Sk, KN):
        keys = torch.arange(k0, min(Sk, k0 + KN))
        i_lo = max(0, k0 - q_offset) if causal else 0
        i_hi = Sq - 1
        if window:
            i_hi = min(i_hi, k0 + len(keys) - 1 + window - 1 - q_offset)
        nt = 0 if i_hi < i_lo else i_hi // KM - i_lo // KM + 1
        n = G * nt
        per = -(-n // splits)
        parts = []
        for split in range(splits):
            ak = torch.zeros(B, Hkv, len(keys), D)
            av = torch.zeros(B, Hkv, len(keys), D)
            for u in range(min(n, split * per), min(n, split * per + per)):
                g, i0 = u // nt, (i_lo // KM + u % nt) * KM
                rows = torch.arange(i0, min(Sq, i0 + KM))
                live = _live(q_offset + rows, keys, Sk, causal, window)
                qt, ot = qg[:, :, g, rows], dog[:, :, g, rows]
                s = _blocks16(qt, kh[:, :, keys])
                dp = _blocks16(ot, vh[:, :, keys])
                p, ds = p_ds(s, dp, live, lse2[:, :, g, rows],
                             dvec[:, :, g, rows])
                for r0 in range(0, len(rows), 16):
                    sl = slice(r0, r0 + 16)
                    for part in _hi_lo(p[..., sl, :].transpose(-1, -2),
                                       hi_lo):
                        av = av + part @ ot[:, :, sl]
                    for part in _hi_lo(ds[..., sl, :].transpose(-1, -2),
                                       hi_lo):
                        ak = ak + part @ qt[:, :, sl]
            parts.append((ak, av))
        ak, av = parts[0]
        for pk, pv in parts[1:]:
            ak, av = ak + pk, av + pv
        dk[:, :, keys], dv[:, :, keys] = ak, av

    # pass 3: query tiles, the visible key tiles in order
    dq = torch.zeros(B, Hkv, G, Sq, D)
    for i0 in range(0, Sq, QM):
        rows = torch.arange(i0, min(Sq, i0 + QM))
        q_lo, q_hi = q_offset + i0, q_offset + rows[-1].item()
        j_hi = -(-Sk // QN) - 1
        if causal:
            j_hi = -1 if q_hi < 0 else min(j_hi, q_hi // QN)
        j_lo = (q_lo - window + 1) // QN if window and q_lo - window + 1 > 0 \
            else 0
        acc = torch.zeros(B, Hkv, G, len(rows), D)
        for j in range(j_lo, j_hi + 1):
            keys = torch.arange(j * QN, min(Sk, j * QN + QN))
            live = _live(q_offset + rows, keys, Sk, causal, window)
            kt = kh[:, :, keys][:, :, None]
            s = _blocks16(qg[:, :, :, rows], kt)
            dp = _blocks16(dog[:, :, :, rows], vh[:, :, keys][:, :, None])
            _, ds = p_ds(s, dp, live, lse2[:, :, :, rows],
                         dvec[:, :, :, rows])
            for c0 in range(0, len(keys), 16):
                for part in _hi_lo(ds[..., c0:c0 + 16], hi_lo):
                    acc = acc + part @ kt[..., c0:c0 + 16, :]
        dq[:, :, :, rows] = acc
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)
    return (dq.to(out), dk.permute(0, 2, 1, 3).to(out),
            dv.permute(0, 2, 1, 3).to(out))


@functools.lru_cache(maxsize=None)
def _emulated(case):
    """(inputs, emulation with the plan's splits, plain backward)."""
    B, Sq, Sk, H, Hkv, D, causal, window, q_offset = case
    arrays = _inputs(B, Sq, Sk, H, Hkv, D, seed=Sq + D)
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in arrays)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = fa.flash_attention_ref(q, k, v, return_lse=True, **kw)
    splits = fa.bwd_plan(B, Sq, Sk, H, Hkv, D)
    got = _tc_emulation(q, k, v, o, lse, do, splits=splits, **kw)
    want = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    return arrays, splits, got, want


def _frac(got, want) -> float:
    got, want = got.double(), torch.as_tensor(np.array(want)).double()
    return float((got - want).abs().max() / want.abs().max().clamp(1e-30))


@pytest.mark.parametrize("case", CASES)
def test_emulation_matches_plain_backward(case):
    """The kernel's tile order, splits and hi + lo products hold dq, dk
    and dv to the plain backward on the same bf16 inputs."""
    _, splits, got, want = _emulated(case)
    for name, a, w in zip("qkv", got, want):
        assert a.dtype == w.dtype == torch.bfloat16
        assert _frac(a, w.float()) <= BWD_TOL, ("d" + name, splits)


@pytest.mark.parametrize("case", CASES)
def test_emulation_matches_jax_vjp(need_jax, case):
    """The emulation against ``jax.vjp`` of the JAX package's flash
    attention on the same values (its chunks of 32 cut the ragged
    edges)."""
    B, Sq, Sk, H, Hkv, D, causal, window, q_offset = case
    (q, k, v, do), _, got, _ = _emulated(case)

    def jf(q_, k_, v_):
        return jattn.flash_attention(q_, k_, v_, causal=causal,
                                     window=window, q_offset=q_offset,
                                     chunk_q=32, chunk_k=32)

    _, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (q, k, v)))
    for name, a, w in zip("qkv", got, vjp(jnp.asarray(do))):
        assert _frac(a, w) <= BWD_TOL, "d" + name


def test_split_order_is_the_kernels():
    """Splitting the key pass changes only the order of dk's and dv's fp32
    sums: one split and the plan's (4) both hold to the plain backward,
    dq is the same bits."""
    case = CASES[0]
    B, Sq, Sk, H, Hkv, D, causal, window, q_offset = case
    arrays, splits, got, want = _emulated(case)
    assert splits == 4
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in arrays)
    o, lse = fa.flash_attention_ref(q, k, v, return_lse=True)
    one = _tc_emulation(q, k, v, o, lse, do, causal=True, window=0,
                        q_offset=None, splits=1)
    assert torch.equal(one[0], got[0])
    for a, w in zip(one, want):
        assert _frac(a, w.float()) <= BWD_TOL


# (label, B, S, H, Hkv, D): the training shapes of phase 11 and gemma3-1b
TRAIN_SHAPES = [("gemma3-1b, B 2", 2, 1024, 4, 1, 256),
                ("gemma3-1b, B 1", 1, 1024, 4, 1, 256),
                ("qwen2-0.5b, B 8", 8, 1024, 14, 2, 64),
                ("whisper-large-v3 encoder, B 4", 4, 1500, 20, 20, 64),
                ("whisper-large-v3 decoder, B 4", 4, 448, 20, 20, 64),
                ("zamba2-2.7b shared block, B 4", 4, 1024, 32, 32, 80)]


@pytest.mark.parametrize("shape", TRAIN_SHAPES, ids=lambda s: s[0])
def test_bwd_plan_fills_the_sms(shape):
    """The key pass's CTAs (key tiles x Hkv x B x splits) fill at least
    120 of the card's 132 SMs at every training shape, and a split grid
    stays within them."""
    _, B, S, H, Hkv, D = shape
    splits = fa.bwd_plan(B, S, S, H, Hkv, D)
    ctas = -(-S // fa.BWD_KEYS) * Hkv * B * splits
    assert ctas >= 120
    assert splits == 1 or ctas <= fa.SMS
    walk = (H // Hkv) * -(-S // fa.bwd_rows(D))
    assert 1 <= splits <= min(walk, fa.MAX_BWD_SPLITS)


def test_bwd_plan_one_split_where_the_grid_is_full():
    """Where the key tiles alone give SMS CTAs or more, no split; gemma3-
    1b's B 2 and B 1 split 4 and 8 ways."""
    for B, S, H, Hkv, D in ((8, 1024, 14, 2, 64), (4, 1500, 20, 20, 64),
                            (4, 1024, 32, 32, 80), (1, 8448, 4, 1, 256)):
        assert -(-S // fa.BWD_KEYS) * Hkv * B >= fa.SMS
        assert fa.bwd_plan(B, S, S, H, Hkv, D) == 1
    assert fa.bwd_plan(2, 1024, 1024, 4, 1, 256) == 4
    assert fa.bwd_plan(1, 1024, 1024, 4, 1, 256) == 8
    # a single step of the walk is never split
    assert fa.bwd_plan(1, 16, 16, 1, 1, 64) == 1


def test_hi_lo_keeps_p_and_ds_fp32():
    """Before the outputs' bf16 rounding, the kernel's hi + lo products
    carry p and ds as the fp32 function does: dq, dk and dv within 1e-5 of
    their largest magnitude of a float64 backward on the same values; one
    bf16 rounding of p and ds instead departs by more than 1e-4."""
    B, Sq, Sk, H, Hkv, D, causal, window, q_offset = CASES[0]
    arrays = _inputs(B, Sq, Sk, H, Hkv, D, seed=7)
    q, k, v, do = (torch.from_numpy(a).double() for a in arrays)
    o, lse = fa.flash_attention_ref(q, k, v, return_lse=True)
    want = fa.flash_attention_bwd_ref(q, k, v, o, lse, do)
    kw = dict(causal=True, window=0, q_offset=None, splits=4,
              out=torch.float32)
    args = ([t.bfloat16() for t in (q, k, v)] + [o.float(), lse.float(),
                                                  do.bfloat16()])
    split = _tc_emulation(*args, **kw)
    rounded = _tc_emulation(*args, hi_lo=False, **kw)
    for name, a, r, w in zip("qkv", split, rounded, want):
        assert _frac(a, w) <= 1e-5, "d" + name
        assert _frac(r, w) > 1e-4, "d" + name
