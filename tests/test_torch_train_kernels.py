"""The backwards of the grouped matmul and the SSD scan, and the flash
backward at zamba2's and whisper's shapes, held to the JAX package on the
CPU; and - on a CUDA card only - the backward kernels against their plain
versions.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs on the CPU on any host (``need_jax``).  Tolerances, each
with its reason:
* ``grouped_matmul_bwd_ref`` against ``jax.vjp`` of the JAX package's
  ``grouped_matmul_ref`` (``repro/kernels/ref.py:70``): fp32 1e-5 of each
  output's largest magnitude (the same einsums, other summation orders);
  bf16 inputs 2^-7 of it (one bf16 rounding of dx and dw in each package,
  from fp32 sums that differ in their last bits);
* ``ssd_scan_bwd_ref`` against ``jax.vjp`` of ``ssd_chunked``
  (``repro/models/mamba2.py:51``), with and without a final-state
  cotangent: fp32 1e-5 of each output's largest magnitude (the
  hand-written backward against XLA's autodiff: other orders, the same
  exponentials); bf16 x, B and C 2^-7 of it (one rounding of dx, dB and
  dC; ddt and da_neg fp32);
* the plain flash backward at head dim 80 and with Sq != Sk non-causal
  (whisper's cross-attention) against ``jax.vjp`` of JAX's blocked flash
  attention (the custom_vjp ``_flash_bwd``, ``models/attention.py:158``):
  1e-5 of each output's largest magnitude, fp32;
* ``gradcheck`` of ``GroupedMatmul`` and ``SSDScan`` in float64 (the
  plain versions keep float64; the scan's in gradcheck's fast mode, which
  checks random projections of the Jacobian).
The card's cases (marked ``gpu``) hold each backward kernel to its plain
version on the same inputs: fp32 1e-5 of each output's largest magnitude
(summation order; the SSD kernel cuts the sequence in blocks of 64 where
the plain version cuts chunks), bf16 2^-7 of it, two calls bit-equal.
"""
import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from repro.kernels import ref as jref
    from repro.models import attention as jattn
    from repro.models import mamba2 as jm2
except ImportError:  # JAX (the reference) is not installed
    jax = None

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_gmm as mg
from repro_torch.kernels import ssd_scan as sk


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


def _np(t):
    return np.asarray(t.detach().float().cpu().numpy(), np.float64)


def _close(got, want, frac, what=""):
    """|got - want| within ``frac`` of want's largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= frac * scale, (what, err, scale)


def _frac(dtype):
    return 1e-5 if dtype == "float32" else 2.0 ** -7


# ------------------------------------------------------- grouped matmul


def _gmm_inputs(E, C, K, N, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((E, C, K), (E, K, N), (E, C, N))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 24, 32, 48), (3, 5, 70, 90)])
def test_grouped_matmul_backward_matches_jax_vjp(need_jax, shape, dtype):
    """``GroupedMatmul``'s plain backward against ``jax.vjp`` of
    ``grouped_matmul_ref``: dx and dw in the operands' type."""
    x, w, dy = _gmm_inputs(*shape, seed=sum(shape))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jw, jdy = (jnp.asarray(a, jdt) for a in (x, w, dy))
    jy, vjp = jax.vjp(jref.grouped_matmul_ref, jx, jw)
    jdx, jdw = vjp(jdy)
    tx, tw = (_t(a, tdt).requires_grad_() for a in (x, w))
    ty = mg.grouped_matmul(tx, tw)
    assert isinstance(ty.grad_fn, mg.GroupedMatmul._backward_cls)
    tdx, tdw = torch.autograd.grad(ty, (tx, tw), _t(dy, tdt))
    assert tdx.dtype == tdw.dtype == tdt
    _close(_np(ty), np.asarray(jy, np.float32), _frac(dtype), "y")
    _close(_np(tdx), np.asarray(jdx, np.float32), _frac(dtype), "dx")
    _close(_np(tdw), np.asarray(jdw, np.float32), _frac(dtype), "dw")
    got = mg.grouped_matmul_bwd_ref(_t(x, tdt), _t(w, tdt), _t(dy, tdt))
    assert all(torch.equal(a, b) for a, b in zip(got, (tdx, tdw)))


# ------------------------------------------------------------- SSD scan


def _scan_inputs(b, S, h, p, n, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(x=rng.normal(size=(b, S, h, p)).astype(f),
                dt=(0.05 + 0.5 * rng.random((b, S, h))).astype(f),
                a_neg=(-0.3 - rng.random(h)).astype(f),
                B=rng.normal(size=(b, S, n)).astype(f),
                C=rng.normal(size=(b, S, n)).astype(f),
                dy=rng.normal(size=(b, S, h, p)).astype(f),
                dfinal=rng.normal(size=(b, h, p, n)).astype(f),
                init=rng.normal(size=(b, h, p, n)).astype(f))


# (b, S, h, p, n, chunk, final-state cotangent, initial state)
SCAN_CASES = [(2, 32, 3, 8, 4, 8, False, False),
              (2, 32, 3, 8, 4, 8, True, False),
              (1, 48, 2, 4, 8, 16, True, True),
              (2, 20, 2, 8, 4, 20, False, False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SCAN_CASES)
def test_ssd_scan_backward_matches_jax_vjp(need_jax, case, dtype):
    """``ssd_scan_bwd_ref`` (and ``SSDScan``'s backward through it)
    against ``jax.vjp`` of ``ssd_chunked``: dx, ddt, da_neg, dB, dC, from
    y's cotangent and (where given) the final state's; an initial state,
    where given, is a value (not differentiated)."""
    b, S, h, p, n, chunk, with_final, with_init = case
    a = _scan_inputs(b, S, h, p, n, seed=S + h)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    init = a["init"] if with_init else None

    def jf(x, dt, a_neg, B, C):
        return jm2.ssd_chunked(x, dt, a_neg, B, C, chunk=chunk,
                               init_state=None if init is None
                               else jnp.asarray(init))

    args = [jnp.asarray(a["x"], jdt), jnp.asarray(a["dt"]),
            jnp.asarray(a["a_neg"]), jnp.asarray(a["B"], jdt),
            jnp.asarray(a["C"], jdt)]
    (jy, jfin), vjp = jax.vjp(jf, *args)
    dfinal = a["dfinal"] if with_final else np.zeros_like(a["dfinal"])
    jgrads = vjp((jnp.asarray(a["dy"]), jnp.asarray(dfinal)))
    targs = [_t(a["x"], tdt), _t(a["dt"]), _t(a["a_neg"]), _t(a["B"], tdt),
             _t(a["C"], tdt)]
    got = sk.ssd_scan_bwd_ref(
        *targs, _t(a["dy"]), _t(dfinal) if with_final else None,
        chunk=chunk, init_state=None if init is None else _t(init))
    live = [t.clone().requires_grad_() for t in targs]
    ty, tfin = sk.ssd_scan(*live, chunk=chunk,
                           init_state=None if init is None else _t(init))
    assert isinstance(ty.grad_fn, sk.SSDScan._backward_cls)
    outs, cots = (ty,), (_t(a["dy"]),)
    if with_final:
        outs, cots = (ty, tfin), (_t(a["dy"]), _t(dfinal))
    through = torch.autograd.grad(outs, live, cots)
    frac = _frac(dtype)
    _close(_np(ty), np.asarray(jy), 1e-5, "y")
    _close(_np(tfin), np.asarray(jfin), 1e-5, "final state")
    for name, g, t, w, arg in zip(("dx", "ddt", "da_neg", "dB", "dC"), got,
                                  through, jgrads, targs):
        assert g.dtype == arg.dtype, name
        assert torch.equal(g, t), name
        _close(_np(g), np.asarray(w, np.float32), frac, name)


def test_ssd_scan_init_state_grad_refused():
    """A gradient asked through the initial state raises, naming the
    ROADMAP item."""
    a = _scan_inputs(1, 8, 2, 4, 4, seed=1)
    init = _t(a["init"]).requires_grad_()
    with pytest.raises(NotImplementedError, match="item 18"):
        sk.ssd_scan(_t(a["x"]), _t(a["dt"]), _t(a["a_neg"]), _t(a["B"]),
                    _t(a["C"]), chunk=4, init_state=init)


# ---------------------------------------------------------- flash at D 80

# (B, Sq, Sk, H, Hkv, D, causal): zamba2's shared block (32/32 heads of
# 80, here 4/4), whisper's encoder (non-causal) and its cross-attention
# (Sq != Sk, non-causal), ragged against the chunks of 16
FLASH_CASES = [(2, 37, 37, 4, 4, 80, True), (1, 30, 30, 4, 4, 16, False),
               (2, 21, 45, 4, 4, 16, False), (1, 24, 50, 2, 2, 80, False)]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_backward_new_shapes_match_jax_vjp(need_jax, case):
    """The plain flash backward (through ``FlashAttention``) against
    ``jax.vjp`` of JAX's blocked flash attention (``_flash_bwd``)."""
    B, Sq, Sk, H, Hkv, D, causal = case
    rng = np.random.default_rng(D + Sq)
    q, k, v, do = (rng.normal(size=s).astype(np.float32)
                   for s in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D),
                             (B, Sq, H, D)))

    def jf(q_, k_, v_):
        return jattn.flash_attention(q_, k_, v_, causal=causal, chunk_q=16,
                                     chunk_k=16)

    jo, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    to = fa.flash_attention(tq, tk, tv, causal=causal)
    tgrads = torch.autograd.grad(to, (tq, tk, tv), _t(do))
    _close(_np(to), jo, 1e-5, "o")
    for name, g, w in zip("qkv", tgrads, jgrads):
        _close(_np(g), w, 1e-5, "d" + name)
    assert 80 in fa.BWD_HEAD_DIMS


# ------------------------------------------------------------- gradcheck


@pytest.mark.parametrize("what", ["grouped matmul", "ssd scan",
                                  "ssd scan, final state"])
def test_functions_gradcheck_float64(what):
    """``torch.autograd.gradcheck`` of ``GroupedMatmul`` and ``SSDScan``
    (y alone, and y with the final state) on the CPU in float64."""
    g = torch.Generator().manual_seed(0)

    def rand(*shape, lo=None, hi=None):
        t = torch.randn(*shape, generator=g, dtype=torch.float64)
        if lo is not None:
            t = lo + (hi - lo) * torch.rand(*shape, generator=g,
                                            dtype=torch.float64)
        return t.requires_grad_()

    if what == "grouped matmul":
        assert torch.autograd.gradcheck(mg.grouped_matmul,
                                        (rand(3, 5, 4), rand(3, 4, 6)))
        return
    args = (rand(1, 6, 2, 2), rand(1, 6, 2, lo=0.05, hi=0.6),
            rand(2, lo=-1.2, hi=-0.3), rand(1, 6, 3), rand(1, 6, 3))

    def fn(*a):
        y, final = sk.ssd_scan(*a, chunk=3)
        return (y, final) if what.endswith("state") else y

    assert torch.autograd.gradcheck(fn, args, fast_mode=True)


# ------------------------------------------------------------- the card


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 8, 64, 96), (3, 37, 70, 90),
                                   (8, 320, 256, 128), (2, 200, 512, 64)])
def test_grouped_matmul_backward_kernel(cuda, shape, dtype):
    """The backward kernels against the plain backward on the same
    inputs (fp32 1e-5, bf16 2^-7 of each output's largest magnitude), two
    calls bit-equal, one count a call."""
    tdt = getattr(torch, dtype)
    x, w, dy = (_t(a, tdt, cuda) for a in _gmm_inputs(*shape, seed=7))
    before = mg.grouped_matmul.bwd_launches
    got = mg.grouped_matmul_bwd(x, w, dy)
    again = mg.grouped_matmul_bwd(x, w, dy)
    assert mg.grouped_matmul.bwd_launches == before + 2
    want = mg.grouped_matmul_bwd_ref(x, w, dy)
    for a, b, ww in zip(got, again, want):
        assert a.dtype == tdt and torch.equal(a, b)
        _close(_np(a), _np(ww), _frac(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [(1, 200, 4, 16, 8, 200, True),
                                  (2, 256, 8, 64, 64, 256, False),
                                  (1, 1024, 8, 64, 64, 256, True),
                                  (2, 48, 3, 8, 4, 16, False)])
def test_ssd_scan_backward_kernel(cuda, case, dtype):
    """The four backward kernels against ``ssd_scan_bwd_ref`` (fp32 1e-5,
    bf16 2^-7 of each output's largest magnitude), two calls bit-equal."""
    b, S, h, p, n, chunk, with_final = case
    a = _scan_inputs(b, S, h, p, n, seed=S)
    tdt = getattr(torch, dtype)
    args = (_t(a["x"], tdt, cuda), _t(a["dt"], None, cuda),
            _t(a["a_neg"], None, cuda), _t(a["B"], tdt, cuda),
            _t(a["C"], tdt, cuda), _t(a["dy"], None, cuda),
            _t(a["dfinal"], None, cuda) if with_final else None)
    got = sk.ssd_scan_bwd(*args, chunk=chunk)
    again = sk.ssd_scan_bwd(*args, chunk=chunk)
    want = sk.ssd_scan_bwd_ref(*args, chunk=chunk)
    for name, g, g2, w in zip(("dx", "ddt", "da_neg", "dB", "dC"), got,
                              again, want):
        assert g.dtype == w.dtype and torch.equal(g, g2), name
        _close(_np(g), _np(w), _frac(dtype), name)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [(1, 300, 300, 4, 4, 80, True),
                                  (1, 200, 200, 4, 4, 64, False),
                                  (1, 100, 300, 4, 4, 64, False),
                                  (2, 256, 256, 8, 1, 80, True),
                                  (1, 64, 1500, 2, 1, 64, False)])
def test_flash_backward_kernel_new_shapes(cuda, case, dtype):
    """The flash backward kernel at D 80 and whisper's non-causal shapes
    (Sk past the 64-key tile) against the plain backward; the last two
    split the bf16 key pass (16 and 2 ways, ``bwd_plan``)."""
    B, Sq, Sk, H, Hkv, D, causal = case
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(D)
    q, k, v, do = (_t(rng.normal(size=s), tdt, cuda)
                   for s in ((B, Sq, H, D), (B, Sk, Hkv, D),
                             (B, Sk, Hkv, D), (B, Sq, H, D)))
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        _close(_np(a), _np(w), _frac(dtype))


@pytest.mark.gpu
def test_new_backward_kernels_no_host_sync(cuda):
    x, w, dy = (_t(a, torch.bfloat16, cuda)
                for a in _gmm_inputs(8, 64, 128, 96, seed=2))
    a = _scan_inputs(1, 128, 4, 16, 8, seed=2)
    sargs = (_t(a["x"], torch.bfloat16, cuda), _t(a["dt"], None, cuda),
             _t(a["a_neg"], None, cuda), _t(a["B"], torch.bfloat16, cuda),
             _t(a["C"], torch.bfloat16, cuda), _t(a["dy"], None, cuda))
    mg.grouped_matmul_bwd(x, w, dy)
    sk.ssd_scan_bwd(*sargs, chunk=64)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        mg.grouped_matmul_bwd(x, w, dy)
        sk.ssd_scan_bwd(*sargs, chunk=64)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
