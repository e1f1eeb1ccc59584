"""The port's training path held to the JAX package on the CPU: AdamW
(``repro_torch/train/optimizer.py``), checkpoints, the synthetic LM data,
FLOP counting, the plain flash-attention and RMSNorm backwards behind
their autograd Functions, ``train_loss`` with its gradients, the train
step and ``launch.train``'s resume; and - on a CUDA card only - the
backward kernels against their plain versions.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs on the CPU on any host (``need_jax``).  Tolerances, each
with its reason:
* AdamW on the same gradients: 1e-6 relative on m, v and the fp32
  values, plus 1e-6 of the leaf's largest magnitude (m sums gradients of
  both signs) and 1e-5 of one step's lr on the values: the same
  fp32 operations in the same order, but ``b ** step``, the cosine and
  the clip's global norm by two libraries (an ulp apart; a value that
  decays towards 0 keeps its absolute error); bf16 parameters within one
  bf16 ulp of JAX's (a master an ulp off can round the other way);
* the plain flash backward and lse against ``jax.vjp`` of JAX's blocked
  flash attention (chunks of 16): 1e-5 of each output's largest
  magnitude, fp32 (one masked pass against blocked sums);
* the RMSNorm backward against ``jax.vjp`` of ``lm._norm`` and
  ``_head_rms``: fp32 1e-5 of each output's largest magnitude (other
  summation orders); bf16 inputs 2^-7 of it (one bf16 rounding of dx
  and dscale in each package, from fp32 values that differ in their
  last bits);
* ``train_loss`` and every gradient leaf against
  ``jax.value_and_grad(lm.train_loss)`` in fp32: loss 1e-5 relative,
  each leaf within GRAD_REL of its own largest |g| (small fp32 layers
  summed in other orders; measured up to 1.7e-6 of it, the loss 7e-8);
* parameters after 3 AdamW steps from each package's own gradients: the
  Adam-aware bound of ``tests/test_torch_core_qlmio.py`` (each value
  within 1e-6 + 2 lr steps min(1, 1e-5 s / |g|), s the largest gradient,
  |g| its own smallest over the steps: Adam divides a gradient's
  rounding by the gradient's own size).
The port's remat is held to its no-remat bit for bit, and a resumed
``launch.train`` run to the uninterrupted one bit for bit.
"""
import os
import shutil

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.data import lm_data as jdata
    from repro.models import attention as jattn
    from repro.models import build_model as jbuild
    from repro.models import counting as jcount
    from repro.models import lm as jlm
    from repro.train import optimizer as jopt
except ImportError:  # JAX (the reference) is not installed
    jax = None

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, reduced
from repro_torch.data.lm_data import LMDataConfig, SyntheticLM
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_gmm as mg
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import ssd_scan as sk
from repro_torch.launch.train import train
from repro_torch.models import counting, lm
from repro_torch.models.api import build_model
from repro_torch.train import checkpoint as ck
from repro_torch.train import optimizer as opt
from repro_torch.weights import from_jax_params

ATTN_ARCHS = ["qwen2-0.5b", "llama3.2-3b", "gemma3-1b", "codeqwen1.5-7b",
              "chameleon-34b"]
GRAD_REL = 1e-5  # of each leaf's largest |g|
PARAM_ATOL, ADAM_REL = 1e-6, 1e-5  # the Adam-aware bound's terms


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
    return t.detach().float().cpu().numpy()


def _close(got, want, frac, what=""):
    """|got - want| within ``frac`` of want's largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= frac * scale, (what, err, scale)


# ----------------------------------------------------------------- AdamW


def _adam_tree(rng, dtype):
    return {"a": rng.normal(size=(4, 6)).astype(np.float32),
            "b": {"w": rng.normal(size=(7,)).astype(np.float32),
                  "s": rng.normal(size=(3, 2, 2)).astype(np.float32)}}


def _jtree(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _ttree(tree, dtype):
    return opt.tree_map(lambda a: _t(a, dtype), tree)


def _hold_tree(got, want, bf16=False, atol=1e-9):
    for path, leaf in opt.tree_paths(got):
        w = want
        for k in path.strip("/").split("/"):
            w = w[k]
        w = np.asarray(jnp.asarray(w, jnp.float32))
        g = _np(leaf)
        if bf16:  # one bf16 ulp
            assert (np.abs(g - w) <= 2.0 ** -7 * np.abs(w) + 1e-30).all(), \
                path
        else:
            np.testing.assert_allclose(
                g, w, rtol=1e-6, err_msg=path,
                atol=max(atol, 1e-6 * float(np.abs(w).max())))


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("clip", [None, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax(need_jax, dtype, clip, schedule):
    """5 AdamW steps on the same gradients: m, v, the master (bf16) and
    the parameters against ``repro.train.optimizer.adamw_update``."""
    rng = np.random.default_rng(3)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=clip,
               schedule=schedule)
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    init = _adam_tree(rng, dtype)
    jp, tp = _jtree(init, jdt), _ttree(init, tdt)
    js, ts = jopt.adamw_init(jp), opt.adamw_init(tp)
    assert (js.master is None) == (ts.master is None) == (dtype == "float32")
    for _ in range(5):
        g = _adam_tree(rng, dtype)
        jp, js, jm = jopt.adamw_update(jopt.AdamWConfig(**cfg), jp,
                                       _jtree(g, jdt), js)
        tp, ts, tm = opt.adamw_update(opt.AdamWConfig(**cfg), tp,
                                      _ttree(g, tdt), ts)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-6)
    assert int(ts.step) == int(js.step) == 5
    _hold_tree(ts.m, js.m)
    _hold_tree(ts.v, js.v)
    atol = 1e-5 * cfg["lr"]
    if ts.master is not None:
        _hold_tree(ts.master, js.master, atol=atol)
    _hold_tree(tp, jp, bf16=dtype == "bfloat16", atol=atol)
    assert all(p.dtype == tdt for p in opt.leaves(tp))


# test_train_infra.py's optimizer and checkpoint cases, on the port


def test_adamw_reduces_quadratic_loss():
    cfg = opt.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=100,
                          weight_decay=0.0, clip_norm=None,
                          schedule="constant")
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.adamw_init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}  # d/dw of sum(w^2)
        params, state, _ = opt.adamw_update(cfg, params, grads, state)
    assert float(params["w"].abs().max()) < 0.2


def test_adamw_bf16_master_copy():
    cfg = opt.AdamWConfig(lr=0.01, warmup_steps=0, clip_norm=None,
                          schedule="constant", weight_decay=0.0)
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = opt.adamw_init(params)
    assert state.master is not None  # fp32 master for low-precision params
    grads = {"w": torch.full((4,), 1e-3, dtype=torch.bfloat16)}
    p2, s2, _ = opt.adamw_update(cfg, params, grads, state)
    assert p2["w"].dtype == torch.bfloat16
    assert s2.master["w"].dtype == torch.float32
    # master accumulates sub-bf16-resolution updates
    assert float((s2.master["w"] - 1.0).abs().max()) > 0


def test_clip_by_global_norm():
    g = {"a": torch.full((10,), 10.0)}
    clipped, norm = opt.clip_by_global_norm(g, 1.0)
    assert float(norm) > 1.0
    np.testing.assert_allclose(float(clipped["a"].square().sum().sqrt()),
                               1.0, rtol=1e-3)


def test_lr_schedule_shapes():
    cfg = opt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
    assert float(opt.schedule_lr(cfg, torch.tensor(0))) == 0.0
    assert float(opt.schedule_lr(cfg, torch.tensor(10))) == \
        pytest.approx(1.0)
    assert float(opt.schedule_lr(cfg, torch.tensor(100))) == \
        pytest.approx(cfg.min_lr_ratio, rel=1e-3)


def test_sgd_update_matches_jax(need_jax):
    rng = np.random.default_rng(5)
    p, g = _adam_tree(rng, None), _adam_tree(rng, None)
    want = jopt.sgd_update(_jtree(p, jnp.float32), _jtree(g, jnp.float32),
                           0.1)
    _hold_tree(opt.sgd_update(_ttree(p, None), _ttree(g, None), 0.1), want)


def test_checkpoint_roundtrip(tmp_path):
    d = str(tmp_path / "ckpt")
    tree = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nested": {"b": torch.ones(3, dtype=torch.int32), "none": None,
                       "h": torch.randn(5).to(torch.bfloat16)},
            "tup": (np.float32(1.5), np.zeros(2))}
    ck.save_checkpoint(d, 5, tree)
    step, loaded = ck.load_checkpoint(d)
    assert step == 5
    assert torch.equal(loaded["w"], tree["w"])
    assert torch.equal(loaded["nested"]["b"], tree["nested"]["b"])
    assert torch.equal(loaded["nested"]["h"], tree["nested"]["h"])
    assert loaded["nested"]["none"] is None
    assert isinstance(loaded["tup"], tuple)
    assert float(loaded["tup"][0]) == 1.5


def test_checkpoint_keep_n_and_resume(tmp_path):
    d = str(tmp_path / "ckpt")
    for s in range(6):
        ck.save_checkpoint(d, s, {"w": torch.full((3,), float(s))}, keep=3)
    assert ck.list_checkpoints(d) == [3, 4, 5]
    assert ck.latest_step(d) == 5
    step, tree = ck.load_checkpoint(d)
    assert step == 5 and float(tree["w"][0]) == 5


def test_checkpoint_preemption_safe(tmp_path):
    """A stale tmp dir from a killed writer must not break loading and gets
    cleaned up by the next successful save."""
    d = str(tmp_path / "ckpt")
    ck.save_checkpoint(d, 1, {"w": torch.ones(2)})
    os.makedirs(os.path.join(d, "ckpt_0000000002.tmp.999.123"))
    assert ck.latest_step(d) == 1  # tmp dir invisible
    ck.save_checkpoint(d, 3, {"w": torch.ones(2)})
    assert not any(".tmp." in n for n in os.listdir(d))


# ------------------------------------------------------- data and counting


@pytest.mark.parametrize("vocab,seq,batch,seed", [(512, 64, 4, 0),
                                                  (151936, 33, 3, 7)])
def test_synthetic_lm_matches_jax(need_jax, vocab, seq, batch, seed):
    want = jdata.SyntheticLM(jdata.LMDataConfig(vocab, seq, batch, seed))
    got = SyntheticLM(LMDataConfig(vocab, seq, batch, seed))
    for step in (0, 5):
        w, g = want.batch(step), got.batch(step)
        assert sorted(w) == sorted(g)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_jax(need_jax, arch):
    for name, shape in SHAPES.items():
        assert counting.model_flops(get_config(arch), shape) == \
            jcount.model_flops(jget_config(arch), JSHAPES[name])
    assert counting.active_matmul_params(get_config(arch)) == \
        jcount.active_matmul_params(jget_config(arch))


# ------------------------------------------------- the kernels' backwards

# (B, Sq, Sk, H, Hkv, D, causal, window, q_offset): causal, windowed, G
# 1/2/4, ragged S (not a multiple of the chunk), a suffix at q_offset, and
# one non-causal case
FLASH_BWD_CASES = [
    (2, 48, 48, 4, 4, 16, True, 0, None),
    (2, 40, 40, 4, 2, 16, True, 0, None),
    (1, 64, 64, 4, 1, 32, True, 24, None),
    (2, 37, 37, 4, 2, 16, True, 9, None),
    (2, 20, 50, 4, 2, 16, True, 0, 30),
    (1, 30, 45, 4, 2, 16, False, 0, None),
]


def _flash_inputs(B, Sq, Sk, H, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D),
                      (B, Sq, H, D))]


@pytest.mark.parametrize("case", FLASH_BWD_CASES)
def test_flash_backward_matches_jax_vjp(need_jax, case):
    """The plain backward (through ``FlashAttention``) and the plain lse
    against ``jax.vjp`` of JAX's blocked flash attention (chunks of 16)
    and its ``_flash_fwd_impl`` residual."""
    B, Sq, Sk, H, Hkv, D, causal, window, q_offset = case
    q, k, v, do = _flash_inputs(B, Sq, Sk, H, Hkv, D, seed=Sq + Sk)
    kw = dict(causal=causal, window=window, q_offset=q_offset)

    def jf(q_, k_, v_):
        return jattn.flash_attention(q_, k_, v_, chunk_q=16, chunk_k=16,
                                     **kw)

    @jax.jit
    def jvjp(q_, k_, v_, do_):
        out, vjp = jax.vjp(jf, q_, k_, v_)
        return out, vjp(do_)

    jo, jgrads = jvjp(*(jnp.asarray(a) for a in (q, k, v, do)))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    to = fa.flash_attention(tq, tk, tv, **kw)
    assert to.grad_fn is not None
    tgrads = torch.autograd.grad(to, (tq, tk, tv), _t(do))
    _close(_np(to), jo, 1e-5, "o")
    for name, g, w in zip("qkv", tgrads, jgrads):
        _close(_np(g), w, 1e-5, "d" + name)
    if causal:
        G = H // Hkv
        rep = [jnp.repeat(jnp.asarray(a), G, axis=2) for a in (k, v)]
        off = Sk - Sq if q_offset is None else q_offset
        _, jlse = jattn._flash_fwd_impl(jnp.asarray(q), *rep, causal, window,
                                        off, 16, 16, D ** -0.5)
        _, tlse = fa.flash_attention_fwd(_t(q), _t(k), _t(v),
                                         return_lse=True, **kw)
        np.testing.assert_allclose(_np(tlse), np.asarray(jlse)[..., :Sq],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rmsnorm", "rmsnorm_zero", "head"])
def test_rmsnorm_backward_matches_jax_vjp(need_jax, kind, dtype):
    """``RMSNorm``'s plain backward against ``jax.vjp`` of ``lm._norm``
    (plain and zero-centred) and ``_head_rms``; dx in x's type, dscale in
    the scale's."""
    rng = np.random.default_rng(11)
    d = 16 if kind == "head" else 64
    x = rng.normal(size=(2, 9, 3, d) if kind == "head" else (2, 9, d))
    s = 1 + 0.5 * rng.normal(size=(d,))
    g = rng.normal(size=x.shape)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, js, jg = (jnp.asarray(a, jdt) for a in (x, s, g))
    if kind == "head":
        jfn = jlm._head_rms
    else:
        def jfn(x_, s_):
            return jlm._norm({"ln_s": s_}, x_, kind, "ln")
    jy, vjp = jax.vjp(jfn, jx, js)
    jdx, jds = vjp(jg)
    tx, ts = (_t(a, tdt).requires_grad_() for a in (x, s))
    ty = (lm._head_rms(tx, ts) if kind == "head"
          else lm._norm({"ln_s": ts}, tx, kind, "ln"))
    tdx, tds = torch.autograd.grad(ty, (tx, ts), _t(g, tdt))
    assert tdx.dtype == tds.dtype == tdt
    frac = 1e-5 if dtype == "float32" else 2.0 ** -7
    _close(_np(ty), np.asarray(jy, np.float32), frac, "y")
    _close(_np(tdx), np.asarray(jdx, np.float32), frac, "dx")
    _close(_np(tds), np.asarray(jds, np.float32), frac, "dscale")


@pytest.mark.parametrize("what", ["flash causal", "flash window",
                                  "flash non-causal", "rmsnorm",
                                  "rmsnorm zero-centred"])
def test_functions_gradcheck_float64(what):
    """``torch.autograd.gradcheck`` of both Functions' CPU path in float64
    at tiny shapes (the plain versions keep float64)."""
    g = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=g,
                           dtype=torch.float64).requires_grad_()

    if what.startswith("flash"):
        q, k, v = rand(1, 5, 4, 4), rand(1, 7, 2, 4), rand(1, 7, 2, 4)
        kw = {"flash causal": {}, "flash window": {"window": 3},
              "flash non-causal": {"causal": False}}[what]
        assert torch.autograd.gradcheck(
            lambda *a: fa.flash_attention(*a, **kw), (q, k, v))
    else:
        x, s = rand(3, 2, 8), rand(8)
        zc = what.endswith("centred")
        assert torch.autograd.gradcheck(
            lambda *a: rn.rmsnorm(*a, zero_centered=zc), (x, s))


def test_serving_forward_builds_no_graph():
    """Without grad (serving) the wrappers build no graph and write no
    lse; with an input that requires grad they go through the Function.
    The same for the grouped matmul and the SSD scan, and for a reduced
    MoE and zamba2 forward whose weights require grad."""
    q, k, v, _ = (_t(a) for a in _flash_inputs(1, 8, 8, 2, 1, 16, seed=1))
    x, w = torch.randn(2, 3, 16), torch.randn(2, 16, 4, requires_grad=True)
    scan = (torch.randn(1, 8, 2, 4), torch.rand(1, 8, 2) + 0.1,
            -torch.ones(2, requires_grad=True), torch.randn(1, 8, 4),
            torch.randn(1, 8, 4))
    assert fa.flash_attention(q, k, v).grad_fn is None
    assert mg.grouped_matmul(x, w.detach()).grad_fn is None
    with torch.no_grad():
        assert fa.flash_attention(q, k, v.requires_grad_()).grad_fn is None
        assert rn.rmsnorm(q, torch.ones(16, requires_grad=True)).grad_fn \
            is None
        assert mg.grouped_matmul(x, w).grad_fn is None
        assert sk.ssd_scan(*scan, chunk=4)[0].grad_fn is None
    assert isinstance(fa.flash_attention(q, k, v).grad_fn,
                      fa.FlashAttention._backward_cls)
    assert isinstance(rn.rmsnorm(q, torch.ones(16, requires_grad=True))
                      .grad_fn, rn.RMSNorm._backward_cls)
    assert isinstance(mg.grouped_matmul(x, w).grad_fn,
                      mg.GroupedMatmul._backward_cls)
    assert isinstance(sk.ssd_scan(*scan, chunk=4)[0].grad_fn,
                      sk.SSDScan._backward_cls)
    tokens = torch.randint(0, 512, (1, 16))
    for arch, forward in (("granite-moe-1b-a400m", lm.attn_forward),
                          ("zamba2-2.7b", lm.zamba2_forward)):
        cfg = reduced(get_config(arch))
        params = opt.tree_map(lambda p: p.requires_grad_(),
                              build_model(cfg).init(0, device="cpu"))
        with torch.no_grad():
            assert forward(cfg, params, tokens).grad_fn is None
        assert forward(cfg, params, tokens).grad_fn is not None


# ------------------------------------------------------- loss and gradients


def _models(arch, **over):
    jcfg = jreduced(jget_config(arch), act_dtype="float32", **over)
    tcfg = reduced(get_config(arch), act_dtype="float32", **over)
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0), param_dtype=jnp.float32)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _batch(vocab, B=2, S=40, seed=0, ignore=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels[:, :ignore] = -1
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": _t(toks.astype(np.int64)),
             "labels": _t(labels.astype(np.int64))})


def _hold_grads(paths, grads, jgrads):
    for path, g in zip(paths, grads):
        w = jgrads
        for k in path.strip("/").split("/"):
            w = w[k]
        _close(_np(g), np.asarray(w), GRAD_REL, path)


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_train_loss_and_grads_match_jax(need_jax, arch):
    """``train_loss`` and every gradient leaf against
    ``jax.value_and_grad(lm.train_loss)`` in fp32; the port's remat gives
    its no-remat loss and gradients bit for bit."""
    jcfg, tcfg, jp, tp = _models(arch)
    jb, tb = _batch(tcfg.vocab, ignore=3)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.train_loss(jcfg, p, jb)))(jp)
    out = {}
    for remat in (True, False):
        live = opt.tree_map(lambda p: p.detach().requires_grad_(), tp)
        loss = lm.train_loss(tcfg, live, tb, remat=remat)
        flat = opt.leaves(live)
        grads = torch.autograd.grad(loss, flat)
        out[remat] = (loss, grads)
    assert torch.equal(out[True][0], out[False][0])
    assert all(torch.equal(a, b) for a, b in zip(out[True][1], out[False][1]))
    np.testing.assert_allclose(out[True][0].item(), float(jl), rtol=1e-5)
    _hold_grads([p for p, _ in opt.tree_paths(tp)], out[True][1], jg)


def test_chunked_xent_matches_jax(need_jax):
    """Several chunks (16), a ragged last one, ignored labels and a logit
    softcap: the loss and its gradients against JAX's ``chunked_xent``."""
    jcfg, tcfg, jp, tp = _models("gemma3-1b", logit_softcap=30.0)
    rng = np.random.default_rng(2)
    h = rng.normal(size=(2, 37, tcfg.d_model)).astype(np.float32)
    _, tb = _batch(tcfg.vocab, S=37, seed=4, ignore=5)
    labels = tb["labels"].numpy().astype(np.int32)
    jfn = jax.jit(jax.value_and_grad(
        lambda h_, t_: jlm.chunked_xent(jcfg, {"embed": {"table": t_}}, h_,
                                        jnp.asarray(labels), chunk=16),
        argnums=(0, 1)))
    jl, (jdh, jdt) = jfn(jnp.asarray(h), jp["embed"]["table"])
    th = _t(h).requires_grad_()
    tt = tp["embed"]["table"].detach().requires_grad_()
    tl = lm.chunked_xent(tcfg, {"embed": {"table": tt}}, th, tb["labels"],
                         chunk=16)
    tdh, tdt = torch.autograd.grad(tl, (th, tt))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    _close(_np(tdh), jdh, GRAD_REL, "dh")
    _close(_np(tdt), jdt, GRAD_REL, "dtable")


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma3-1b"])
def test_train_steps_match_jax(need_jax, arch):
    """3 ``make_train_step`` steps of both packages from the same weights
    and batches: the losses, and the parameters within the Adam-aware
    bound (|g| and s from the port's gradients at each step)."""
    jcfg, tcfg, jp, tp = _models(arch)
    ocfg = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jstep = jax.jit(jm.make_train_step(jopt.AdamWConfig(**ocfg)))
    tstep = tm.make_train_step(opt.AdamWConfig(**ocfg))
    jo, to = jm.init_opt(jp), tm.init_opt(tp)
    lo, s = None, 0.0
    for i in range(3):
        jb, tb = _batch(tcfg.vocab, S=32, seed=10 + i)
        live = opt.tree_map(lambda p: p.detach().requires_grad_(), tp)
        grads = torch.autograd.grad(tm.train_loss(live, tb),
                                    opt.leaves(live))
        ga = [g.abs() for g in grads]
        lo = ga if lo is None else [torch.minimum(a, b)
                                    for a, b in zip(lo, ga)]
        s = max(s, max(float(a.max()) for a in ga))
        jp, jo, jmet = jstep(jp, jo, jb)
        tp, to, tmet = tstep(tp, to, tb)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
    for (path, leaf), low in zip(opt.tree_paths(tp), lo):
        w = jp
        for k in path.strip("/").split("/"):
            w = w[k]
        diff = np.abs(_np(leaf) - np.asarray(w))
        share = np.minimum(1.0, ADAM_REL * s / np.maximum(_np(low), 1e-30))
        bound = PARAM_ATOL + 2 * ocfg["lr"] * 3 * share
        assert (diff <= bound).all(), (path, float((diff - bound).max()))


def test_launch_train_resume_is_bitwise(tmp_path):
    """``launch.train`` on the CPU: 8 steps checkpointing every 4; a
    second run from the step-4 checkpoint gives the uninterrupted run's
    last 4 losses and final parameters bit for bit."""
    kw = dict(steps=8, batch=2, seq=32, ckpt_every=4, log_every=0,
              device="cpu")
    full, fresh = str(tmp_path / "full"), str(tmp_path / "resume")
    params, losses = train("qwen2-0.5b", ckpt_dir=full, **kw)
    assert ck.list_checkpoints(full) == [4, 8]
    assert np.isfinite(losses).all() and len(losses) == 8
    os.makedirs(fresh)
    shutil.copytree(os.path.join(full, "ckpt_0000000004"),
                    os.path.join(fresh, "ckpt_0000000004"))
    resumed, rest = train("qwen2-0.5b", ckpt_dir=fresh, **kw)
    assert rest == losses[4:]
    assert all(torch.equal(a, b) for a, b in
               zip(opt.leaves(resumed), opt.leaves(params)))
    step, tree = ck.load_checkpoint(fresh)
    assert step == 8 and int(tree["opt"]["step"]) == 8


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "whisper-large-v3"])
def test_input_specs_match_jax(need_jax, arch):
    tm, jm = build_model(get_config(arch)), jbuild(jget_config(arch))
    for name, shape in SHAPES.items():
        for mode in ("train", "prefill", "decode"):
            got = tm.input_specs(shape, mode=mode)
            want = jm.input_specs(JSHAPES[name], mode=mode)
            assert sorted(got) == sorted(want)
            for k, w in want.items():
                assert got[k].device.type == "meta"
                assert tuple(got[k].shape) == tuple(w.shape)
                assert str(got[k].dtype)[6:] == str(w.dtype), k


# ------------------------------------------------------------- the card

# (B, Sq, Sk, H, Hkv, D, causal, window, q_offset)
GPU_FLASH_CASES = [
    (1, 256, 256, 14, 2, 64, True, 0, None),
    (1, 200, 200, 24, 8, 128, True, 0, None),
    (1, 300, 300, 4, 1, 256, True, 128, None),
    (2, 70, 70, 4, 2, 16, True, 0, None),
    (2, 40, 150, 4, 2, 32, True, 0, 100),
    (1, 33, 65, 4, 4, 64, False, 0, None),
    # gemma3-1b's heads, whose bf16 key pass bwd_plan splits (4 and 16
    # ways), local (window 512) and global
    (2, 1024, 1024, 4, 1, 256, True, 512, None),
    (1, 512, 512, 4, 1, 256, True, 0, None),
    # one query tile shorter than a tile at D 256, windowed, at q_offset
    (1, 20, 300, 4, 1, 256, True, 64, 280),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GPU_FLASH_CASES)
def test_flash_backward_kernel(cuda, case, dtype):
    """The backward kernel against the plain backward on the same inputs
    (fp32: 1e-4 of each output's largest magnitude, summation order; bf16:
    2^-7 of it, one bf16 rounding of the outputs), two calls bit-equal,
    the forward's lse within 1e-4."""
    B, Sq, Sk, H, Hkv, D, causal, window, q_offset = case
    dt = getattr(torch, dtype)
    q, k, v, do = (_t(a, dt, cuda)
                   for a in _flash_inputs(B, Sq, Sk, H, Hkv, D, seed=D))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    _, want_lse = fa.flash_attention_ref(q, k, v, return_lse=True, **kw)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
    before = fa.flash_attention.bwd_launches
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert fa.flash_attention.bwd_launches == before + 2
    want = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    frac = 1e-4 if dtype == "float32" else 2.0 ** -7
    for name, a, b, w in zip("qkv", got, again, want):
        assert torch.equal(a, b), name
        _close(_np(a), _np(w), frac, "d" + name)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_backward_kernel_no_keys(cuda, dtype):
    """With no key (Sk 0) the backward launches nothing and returns a zero
    dq, as the plain backward does, not the allocator's stale memory."""
    dt = getattr(torch, dtype)
    q, _, _, do = (_t(a, dt, cuda)
                   for a in _flash_inputs(1, 8, 8, 4, 2, 64, seed=5))
    k = v = torch.empty(1, 0, 2, 64, device=cuda, dtype=dt)
    o = torch.zeros_like(q)
    lse = torch.zeros(1, 4, 8, device=cuda)
    torch.full_like(q, float("nan"))  # freed at once: NaNs in the cache
    before = fa.flash_attention.bwd_launches
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=False)
    want = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=False)
    assert fa.flash_attention.bwd_launches == before
    for a, w in zip(got, want):
        assert a.shape == w.shape and torch.equal(a, w)
    assert not got[0].abs().sum()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d,zc", [(1, 896, False), (8192, 896, False),
                                       (1024, 1152, True), (4096, 256, True),
                                       (300, 3072, False), (7, 16, True)])
def test_rmsnorm_backward_kernel(cuda, rows, d, zc, dtype):
    """The backward kernels against the plain backward (fp32 1e-5 of each
    output's largest magnitude; bf16 2^-7), two calls bit-equal."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(d)
    x, dy = (_t(rng.normal(size=(rows, d)), dt, cuda) for _ in range(2))
    s = _t(1 + 0.5 * rng.normal(size=d), dt, cuda)
    got = rn.rmsnorm_bwd(x, s, dy, zero_centered=zc)
    again = rn.rmsnorm_bwd(x, s, dy, zero_centered=zc)
    want = rn.rmsnorm_bwd_ref(x, s, dy, zero_centered=zc)
    frac = 1e-5 if dtype == "float32" else 2.0 ** -7
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        _close(_np(a), _np(w), frac)


@pytest.mark.gpu
def test_backward_kernels_no_host_sync(cuda):
    q, k, v, do = (_t(a, torch.bfloat16, cuda)
                   for a in _flash_inputs(2, 128, 128, 4, 2, 64, seed=3))
    o, lse = fa.flash_attention_fwd(q, k, v, return_lse=True)
    x = torch.randn(64, 896, device=cuda, dtype=torch.bfloat16)
    s = torch.ones(896, device=cuda, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fa.flash_attention_bwd(q, k, v, o, lse, do)
        rn.rmsnorm_bwd(x, s, x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(2, 1024, 1024, 4, 1, 256, 512, 4),
                                  (8, 1024, 1024, 14, 2, 64, 0, 1)])
def test_flash_backward_bit_equal_without_sync(cuda, case):
    """Two bf16 calls (gemma3-1b's heads, the key pass split 4 ways;
    qwen2-0.5b's training shape, one split) give the same bits, with no
    host sync (sync debug mode "error")."""
    B, S, _, H, Hkv, D, window, splits = case
    q, k, v, do = (_t(a, torch.bfloat16, cuda)
                   for a in _flash_inputs(B, S, S, H, Hkv, D, seed=D))
    o, lse = fa.flash_attention_fwd(q, k, v, window=window, return_lse=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, window=window)
        again = fa.flash_attention_bwd(q, k, v, o, lse, do, window=window)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert fa.bwd_plan(B, S, S, H, Hkv, D) == splits
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_serving_forward_writes_no_lse(cuda):
    """A serving call (no grad) launches the forward kernel without lse
    and no backward; a training call goes through the Function."""
    q, k, v, do = (_t(a, torch.bfloat16, cuda)
                   for a in _flash_inputs(1, 64, 64, 4, 2, 64, seed=4))
    launches = (fa.flash_attention.launches, fa.flash_attention.bwd_launches)
    with torch.no_grad():
        out = fa.flash_attention(q, k, v.requires_grad_())
    assert out.grad_fn is None
    assert (fa.flash_attention.launches,
            fa.flash_attention.bwd_launches) == (launches[0] + 1, launches[1])
    out = fa.flash_attention(q, k, v)
    torch.autograd.grad(out, v, do)
    assert fa.flash_attention.bwd_launches == launches[1] + 1
