"""Port of the Whisper encoder-decoder family against the JAX package:
``lm.whisper_encode`` and ``lm.whisper_decode_forward`` (hidden states
and the self- and cross-attention K/V), ``Model.prefill`` (exact and
bucket-padded) and the dense ``serve_step`` of reduced whisper-large-v3
on the same fp32 weights (``from_jax_params``), and the serving engine
(dense backend, bucketed monolithic prefill, each request's frames in
``Request.extra``) against the JAX engine's ``Request.output``, with the
refusals of both (no frames, the paged and int8 backends, embedding
spans).  Also: the full-width spec against the JAX package's
(1,601,976,320 parameters).  On a CUDA card only: the flash-attention
and flash-decode kernels at whisper-large-v3's shapes (20 heads of 64,
1500 encoder frames, a 448-token decoder).

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs on the CPU on any host (``need_jax``).

Tolerances (each with its reason):
* the encoder, the decoder and the model steps in fp32: 1e-4 absolute
  and relative on hidden states and K/V (fp32 matmuls, softmaxes and
  LayerNorms of at most two encoder and two decoder layers in other
  orders; differences seen are ~1e-6); logits within 1e-4 of the
  largest |logit|; bf16 cache leaves within one bf16 ulp (fp32 values
  that differ in their last bits may round to neighbouring bf16 values);
* engines: identical greedy tokens;
* the kernels: test_torch_multimodal.py's and test_torch_dense.py's
  tolerances, for the reasons stated there.
"""
import functools

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models import build_model as jbuild
    from repro.models import lm as jlm
    from repro.serving.engine import Request as JRequest
    from repro.serving.engine import ServingEngine as JEngine
except ImportError:  # JAX (the reference) is not installed
    jax = None

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.flash_decode import flash_decode_ref
from repro_torch.models import lm
from repro_torch.models.api import build_model
from repro_torch.nn import spec as spec_lib
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.weights import from_jax_params

ARCH = "whisper-large-v3"
STEP_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture
def need_jax():
    """JAX, with the reference computed on the CPU on any host: JAX on a
    GPU computes fp32 products at a lower default precision than these
    tolerances allow for."""
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
    return np.asarray(x.float().cpu() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32), np.float32)


def _hold(got, want, tol=STEP_TOL):
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _hold(g, w, tol)
        return
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


def _hold_logits(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))


@functools.cache
def _models():
    cfg = jreduced(jget_config(ARCH), act_dtype="float32")
    jm = jbuild(cfg)
    jp = jm.init(jax.random.PRNGKey(0), param_dtype=jnp.float32)
    tm = build_model(reduced(get_config(ARCH), act_dtype="float32"))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jm, jp, tm, tp


def _frames(cfg, B, seed):
    return np.random.default_rng(seed).normal(
        size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


# ------------------------------------------------------------------ specs


def test_spec_tree_matches_jax(need_jax):
    """Reduced: the port's spec has the JAX params' tree and shapes
    (encoder, enc_final, decoder self- and cross-attention with biases,
    the plain gelu MLP).  Full width: every leaf's shape as
    ``Model.abstract()``, 1,601,976,320 parameters, 20 heads of 64."""
    cfg, jm, jp, tm, tp = _models()
    specs = spec_lib.tree_map_specs(lambda path, s: s.shape, tm.spec)
    assert specs == jax.tree.map(lambda a: a.shape, jp)
    assert set(tp["layers"]["mlp"]) == {"w1", "b1", "w2", "b2"}
    assert "bk" in tp["layers"]["xattn"] and "enc_final_b" in tp
    jabs = jbuild(jget_config(ARCH)).abstract()
    full = build_model(get_config(ARCH))
    shapes = spec_lib.tree_map_specs(lambda path, s: s.shape, full.spec)
    assert shapes == jax.tree.map(lambda a: a.shape, jabs)
    n = sum(int(np.prod(s)) for s in jax.tree.leaves(
        shapes, is_leaf=lambda s: isinstance(s, tuple)))
    assert n == 1_601_976_320
    assert full.cfg.hd == 64 and full.cfg.encoder_seq == 1500


# ------------------------------------------------------- encoder, decoder


def test_encoder_and_decoder_match_jax(need_jax):
    """The encoder output (sinusoid with ``half - 1``, LayerNorm eps 1e-5,
    non-causal attention, tanh gelu, ``enc_final``), then the decoder's
    final hidden states and its k, v, xk, xv over a 21-token prompt."""
    cfg, jm, jp, tm, tp = _models()
    frames = _frames(cfg, 2, seed=0)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 21))
    jenc = jlm.whisper_encode(cfg, jp, jnp.asarray(frames), remat=False)
    tenc = lm.whisper_encode(tm.cfg, tp, _t(frames))
    _hold(tenc, jenc)
    jh, jkv = jlm.whisper_decode_forward(cfg, jp, jnp.asarray(toks,
                                                              jnp.int32),
                                         jenc, remat=False,
                                         return_cache=True)
    th, tkv = lm.whisper_decode_forward(tm.cfg, tp, _t(toks), tenc,
                                        return_cache=True)
    _hold(th, jh)
    _hold(tkv, jkv)


def test_sinusoid_matches_jax(need_jax):
    """The position table at the decoder's positions and at the 1500
    frames of whisper-large-v3's width."""
    pos = np.arange(1500)
    for d in (64, 1280):
        half = d // 2
        freqs = jnp.exp(-jnp.arange(half) / (half - 1) * jnp.log(10000.0))
        jpe = jnp.concatenate([jnp.sin(pos[:, None] * freqs[None]),
                               jnp.cos(pos[:, None] * freqs[None])], -1)
        np.testing.assert_allclose(_np(lm.sinusoid(_t(pos), d)),
                                   np.asarray(jpe), atol=2e-4, rtol=0)


# ------------------------------------------------------------ model steps


def _hold_cache(jcache, tcache):
    """Dtypes equal; pos_map exactly; fp32 leaves within STEP_TOL; bf16
    leaves within one bf16 ulp of the larger value.  Where a leaf differs
    at all, the JAX values are copied into the port's, so that the next
    step starts from equal caches."""
    assert set(jcache) == set(tcache)
    for name, leaf in jcache.items():
        got = tcache[name]
        assert tuple(got.shape) == leaf.shape, name
        assert str(got.dtype).removeprefix("torch.") == str(leaf.dtype), name
        a, b = _np(leaf), _np(got)
        if name == "pos_map":
            np.testing.assert_array_equal(b, a)
        elif got.dtype == torch.bfloat16:
            bound = 2.0 ** -7 * np.maximum(np.abs(a), np.abs(b))
            assert bool((np.abs(a - b) <= bound).all()), name
        else:
            np.testing.assert_allclose(b, a, **STEP_TOL, err_msg=name)
        if (a != b).any():
            got.copy_(torch.from_numpy(np.array(a)).to(got.dtype))


@pytest.mark.parametrize("bucketed", [False, True])
def test_prefill_and_decode_match_jax(need_jax, bucketed):
    """``Model.prefill`` of a 13-token prompt (exact, or right-padded to 16
    with ``length``; logits and every cache leaf), then three dense
    ``serve_step``s on the spliced cache beside a parked slot (logits of
    the live slot and the whole cache)."""
    cfg, jm, jp, tm, tp = _models()
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (1, 13))
    frames = _frames(cfg, 1, seed=3)
    batch = {"tokens": toks, "encoder_frames": frames}
    if bucketed:
        batch = {"tokens": np.pad(toks, ((0, 0), (0, 3))),
                 "length": np.asarray([13], np.int32),
                 "encoder_frames": frames}
    jl, jc = jm.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tc = tm.prefill(tp, {k: _t(v) for k, v in batch.items()})
    _hold_logits(tl, jl)
    _hold_cache(jc, tc)
    Sa = 32
    jcache = JEngine._splice_cache(
        {n: (jnp.full(s.shape, -1, s.dtype) if n == "pos_map"
             else jnp.zeros(s.shape, s.dtype))
         for n, s in jm.abstract_cache(2, Sa).items()}, 0, jc)
    tcache = ServingEngine._splice_cache(
        {n: (torch.full(s.shape, -1, dtype=s.dtype) if n == "pos_map"
             else torch.zeros(s.shape, dtype=s.dtype))
         for n, s in tm.abstract_cache(2, Sa).items()}, 0, tc)
    _hold_cache(jcache, tcache)
    tok = int(np.argmax(np.asarray(jl)[0]))
    for t in range(3):
        step = {"tokens": np.asarray([tok, 0]),
                "pos": np.asarray([13 + t, Sa], np.int32)}
        jl, jcache = jm.serve_step(jp, jcache, {
            k: jnp.asarray(v, jnp.int32) for k, v in step.items()})
        tl, tcache = tm.serve_step(tp, tcache,
                                   {k: _t(v) for k, v in step.items()})
        _hold_logits(tl[0], np.asarray(jl)[0])
        _hold_cache(dict(jcache), tcache)
        tok = int(np.argmax(np.asarray(jl)[0]))


def test_prefill_refusals_match_jax(need_jax):
    """No ``encoder_frames``: KeyError in both packages; embedding spans:
    the JAX package's ValueError; the family's capabilities (dense only,
    bucketed, not chunked)."""
    cfg, jm, jp, tm, tp = _models()
    toks = np.zeros((1, 8), np.int64)
    with pytest.raises(KeyError):
        jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    with pytest.raises(KeyError, match="encoder_frames"):
        tm.prefill(tp, {"tokens": _t(toks)})
    extra = {"embeds": np.zeros((1, 8, cfg.d_model), np.float32),
             "embed_mask": np.zeros((1, 8), bool),
             "encoder_frames": _frames(cfg, 1, seed=4)}
    with pytest.raises(ValueError, match="embedding-span"):
        jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32),
                        **{k: jnp.asarray(v) for k, v in extra.items()}})
    with pytest.raises(ValueError, match="embedding-span"):
        tm.prefill(tp, {"tokens": _t(toks),
                        **{k: _t(v) for k, v in extra.items()}})
    for name, want in (("supports_paged", False),
                       ("supports_embed_spans", False),
                       ("supports_bucketed_prefill", True),
                       ("supports_chunked_prefill", False)):
        assert getattr(tm, name) is want and getattr(jm, name) is want


# --------------------------------------------------------------- engines


PROMPT_LENGTHS = (1, 5, 16, 17, 30, 9)


def _serve(engine_cls, request_cls, model, params, prompts, frames, wrap,
           new=6, **kw):
    eng = engine_cls(model, params, **{**dict(max_batch=3, max_seq=64),
                                       **kw})
    reqs = [request_cls(i, p, max_new_tokens=new,
                        extra={"encoder_frames": wrap(f)})
            for i, (p, f) in enumerate(zip(prompts, frames))]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return eng, [tuple(r.output) for r in reqs]


def test_engine_matches_jax(need_jax):
    """Prompts of 1-30 tokens (buckets 16 and 32), each with its own
    frames [1, Se, d], through the engine on the dense backend with
    bucketed monolithic prefill; the same greedy tokens and counters as
    the JAX engine."""
    cfg, jm, jp, tm, tp = _models()
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in PROMPT_LENGTHS]
    frames = [_frames(cfg, 1, seed=10 + i) for i in range(len(prompts))]
    jeng, want = _serve(JEngine, JRequest, jm, jp, prompts, frames,
                        jnp.asarray)
    eng, got = _serve(ServingEngine, Request, tm, tp, prompts, frames,
                      lambda f: f, device="cpu")
    assert got == want
    js, ts = jeng.stats(), eng.stats()
    for key in ("paged", "chunked", "bucketed", "decode_tokens",
                "prefill_tokens_computed", "prefill_tokens_padded"):
        assert ts[key] == js[key], key
    assert ts["paged"] is False and ts["bucketed"] is True
    assert ts["prefills"] == len(prompts) and ts["prefill_chunks"] == 0


def test_engine_refusals_match_jax(need_jax):
    """A request without frames fails its admission with KeyError in both
    engines; the paged backend and an int8 cache are refused with
    ValueError by both."""
    cfg, jm, jp, tm, tp = _models()
    for eng, req_cls in ((JEngine(jm, jp, max_batch=2, max_seq=64),
                          JRequest),
                         (ServingEngine(tm, tp, max_batch=2, max_seq=64,
                                        device="cpu"), Request)):
        eng.submit(req_cls(0, np.arange(5, dtype=np.int32),
                           max_new_tokens=3))
        with pytest.raises(KeyError):
            eng.run_until_drained()
    for kw in (dict(paged=True), dict(paged=False, kv_dtype="int8")):
        with pytest.raises(ValueError):
            JEngine(jm, jp, max_batch=2, max_seq=64, **kw)
        with pytest.raises(ValueError):
            ServingEngine(tm, tp, max_batch=2, max_seq=64, device="cpu",
                          **kw)


# ------------------------------------------------ the kernels on the card


# whisper-large-v3: 20 heads of 64; the encoder's 1500 frames attend to
# each other, the decoder's prompt (1, 33, 64 tokens) to its own causal
# prefix and to every frame
GPU_FLASH_CASES = [(1, 1500, 1500, 20, 20, 64, False),
                   (1, 1, 1500, 20, 20, 64, False),
                   (1, 33, 1500, 20, 20, 64, False),
                   (1, 64, 1500, 20, 20, 64, False),
                   (1, 64, 64, 20, 20, 64, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal", GPU_FLASH_CASES)
def test_flash_attention_kernel_at_whisper_shapes(cuda, B, Sq, Sk, H, Hkv,
                                                  D, causal, dtype):
    from test_torch_multimodal import (EXACT_TOL, TOL, _flash_inputs,
                                       _widened)
    tdt = getattr(torch, dtype)
    args = [_t(a, tdt, cuda) for a in _flash_inputs(B, Sq, Sk, H, Hkv, D,
                                                   seed=6)]
    before = ops.flash_attention.launches
    out = ops.flash_attention(*args, causal=causal)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    want = flash_attention_ref(*_widened(args), causal=causal)
    np.testing.assert_allclose(_np(out), _np(want), **EXACT_TOL[dtype])
    same = flash_attention_ref(*args, causal=causal)
    np.testing.assert_allclose(_np(out), _np(same), **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,cross", [(1500, True), (448, False)])
def test_flash_decode_kernel_at_whisper_shapes(cuda, S, cross, q_dtype):
    """bf16 caches of 8 slots, 20 heads of 64: the cross K/V's 1500
    frames, every one visible (positions 0..1499, the query at 1500), and
    the decoder's 448-entry self-attention cache with ragged contexts and
    a parked slot."""
    from test_torch_dense import (KERNEL_TOL, _decode_inputs,
                                  _hold_dead_rows, _rows_with_keys)
    from test_torch_kernels import hold_rounded
    q, kc, vc, cpos, pos = _decode_inputs(8, S, 20, 20, 64, not cross,
                                          seed=7, parked=(7,))
    if cross:
        pos[:] = S
    qdt = getattr(torch, q_dtype)
    args = [_t(a, d, cuda) for a, d in ((q, qdt), (kc, torch.bfloat16),
                                        (vc, torch.bfloat16), (cpos, None),
                                        (pos, None))]
    before = ops.flash_decode.launches
    out = ops.flash_decode(*args)
    torch.cuda.synchronize()
    assert ops.flash_decode.launches == before + 1
    rows = _rows_with_keys(cpos, pos, 0)
    assert rows.all() or not cross
    hold_rounded(out, flash_decode_ref, args, {}, rows)
    _hold_dead_rows(out, flash_decode_ref, args, ~rows, {}, q_dtype)
    np.testing.assert_allclose(_np(out)[rows],
                               _np(flash_decode_ref(*args))[rows],
                               **KERNEL_TOL["bfloat16"])
