"""Port of the multimodal request path against the JAX package: the plain
fused-RMSNorm and flash-attention versions held to the JAX kernels
(interpret mode) on ``tests/test_kernels.py``'s sweeps; the edge encoder
(``models/mm_encoder.py``) from carried-over JAX params held to
``repro.models.mm_encoder``; the embedding-span engine held to the JAX
engine (bf16 and int8 pools, speculation on and off, prefix reuse of a
repeated image); ports of ``tests/test_multimodal.py``'s engine and
encoder tests; and, on a CUDA card only, both kernels held to their plain
versions.

Inputs are made with numpy from a seed and handed to both packages.  The
JAX side runs on the CPU on any host (the ``need_jax`` fixture pins it
there): JAX on a GPU computes fp32 products at a lower default precision
than these tolerances allow for.

Tolerances (each with its reason):
* plain versions vs the JAX kernels and oracles: ``tests/test_kernels.py``'s
  ``_tol``, 2e-4 fp32 and 5e-2 bf16 (summation order; a bf16 output may
  round the other way);
* the encoder's features: 1e-4 absolute on rows of RMS ~1 (the trunk ends
  in an RMS norm with unit scale): two layers of fp32 matmuls summed in
  other orders; the keep-top-k positions must be identical;
* the CUDA kernels vs their plain versions on the same values widened to
  fp32: summation order and the kernel's final rounding to x's / q's type
  only (EXACT_TOL, as ``tests/test_torch_kernels.py``), and in the working
  type ``_tol``.
"""
import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.data import taskgen as jtaskgen
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.models import build_model as jbuild
    from repro.models import mm_encoder as jenc
    from repro.models.attention import flash_attention as jflash
    from repro.serving.engine import Request as JRequest
    from repro.serving.engine import ServingEngine as JEngine
    from repro.serving.segments import EmbedSegment as JEmbed
    from repro.serving.segments import TextSegment as JText
except ImportError:  # JAX (the reference) is not installed
    jax = None

from repro_torch.configs import get_config, reduced
from repro_torch.data.taskgen import make_taskset
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.rmsnorm import rmsnorm_ref
from repro_torch.models import lm
from repro_torch.models import mm_encoder as enc
from repro_torch.models.api import build_model
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.segments import EmbedSegment, TextSegment
from repro_torch.weights import from_jax_params

TOL = {"float32": dict(atol=2e-4, rtol=2e-4),
       "bfloat16": dict(atol=5e-2, rtol=5e-2)}
EXACT_TOL = {"float32": dict(atol=1e-5, rtol=1e-4),
             "bfloat16": dict(atol=1e-5, rtol=2 ** -7)}
ENC_TOL = dict(atol=1e-4, rtol=0)

RMS_SHAPES = [(3, 50, 96), (7, 128), (260, 64)]  # test_kernels.py
# (B, Sq, Sk, H, Hkv, D, causal, window): test_kernels.py's sweep plus the
# encoder's non-causal two-head shape at qwen2-0.5b's width (D 448)
FLASH_CASES = [
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 128, 128, 4, 4, 32, True, 48),
    (2, 64, 192, 2, 1, 64, True, 0),
    (2, 96, 160, 2, 2, 64, False, 0),
    (1, 100, 100, 4, 2, 32, True, 0),
    (2, 40, 40, 2, 2, 448, False, 0),
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


def _t(a, dtype=None, device="cpu"):
    t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def _np(x):
    return np.asarray(x.float().cpu() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32), np.float32)


def _flash_inputs(B, Sq, Sk, H, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, D)).astype(np.float32),
            rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32),
            rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32))


# --------------------------------------------- plain versions vs the JAX


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("zero_centered", [False, True])
@pytest.mark.parametrize("shape", RMS_SHAPES)
def test_rmsnorm_plain_matches_jax(need_jax, shape, zero_centered, dtype):
    rng = np.random.default_rng(42)
    x = rng.normal(size=shape).astype(np.float32)
    s = rng.normal(size=shape[-1:]).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    out = ops.rmsnorm(_t(x, tdt), _t(s), zero_centered=zero_centered)
    assert out.dtype == tdt and out.shape == shape
    kern = jops.rmsnorm(jnp.asarray(x, jdt), jnp.asarray(s),
                        zero_centered=zero_centered, block_t=16)
    np.testing.assert_allclose(_np(out), _np(kern), **TOL[dtype])
    want = jref.rmsnorm_ref(jnp.asarray(x, jdt), jnp.asarray(s),
                            zero_centered=zero_centered)
    np.testing.assert_allclose(_np(out), _np(want), **TOL[dtype])


def test_rmsnorm_plain_takes_bf16_scales(need_jax):
    """LM params are bf16 at full width: the scale is widened to fp32."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 96)).astype(np.float32)
    s = rng.normal(size=(96,)).astype(np.float32)
    out = ops.rmsnorm(_t(x, torch.bfloat16), _t(s, torch.bfloat16),
                      zero_centered=True)
    want = jref.rmsnorm_ref(jnp.asarray(x, jnp.bfloat16),
                            jnp.asarray(s, jnp.bfloat16), zero_centered=True)
    np.testing.assert_allclose(_np(out), _np(want), **TOL["bfloat16"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal,window", FLASH_CASES)
def test_flash_attention_plain_matches_jax(need_jax, B, Sq, Sk, H, Hkv, D,
                                           causal, window, dtype):
    q, k, v = _flash_inputs(B, Sq, Sk, H, Hkv, D, seed=42)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    out = ops.flash_attention(_t(q, tdt), _t(k, tdt), _t(v, tdt),
                              causal=causal, window=window)
    assert out.dtype == tdt and out.shape == (B, Sq, H, D)
    jargs = [jnp.asarray(a, jdt) for a in (q, k, v)]
    kern = jops.flash_attention(*jargs, causal=causal, window=window,
                                block_q=64, block_k=64)
    np.testing.assert_allclose(_np(out), _np(kern), **TOL[dtype])
    want = jref.flash_attention_ref(*jargs, causal=causal, window=window)
    np.testing.assert_allclose(_np(out), _np(want), **TOL[dtype])


@pytest.mark.parametrize("q_offset,window", [(0, 0), (24, 0), (40, 16)])
def test_flash_attention_plain_q_offset_matches_jax(need_jax, q_offset,
                                                    window):
    """An explicit query offset, as the JAX blocked path takes it."""
    q, k, v = _flash_inputs(2, 24, 64, 4, 2, 32, seed=3)
    out = ops.flash_attention(_t(q), _t(k), _t(v), window=window,
                              q_offset=q_offset)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  window=window, q_offset=q_offset, chunk_q=16, chunk_k=16)
    np.testing.assert_allclose(_np(out), _np(want), **TOL["float32"])


def test_wrappers_run_plain_versions_on_cpu_only():
    q, k, v = (_t(a) for a in _flash_inputs(1, 20, 20, 4, 2, 32, seed=0))
    x, s = q.reshape(-1, 32), torch.linspace(0.5, 1.5, 32)
    before = (ops.flash_attention.launches, ops.rmsnorm.launches)
    assert torch.equal(ops.flash_attention(q, k, v, causal=False),
                       flash_attention_ref(q, k, v, causal=False))
    assert torch.equal(ops.rmsnorm(x, s), rmsnorm_ref(x, s))
    # the LM's norms are the wrapper's plain version on the CPU
    assert torch.equal(lm._norm({"ln1_s": s}, x, "rmsnorm_zero", "ln1"),
                       rmsnorm_ref(x, s, zero_centered=True))
    assert (ops.flash_attention.launches, ops.rmsnorm.launches) == before
    with pytest.raises(ValueError):
        ops.flash_attention(q, k.to("meta"), v)
    with pytest.raises(ValueError):
        ops.rmsnorm(x, s.to("meta"))


# --------------------------------------------------------- the encoder


def _encoders(d_model=32, keep_ratio=0.5, n_layers=2):
    """The JAX encoder's config and params, and the port's, carried over.
    The final norm's scale is drawn from N(1, 0.5^2): at the init's unit
    scale every encoded row has an L2 norm of sqrt(d) up to eps and
    rounding, so keep-top-k would rank the rows by rounding noise, which
    no two packages share (a trained scale is not uniform)."""
    cfg = jenc.MMEncoderConfig(d_model=d_model, img_size=32, patch=8,
                               audio_dim=8, n_layers=n_layers, n_heads=2,
                               d_ff=64, keep_ratio=keep_ratio)
    jp = jenc.init_mm_encoder(cfg, jax.random.PRNGKey(1))
    scale = np.random.default_rng(4).normal(1.0, 0.5, d_model)
    jp["final"]["scale"] = jnp.asarray(scale, jnp.float32)
    tcfg = enc.MMEncoderConfig(d_model=d_model, img_size=32, patch=8,
                               audio_dim=8, n_layers=n_layers, n_heads=2,
                               d_ff=64, keep_ratio=keep_ratio)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tcfg, tp


def test_encoder_params_carry_over(need_jax):
    """``from_jax_params`` carries the encoder's tree, layer-stacked
    blocks included, onto the port's spec: same keys, shapes and values."""
    cfg, jp, tcfg, tp = _encoders()
    spec = enc.mm_encoder_spec(tcfg)

    def walk(s, j, t, path=""):
        if isinstance(s, dict):
            assert set(s) == set(j) == set(t), path
            for key in s:
                walk(s[key], j[key], t[key], f"{path}/{key}")
            return
        assert tuple(t.shape) == tuple(s.shape) == tuple(j.shape), path
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), path)

    walk(spec, jp, tp)
    assert tp["blocks"]["wq"]["w"].shape == (2, 32, 32)
    ported = enc.init_mm_encoder(tcfg, seed=1, device="cpu")
    assert jax.tree.structure(jax.tree.map(np.asarray, jp)) \
        == jax.tree.structure(jax.tree.map(lambda t: t.numpy(), ported))


@pytest.mark.parametrize("modality", ["image", "audio"])
def test_encoder_matches_jax(need_jax, modality):
    cfg, jp, tcfg, tp = _encoders(d_model=64)
    tasks = make_taskset(n=8, seed=0)
    if modality == "image":
        media = tasks.images(range(3), 32)  # [3, 32, 32, 3]
        proj = "patch_proj"
        p = cfg.patch
        flat = media.reshape(3, 4, p, 4, p, 3).transpose(0, 1, 3, 2, 4, 5)
        flat = flat.reshape(3, 16, -1)
        want = jenc.encode_image(cfg, jp, jnp.asarray(media))
        got = enc.encode_image(tcfg, tp, _t(media))
    else:
        media = np.stack([tasks.audio(i, 10, 8) for i in range(3)])
        proj, flat = "audio_proj", media
        want = jenc.encode_audio(cfg, jp, jnp.asarray(media))
        got = enc.encode_audio(tcfg, tp, _t(media))
    assert got.shape == want.shape == (3, cfg.kept(flat.shape[1]), 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ENC_TOL)
    # the keep-top-k positions themselves, from each package's trunk
    jx = jenc._trunk(cfg, jp, jnp.asarray(flat) @ jp[proj]["w"]
                     + jp[proj]["b"])
    _, jidx = jax.lax.top_k(jnp.sqrt(jnp.sum(jnp.square(jx), -1)),
                            cfg.kept(flat.shape[1]))
    tx = enc._trunk(tcfg, tp, enc.apply_linear(tp[proj], _t(flat)))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **ENC_TOL)
    tidx = enc.top_k_positions(tx, tcfg.kept(flat.shape[1]))
    np.testing.assert_array_equal(tidx.numpy(), np.sort(np.asarray(jidx), -1))


def test_mm_encoder_shapes_and_keep_top_k():
    """Port of test_multimodal.py::test_mm_encoder_shapes_and_keep_top_k."""
    cfg = enc.MMEncoderConfig(d_model=32, img_size=32, patch=8, audio_dim=8,
                              n_layers=1, n_heads=2, d_ff=64, keep_ratio=0.5)
    params = enc.init_mm_encoder(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(2)
    img = _t(rng.random((2, 32, 32, 3)), torch.float32)
    f = enc.encode_image(cfg, params, img)
    assert f.shape == (2, 8, 32)  # 16 patches, keep 8
    assert torch.equal(f, enc.encode_image(cfg, params, img))  # determinism
    au = _t(rng.random((1, 10, 8)), torch.float32)
    assert enc.encode_audio(cfg, params, au).shape == (1, 5, 32)
    # keep_top_k keeps the highest-norm rows in original order
    x = torch.tensor([[[1.0, 0], [9, 0], [0, 0.5], [0, 4]]])
    np.testing.assert_array_equal(enc.keep_top_k(x, 2).numpy(),
                                  [[[9.0, 0], [0, 4]]])
    with pytest.raises(ValueError, match="max_span"):
        enc.encode_audio(cfg, params, torch.zeros(1, 300, 8))


def test_taskgen_copy_matches_reference(need_jax):
    """The port's numpy copy of taskgen gives the JAX package's media."""
    mine, ref = make_taskset(n=40, seed=3), jtaskgen.make_taskset(40, seed=3)
    for field in ("category", "difficulty", "text_len", "modality"):
        np.testing.assert_array_equal(getattr(mine, field),
                                      getattr(ref, field))
    np.testing.assert_array_equal(mine.images([0, 7], 16),
                                  ref.images([0, 7], 16))
    np.testing.assert_array_equal(mine.audio(5, 24, 16), ref.audio(5, 24, 16))


# ------------------------------------------------------------ the engine


def _reduced_qwen():
    model = build_model(reduced(get_config("qwen2-0.5b"),
                                act_dtype="float32"))
    params = model.init(0, param_dtype=torch.float32, device="cpu")
    return model, params


def _token_embeds(cfg, params, toks):
    """Host copy of the token-table rows a text span would embed to."""
    return lm.embed_tokens(cfg, params, _t(toks).long()).float().numpy()


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_embed_span_engine_parity(kv_dtype):
    """Port of test_multimodal.py::test_embed_span_engine_parity (paged):
    a leading span injected as the embeddings of the same tokens generates
    what the plain token request generates."""
    model, params = _reduced_qwen()
    cfg = model.cfg
    toks = np.random.default_rng(3).integers(0, cfg.vocab, 20)
    kw = dict(max_batch=2, max_seq=64, page_size=4, prefill_chunk=8,
              kv_dtype=kv_dtype, device="cpu")
    eng_t = ServingEngine(model, params, **kw)
    req_t = eng_t.submit(Request(0, toks.astype(np.int32), max_new_tokens=4))
    eng_t.run_until_drained()
    segs = [EmbedSegment(_token_embeds(cfg, params, toks[:9]),
                         modality="image"), TextSegment(toks[9:])]
    eng_e = ServingEngine(model, params, **kw)
    req_e = eng_e.submit(Request(1, segments=segs, max_new_tokens=4))
    eng_e.run_until_drained()
    assert req_e.output == req_t.output and len(req_e.output) == 4
    # chunks over media positions are their own shape bucket
    assert ("prefill_chunk", 8, True) in eng_e._traced


def test_engine_rejects_mismatched_feature_dim():
    model, params = _reduced_qwen()
    eng = ServingEngine(model, params, max_batch=1, max_seq=64,
                        device="cpu")
    bad = [EmbedSegment(np.zeros((3, model.cfg.d_model + 1), np.float32))]
    with pytest.raises(ValueError, match="d_model"):
        eng.submit(Request(0, segments=bad))


def test_prefix_cache_hit_repeated_image_segment():
    """Port of test_multimodal.py::test_prefix_cache_hit_repeated_image_
    segment: two requests with the same image share its KV pages; a
    different image misses."""
    model, params = _reduced_qwen()
    cfg = model.cfg
    rng = np.random.default_rng(9)
    img = rng.normal(size=(8, cfg.d_model)).astype(np.float32)
    tail1 = rng.integers(0, cfg.vocab, 6).astype(np.int32)
    tail2 = rng.integers(0, cfg.vocab, 9).astype(np.int32)
    eng = ServingEngine(model, params, max_batch=2, max_seq=64, page_size=4,
                        prefill_chunk=8, device="cpu")
    eng.submit(Request(0, segments=[EmbedSegment(img), TextSegment(tail1)],
                       max_new_tokens=3))
    eng.run_until_drained()
    assert eng.prefix_tokens_reused == 0
    eng.submit(Request(1, segments=[EmbedSegment(img.copy()),
                                    TextSegment(tail2)], max_new_tokens=3))
    eng.run_until_drained()
    # the image spans two full pages; both are served from the trie
    assert eng.prefix_tokens_reused == 8
    assert eng.pool.hits >= 2
    hits_before = eng.pool.hits
    other = rng.normal(size=(8, cfg.d_model)).astype(np.float32)
    eng.submit(Request(2, segments=[EmbedSegment(other), TextSegment(tail1)],
                       max_new_tokens=3))
    eng.run_until_drained()
    assert eng.pool.hits == hits_before  # different image: no reuse


MM_STATS = ("prefix_hits", "prefix_tokens_reused", "prefill_tokens_computed",
            "prefill_tokens_padded", "cow_copies", "pages_in_use",
            "decode_tokens")
SPEC_STATS = ("spec_tokens_drafted", "spec_tokens_accepted",
              "spec_tokens_wasted")


def _mm_requests(cfg, img_feats, au_feats, seg_types, req_type):
    """Four requests of text head + media span + text tail; the first and
    the last carry the same head and image (admitted after the first is
    prefilled, the last reuses its pages)."""
    Text, Embed = seg_types
    rng = np.random.default_rng(11)
    heads = [rng.integers(0, cfg.vocab, n).astype(np.int32)
             for n in (5, 3, 6)]
    tails = [rng.integers(0, cfg.vocab, n).astype(np.int32)
             for n in (7, 12, 4, 9)]
    media = [(img_feats[0], "image"), (au_feats[0], "audio"),
             (img_feats[1], "image"), (img_feats[0].copy(), "image")]
    reqs = []
    for i, ((f, mod), tail) in enumerate(zip(media, tails)):
        segs = [Text(heads[i % 3] if i < 3 else heads[0]),
                Embed(f, modality=mod), Text(tail)]
        reqs.append(req_type(i, segments=segs, max_new_tokens=6))
    return reqs


@pytest.mark.parametrize("spec", [False, True])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_mm_engine_matches_jax(need_jax, kv_dtype, spec):
    """Reduced qwen2 in fp32, features from the JAX encoder: the port's
    engine gives the JAX engine's tokens and page stats (prefix reuse of
    the repeated image included), with speculation (self-draft, spec_k=3)
    and without; int8 is held to the JAX int8 engine only."""
    jcfg = jreduced(jget_config("qwen2-0.5b"), act_dtype="float32")
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0), param_dtype=jnp.float32)
    tm = build_model(reduced(get_config("qwen2-0.5b"), act_dtype="float32"))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    ecfg, ejp, _, _ = _encoders(d_model=jcfg.d_model, keep_ratio=0.5,
                                n_layers=1)
    tasks = make_taskset(n=8, seed=0)
    img = np.asarray(jenc.encode_image(ecfg, ejp,
                                       jnp.asarray(tasks.images([0, 1], 32))))
    au = np.asarray(jenc.encode_audio(
        ecfg, ejp, jnp.asarray(tasks.audio(2, 10, 8)[None])))
    kw = dict(max_batch=2, max_seq=64, page_size=4, prefill_chunk=8,
              kv_dtype=kv_dtype)
    jkw, tkw = dict(kw), dict(kw, device="cpu")
    if spec:
        jkw.update(draft_config=jcfg, draft_params=jp, spec_k=3)
        tkw.update(draft_config=tm.cfg, draft_params=tp, spec_k=3)
    runs = []
    for eng_cls, req_cls, segs, model, params, ekw in (
            (JEngine, JRequest, (JText, JEmbed), jm, jp, jkw),
            (ServingEngine, Request, (TextSegment, EmbedSegment), tm, tp,
             tkw)):
        eng = eng_cls(model, params, **ekw)
        reqs = _mm_requests(jcfg, img, au, segs, req_cls)
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        runs.append((eng.stats(), [tuple(r.output) for r in reqs]))
    (js, want), (ts, got) = runs
    assert got == want
    assert all(len(o) == 6 for o in got)
    keys = MM_STATS + (SPEC_STATS if spec else ())
    assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
    # the repeated head + image: 5 + 8 = 13 positions, 3 full pages of 4
    assert ts["prefix_tokens_reused"] == 12 and ts["prefix_hits"] >= 3
    if spec:
        assert ts["draft_prefills"] == 4 and ts["verify_steps"] > 0


# -------------------------------------------- CUDA kernels vs plain (card)


def _widened(args):
    return [t.float() if t.is_floating_point() else t for t in args]


GPU_FLASH_CASES = FLASH_CASES + [
    (1, 1024, 1024, 14, 2, 64, True, 0),   # qwen2-0.5b draft prefill
    (3, 16, 16, 14, 2, 64, True, 0),       # the smallest prompt bucket
    (1, 600, 600, 4, 1, 256, True, 512),   # gemma3-1b local layers
    (1, 256, 256, 24, 8, 128, True, 0),    # llama3.2-3b
    (2, 256, 256, 2, 2, 448, False, 0),    # encoder, 128x128 image
    (2, 48, 48, 4, 2, 16, True, 0),        # reduced configs
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal,window", GPU_FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda, B, Sq, Sk, H, Hkv, D,
                                              causal, window, dtype):
    tdt = getattr(torch, dtype)
    args = [_t(a, tdt, cuda) for a in _flash_inputs(B, Sq, Sk, H, Hkv, D,
                                                   seed=5)]
    before = ops.flash_attention.launches
    out = ops.flash_attention(*args, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    assert out.dtype == tdt and out.shape == (B, Sq, H, D)
    want = flash_attention_ref(*_widened(args), causal=causal,
                               window=window)
    np.testing.assert_allclose(_np(out), _np(want), **EXACT_TOL[dtype])
    same = flash_attention_ref(*args, causal=causal, window=window)
    np.testing.assert_allclose(_np(out), _np(same), **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("zero_centered", [False, True])
@pytest.mark.parametrize("shape", RMS_SHAPES + [(8, 896), (64, 896),
                                                (5, 3, 14, 64)])
def test_rmsnorm_kernel_matches_plain(cuda, shape, zero_centered, dtype,
                                      scale_dtype):
    rng = np.random.default_rng(7)
    x = _t(rng.normal(size=shape), getattr(torch, dtype), cuda)
    s = _t(rng.normal(size=shape[-1:]), getattr(torch, scale_dtype), cuda)
    before = ops.rmsnorm.launches
    out = ops.rmsnorm(x, s, zero_centered=zero_centered)
    torch.cuda.synchronize()
    assert ops.rmsnorm.launches == before + 1
    assert out.dtype == x.dtype and out.shape == x.shape
    want = rmsnorm_ref(x.float(), s.float(), zero_centered=zero_centered)
    np.testing.assert_allclose(_np(out), _np(want), **EXACT_TOL[dtype])
    same = rmsnorm_ref(x, s, zero_centered=zero_centered)
    np.testing.assert_allclose(_np(out), _np(same), **TOL[dtype])


@pytest.mark.gpu
def test_kernels_reject_what_they_cannot_take(cuda):
    q, k, v = (_t(a, torch.bfloat16, cuda)
               for a in _flash_inputs(1, 32, 32, 4, 2, 64, seed=0))
    with pytest.raises(ValueError):  # head dim 48 is not supported
        ops.flash_attention(q[..., :48].contiguous(),
                            k[..., :48].contiguous(),
                            v[..., :48].contiguous())
    with pytest.raises(ValueError):  # mixed types
        ops.flash_attention(q, k.float(), v)
    with pytest.raises(ValueError):  # fp16
        ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):  # not contiguous
        ops.flash_attention(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError):  # H not a multiple of Hkv
        ops.flash_attention(q[:, :, :3].contiguous(), k, v)
    ops.flash_attention(q, k, v)  # and the plain call runs
    x = q.reshape(-1, 64)
    with pytest.raises(ValueError):  # fp16
        ops.rmsnorm(x.half(), torch.ones(64, device=cuda))
    with pytest.raises(ValueError):  # scale of the wrong length
        ops.rmsnorm(x, torch.ones(32, device=cuda))
    with pytest.raises(ValueError):  # not contiguous
        ops.rmsnorm(x.t(), torch.ones(x.shape[0], device=cuda))
    with pytest.raises(ValueError):  # rows of 17 fill no whole 16-byte vector
        ops.rmsnorm(torch.ones(4, 17, device=cuda),
                    torch.ones(17, device=cuda))
    with pytest.raises(ValueError):  # rows that start off a 16-byte boundary
        ops.rmsnorm(x.reshape(-1)[1:65], torch.ones(64, device=cuda))
    ops.rmsnorm(x, torch.ones(64, device=cuda))


@pytest.mark.gpu
def test_encoder_on_the_card_matches_the_cpu(cuda):
    """The encoder through both kernels (fp32, TF32 off) gives the CPU's
    features and the same kept positions."""
    cfg = enc.MMEncoderConfig(d_model=896, keep_ratio=1 / 3)
    params = enc.init_mm_encoder(cfg, seed=17, device="cpu")
    # a non-uniform final scale, so keep-top-k ranks rows by more than
    # rounding (see _encoders)
    params["final"]["scale"] = _t(np.random.default_rng(4).normal(
        1.0, 0.5, 896), torch.float32)
    gparams = _on(params, cuda)
    images = make_taskset(n=8, seed=0).images(range(2), 128)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        before = (ops.flash_attention.launches, ops.rmsnorm.launches)
        got = enc.encode_image(cfg, gparams, _t(images, None, cuda))
        torch.cuda.synchronize()
        assert (ops.flash_attention.launches - before[0],
                ops.rmsnorm.launches - before[1]) == (2, 5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    want = enc.encode_image(cfg, params, _t(images))
    assert got.shape == want.shape == (2, 86, 896)
    np.testing.assert_allclose(_np(got), _np(want), **ENC_TOL)


def _on(tree, device):
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    return tree.to(device)
