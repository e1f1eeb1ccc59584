"""Port of the zamba2 hybrid family against the JAX package: the plain SSD
scan held to the JAX Pallas kernel (interpret mode) and to ``ssd_chunked``
and ``ssd_reference`` (y and the final state, with and without an initial
state); ``mamba2_forward`` and ``mamba2_decode``; ``Model.prefill`` and
the dense ``serve_step`` of reduced zamba2-2.7b on the same fp32 weights
(``from_jax_params``); and the serving engine on the dense backend with
exact-shape monolithic prefill against the JAX engine's
``Request.output``, prompts over several scan chunks, a 1-token prompt
and the refusals (the paged backend, embedding spans, bucketed prefill,
a prompt past ``scan_chunk`` that is not a multiple of it, and a 2-token
prompt, whose conv window does not broadcast into the cache in either
package).  Also: the full-width spec against the JAX package's, and the
CPU seeded init, unchanged by the init drawn on the card.  On a CUDA card
only: the hand-written SSD-scan kernel held to its plain version (y and
the final state) at the CPU sweep and at zamba2-2.7b's width; the
flash-attention and flash-decode kernels at the shared block's head dim
80; the init drawn on the card.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs on the CPU on any host (``need_jax``).

Tolerances (each with its reason):
* plain scan vs the Pallas kernel: test_kernels.py::test_ssd_scan's 5e-4
  (the kernel's own tolerance against its oracle); vs ``ssd_chunked``
  and ``ssd_reference``: 1e-4 absolute and relative on y and the state
  (the same fp32 products summed in other orders over at most 128
  tokens, values of magnitude ~1-10);
* ``mamba2_forward``/``mamba2_decode`` and the model steps in fp32: 1e-4
  (fp32 matmuls, cumulative sums and exponentials in other orders, over
  at most four layers; the differences measured are ~5e-6);
* engines: identical greedy tokens;
* the CUDA scan vs its plain version on the card: against the plain
  version on the values widened to fp32, 1e-4 relative plus 1e-4 times
  the RMS of the compared tensor (sums of up to 256 products in another
  order; a wrong mask, decay or chunk boundary moves outputs by far more);
  the bf16 inputs are the same numbers to both, and both compute in fp32;
* flash attention and flash decode at D 80: test_torch_multimodal.py's
  and test_torch_dense.py's tolerances, for the reasons stated there.
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
    from repro.kernels import ops as jops
    from repro.models import build_model as jbuild
    from repro.models import mamba2 as jm2
    from repro.serving.engine import Request as JRequest
    from repro.serving.engine import ServingEngine as JEngine
except ImportError:  # JAX (the reference) is not installed
    jax = None

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.flash_decode import flash_decode_ref
from repro_torch.kernels.ssd_scan import ssd_scan_ref
from repro_torch.models import lm
from repro_torch.models import mamba2 as m2
from repro_torch.models.api import build_model
from repro_torch.nn import spec as spec_lib
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.weights import from_jax_params

ARCH = "zamba2-2.7b"
# test_kernels.py::test_ssd_scan's sweep: (b, S, h, p, n) x chunk
SCAN_CASES = [(2, 64, 4, 16, 8), (1, 128, 2, 32, 16)]
SCAN_TOL = dict(atol=1e-4, rtol=1e-4)
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


def _scan_inputs(b, S, h, p, n, seed=0, init=False):
    """x, dt (0.1-0.9), a_neg (-1 to -0.1), B, C and, with ``init``, an
    initial state, as test_kernels.py::test_ssd_scan draws them."""
    rng = np.random.default_rng(seed)
    out = [rng.normal(size=(b, S, h, p)), rng.uniform(0.1, 0.9, (b, S, h)),
           -rng.uniform(0.1, 1.0, (h,)), rng.normal(size=(b, S, n)),
           rng.normal(size=(b, S, n))]
    out.append(rng.normal(size=(b, h, p, n)) if init else None)
    return [None if a is None else a.astype(np.float32) for a in out]


# ----------------------------------------------------------- the SSD scan


@pytest.mark.parametrize("chunk", [16, 32, 64])
@pytest.mark.parametrize("b,S,h,p,n", SCAN_CASES)
def test_ssd_scan_plain_matches_jax(need_jax, b, S, h, p, n, chunk):
    """y against the Pallas kernel (interpret mode) and ``ssd_chunked``."""
    x, dt, a_neg, B, C, _ = _scan_inputs(b, S, h, p, n)
    y, state = ops.ssd_scan(_t(x), _t(dt), _t(a_neg), _t(B), _t(C),
                            chunk=chunk)
    assert y.dtype == torch.float32 and y.shape == (b, S, h, p)
    assert state.dtype == torch.float32 and state.shape == (b, h, p, n)
    jx = [jnp.asarray(a) for a in (x, dt, a_neg, B, C)]
    kern = jops.ssd_scan(*jx, chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(kern), atol=5e-4,
                               rtol=5e-4)
    jy, jstate = jm2.ssd_chunked(*jx, chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate),
                               **SCAN_TOL)


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("chunk", [16, 64])
def test_ssd_scan_state_matches_jax(need_jax, chunk, init):
    """y and the final state against ``ssd_chunked`` and the sequential
    ``ssd_reference``, from zeros or from a given state, in both packages'
    oracles."""
    x, dt, a_neg, B, C, s0 = _scan_inputs(2, 64, 4, 16, 8, seed=1,
                                          init=init)
    ts0 = None if s0 is None else _t(s0)
    y, state = ops.ssd_scan(_t(x), _t(dt), _t(a_neg), _t(B), _t(C),
                            chunk=chunk, init_state=ts0)
    jx = [jnp.asarray(a) for a in (x, dt, a_neg, B, C)]
    js0 = None if s0 is None else jnp.asarray(s0)
    for jy, jstate in (jm2.ssd_chunked(*jx, chunk=chunk, init_state=js0),
                       jm2.ssd_reference(*jx, init_state=js0)):
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SCAN_TOL)
        np.testing.assert_allclose(state.numpy(), np.asarray(jstate),
                                   **SCAN_TOL)
    ry, rstate = m2.ssd_reference(_t(x), _t(dt), _t(a_neg), _t(B), _t(C),
                                  init_state=ts0)
    np.testing.assert_allclose(y.numpy(), ry.numpy(), **SCAN_TOL)
    np.testing.assert_allclose(state.numpy(), rstate.numpy(), **SCAN_TOL)


def test_ssd_scan_chunk_rule_and_cpu_dispatch():
    """Q = min(chunk, S): a 40-token sequence runs as one chunk of 40
    under chunk 64 and is refused under chunk 16 with a ValueError that
    states the rule; bf16 inputs give fp32 y; the CPU runs the plain
    version and launches nothing."""
    x, dt, a_neg, B, C, _ = _scan_inputs(1, 40, 2, 16, 8)
    args = (_t(x), _t(dt), _t(a_neg), _t(B), _t(C))
    before = ops.ssd_scan.launches
    y, state = ops.ssd_scan(*args, chunk=64)
    ry, rstate = ssd_scan_ref(*args, chunk=40)
    assert torch.equal(y, ry) and torch.equal(state, rstate)
    with pytest.raises(ValueError, match="chunk=16"):
        ops.ssd_scan(*args, chunk=16)
    xb, Bb, Cb = (a.bfloat16() for a in (args[0], args[3], args[4]))
    yb, _ = ops.ssd_scan(xb, args[1], args[2], Bb, Cb, chunk=64)
    assert yb.dtype == torch.float32
    assert ops.ssd_scan.launches == before  # no kernel on the CPU
    with pytest.raises(ValueError):  # a tensor on no CPU or CUDA device
        ops.ssd_scan(args[0], args[1].to("meta"), *args[2:], chunk=64)


# --------------------------------------------------------------- mamba2


def _layer(seed=0, d=64, d_in=128, n=16, hd=16, W=4):
    """One Mamba2 layer's weights (numpy, fp32) at the spec's shapes and
    scales, with a_log, dt_bias, d_skip and the norms drawn around their
    init so that every term of the layer matters."""
    rng = np.random.default_rng(seed)
    spec = m2.mamba2_spec(1, d, d_in, n, hd, W)
    out = {}
    for k, s in spec.items():
        shape = s.shape[1:]
        if s.init == "normal":
            out[k] = rng.normal(size=shape) * s.scale
        else:
            out[k] = rng.normal(0.5 if s.init == "ones" else 0.0, 0.3,
                                shape)
    return {k: v.astype(np.float32) for k, v in out.items()}


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("S,chunk", [(48, 16), (40, 64), (1, 16)])
def test_mamba2_forward_matches_jax(need_jax, S, chunk, init):
    """A whole prompt (several chunks, one ragged chunk of 40, one token),
    from zeros or continuing a carried (conv, ssm) state: output and both
    states."""
    p = _layer()
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, S, 64)).astype(np.float32)
    carried = None
    if init:
        carried = (rng.normal(size=(2, 3, 160)).astype(np.float32),
                   rng.normal(size=(2, 8, 16, 16)).astype(np.float32))
    kw = dict(n_state=16, headdim=16, chunk=chunk)
    jy, (jconv, jssm) = jm2.mamba2_forward(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        init=None if carried is None else tuple(map(jnp.asarray, carried)),
        **kw)
    ty, (tconv, tssm) = m2.mamba2_forward(
        {k: _t(v) for k, v in p.items()}, _t(x),
        init=None if carried is None else tuple(map(_t, carried)), **kw)
    for got, want in ((ty, jy), (tconv, jconv), (tssm, jssm)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP_TOL)


def test_mamba2_decode_matches_jax(need_jax):
    """Five one-token steps from a carried state: output and states."""
    p = _layer(seed=3)
    rng = np.random.default_rng(4)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    conv = rng.normal(size=(3, 3, 160)).astype(np.float32)
    ssm = rng.normal(size=(3, 8, 16, 16)).astype(np.float32)
    jc, js, tc, ts = jnp.asarray(conv), jnp.asarray(ssm), _t(conv), _t(ssm)
    for _ in range(5):
        x = rng.normal(size=(3, 64)).astype(np.float32)
        jy, jc, js = jm2.mamba2_decode(jp, jnp.asarray(x), jc, js,
                                       n_state=16, headdim=16)
        ty, tc, ts = m2.mamba2_decode(tp, _t(x), tc, ts, n_state=16,
                                      headdim=16)
        for got, want in ((ty, jy), (tc, jc), (ts, js)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **STEP_TOL)


# ------------------------------------------------------------ model steps


@functools.cache
def _models(**over):
    over = dict(act_dtype="float32", **over)
    cfg = jreduced(jget_config(ARCH), **over)
    jm = jbuild(cfg)
    jp = jm.init(jax.random.PRNGKey(0), param_dtype=jnp.float32)
    tm = build_model(reduced(get_config(ARCH), **over))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jm, jp, tm, tp


def test_from_jax_params_carries_zamba2_tree(need_jax):
    """The nested (G, P, ...) Mamba2 leaves and the unstacked shared block
    come across with their keys, shapes and values; the port's spec has
    the same tree."""
    cfg, jm, jp, tm, tp = _models()
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat:
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert tp["mamba"]["in_proj"].shape == (2, 2, 64, 296)
    assert tp["shared_attn"]["attn"]["wq"].shape == (128, 64)
    specs = spec_lib.tree_map_specs(lambda path, s: s.shape, tm.spec)
    assert specs == jax.tree.map(lambda a: a.shape, jp)


def test_full_width_spec_matches_jax(need_jax):
    """zamba2-2.7b at full width: every leaf's shape as the JAX package's
    ``Model.abstract()``, 2.44 B parameters, the shared block's head dim
    80 (drawn nowhere: specs only)."""
    jabs = jbuild(jget_config(ARCH)).abstract()
    tm = build_model(get_config(ARCH))
    shapes = spec_lib.tree_map_specs(lambda path, s: s.shape, tm.spec)
    assert shapes == jax.tree.map(lambda a: a.shape, jabs)
    n = sum(int(np.prod(s)) for s in jax.tree.leaves(
        shapes, is_leaf=lambda s: isinstance(s, tuple)))
    assert 2.44e9 < n < 2.45e9
    assert tm.cfg.hd == 80 and lm.zamba2_groups(tm.cfg) == (9, 6)


def _hold_cache(jcache, tcache):
    """Dtypes equal; pos_map exactly; fp32 leaves within STEP_TOL; bf16
    leaves within one bf16 ulp of the larger value (fp32 values that
    differ in their last bits may round to neighbouring bf16 values).
    Where a leaf differs at all, the JAX values are copied into the
    port's, so that the next step starts from equal caches."""
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
            np.testing.assert_allclose(b, a, **STEP_TOL)
        if (a != b).any():
            got.copy_(torch.from_numpy(np.array(a)).to(got.dtype))


def test_prefill_and_decode_match_jax(need_jax):
    """``Model.prefill`` of a 48-token prompt over three scan chunks
    (logits and every cache leaf), then three dense ``serve_step``s on the
    spliced cache with a parked slot at pos = max_seq (logits of the live
    slot and the whole cache, whose conv leaf both packages return in the
    activation type)."""
    cfg, jm, jp, tm, tp = _models(scan_chunk=16)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (1, 48))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tc = tm.prefill(tp, {"tokens": _t(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **STEP_TOL)
    _hold_cache(jc, tc)
    Sa = 64
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
        batch = {"tokens": np.asarray([tok, 0]),
                 "pos": np.asarray([48 + t, Sa], np.int32)}
        jl, jcache = jm.serve_step(jp, jcache, {
            k: jnp.asarray(v, jnp.int32) for k, v in batch.items()})
        tl, tcache = tm.serve_step(tp, tcache,
                                   {k: _t(v) for k, v in batch.items()})
        np.testing.assert_allclose(tl.numpy()[0], np.asarray(jl)[0],
                                   **STEP_TOL)
        _hold_cache(jcache, tcache)
        tok = int(np.argmax(np.asarray(jl)[0]))


def test_prefill_refusals_match_jax(need_jax):
    """What zamba2's prefill refuses in both packages: a bucketed
    (``length``) batch and embedding spans, each with the JAX package's
    ValueError; a 300-token prompt with scan_chunk 256, which the JAX scan
    fails with an AssertionError and the port with a ValueError naming
    the rule; the family's capabilities."""
    cfg, jm, jp, tm, tp = _models()
    toks = np.zeros((1, 8), np.int64)
    length = np.asarray([6], np.int32)
    feats = np.zeros((1, 8, cfg.d_model), np.float32)
    mask = np.zeros((1, 8), bool)
    for extra, match in (({"length": length}, "bucketed"),
                         ({"embeds": feats, "embed_mask": mask},
                          "embedding-span")):
        with pytest.raises(ValueError, match=match):
            jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32),
                            **{k: jnp.asarray(v) for k, v in extra.items()}})
        with pytest.raises(ValueError, match=match):
            tm.prefill(tp, {"tokens": _t(toks),
                            **{k: _t(v) for k, v in extra.items()}})
    long = np.zeros((1, 300), np.int64)
    with pytest.raises(AssertionError):
        jm.prefill(jp, {"tokens": jnp.asarray(long, jnp.int32)})
    with pytest.raises(ValueError, match="multiple of it"):
        tm.prefill(tp, {"tokens": _t(long)})
    for name in ("supports_paged", "supports_embed_spans",
                 "supports_bucketed_prefill", "supports_chunked_prefill"):
        assert getattr(tm, name) is False and getattr(jm, name) is False


# --------------------------------------------------------------- engines


def _serve(engine_cls, request_cls, model, params, prompts, new=6, **kw):
    eng = engine_cls(model, params, **{**dict(max_batch=3, max_seq=96),
                                       **kw})
    reqs = [request_cls(i, p, max_new_tokens=new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return eng, [tuple(r.output) for r in reqs]


@pytest.mark.parametrize("kw", [
    {},  # paged=None: the dense backend, as the JAX engine chooses
    dict(paged=False, prefill_chunk=16, max_batch=2),  # chunking is off
])
def test_engine_matches_jax(need_jax, kw):
    """scan_chunk 16: prompts of 1 token (its conv row broadcast into the
    window), 7, 16, 32 and 48 tokens (three chunks) through the engine on
    the dense backend with exact-shape monolithic prefill; the same
    greedy tokens and counters as the JAX engine."""
    cfg, jm, jp, tm, tp = _models(scan_chunk=16)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (1, 7, 32, 48, 16, 7)]
    jeng, want = _serve(JEngine, JRequest, jm, jp, prompts, **kw)
    eng, got = _serve(ServingEngine, Request, tm, tp, prompts,
                      device="cpu", **kw)
    assert got == want
    js, ts = jeng.stats(), eng.stats()
    assert ts["paged"] is False and ts["chunked"] is False
    assert ts["bucketed"] is False
    for key in ("paged", "chunked", "bucketed", "decode_tokens",
                "prefill_tokens_computed", "prefill_tokens_padded"):
        assert ts[key] == js[key], key
    assert ts["prefills"] == len(prompts) and ts["prefill_chunks"] == 0


def test_engine_short_prompts_match_jax(need_jax):
    """A 1-token prompt's conv row fills all three rows of its slot's
    window in both packages; a 2-token prompt's two rows broadcast into
    none, and both engines raise ValueError at its admission."""
    cfg, jm, jp, tm, tp = _models()
    one = [np.asarray([5], np.int32)]
    jeng, want = _serve(JEngine, JRequest, jm, jp, one, max_batch=1)
    eng, got = _serve(ServingEngine, Request, tm, tp, one, max_batch=1,
                      device="cpu")
    assert got == want
    two = [np.asarray([5, 9], np.int32)]
    with pytest.raises(ValueError, match="broadcast"):
        _serve(JEngine, JRequest, jm, jp, two, max_batch=1)
    with pytest.raises(ValueError, match="broadcast"):
        _serve(ServingEngine, Request, tm, tp, two, max_batch=1,
               device="cpu")
    # the splice alone: one prefilled token in all three conv rows
    _, rc = tm.prefill(tp, {"tokens": _t(one[0][None].astype(np.int64))})
    cache = {n: torch.zeros(s.shape, dtype=s.dtype)
             for n, s in tm.abstract_cache(2, 16).items()}
    ServingEngine._splice_cache(cache, 1, rc)
    rows = cache["conv"][:, :, 1]
    assert bool((rows == rows[:, :, :1]).all()) and bool((rows != 0).any())
    assert bool((cache["conv"][:, :, 0] == 0).all())


def test_engine_refusals_match_jax(need_jax):
    """The paged backend, an int8 cache and speculation raise ValueError
    in both engines; a media request and a 40-token prompt with
    scan_chunk 16 are refused at submission by the port (the JAX engine
    fails the latter at admission, in its scan's assertion)."""
    from repro_torch.serving.segments import EmbedSegment, TextSegment
    cfg, jm, jp, tm, tp = _models(scan_chunk=16)
    tcfg = tm.cfg
    for kw in (dict(paged=True), dict(kv_dtype="int8"),
               dict(draft_config="self")):
        jkw, tkw = dict(kw), dict(kw, device="cpu")
        if "draft_config" in kw:
            jkw.update(draft_config=cfg, draft_params=jp)
            tkw.update(draft_config=tcfg, draft_params=tp)
        with pytest.raises(ValueError):
            JEngine(jm, jp, **jkw)
        with pytest.raises(ValueError):
            ServingEngine(tm, tp, **tkw)
    eng = ServingEngine(tm, tp, max_batch=2, max_seq=96, device="cpu")
    media = Request(0, segments=[EmbedSegment(np.zeros((3, tcfg.d_model),
                                                       np.float32)),
                                 TextSegment(np.arange(4))])
    with pytest.raises(ValueError, match="attention-family"):
        eng.submit(media)
    with pytest.raises(ValueError, match="scan_chunk=16"):
        eng.submit(Request(1, np.arange(40)))
    assert not eng.busy()
    jeng = JEngine(jm, jp, max_batch=2, max_seq=96)
    jeng.submit(JRequest(1, np.arange(40, dtype=np.int32)))
    with pytest.raises(AssertionError):
        jeng.run_until_drained()


# ---------------------------------------------------------- seeded init


def test_cpu_seeded_init_unchanged():
    """On the CPU each leaf is still one fp32 draw of a generator seeded
    by (seed, sha256 of its path), scaled and cast: the weights every CPU
    test and the CPU/CUDA parity runs start from."""
    tm = build_model(reduced(get_config(ARCH)))
    params = tm.init(3, param_dtype=torch.bfloat16, device="cpu")
    for path, keys in (("/mamba/in_proj", ("mamba", "in_proj")),
                       ("/shared_attn/attn/wq", ("shared_attn", "attn",
                                                 "wq"))):
        s = tm.spec
        got = params
        for k in keys:
            s, got = s[k], got[k]
        gen = spec_lib._path_generator(3, path)
        want = (torch.randn(s.shape, generator=gen, dtype=torch.float32)
                * s.scale).to(torch.bfloat16)
        assert torch.equal(got, want), path
    assert bool((params["mamba"]["pre_norm"] == 1).all())
    assert bool((params["mamba"]["conv_b"] == 0).all())


# ------------------------------------------------- CUDA kernels vs plain


# the CPU sweep, then zamba2-2.7b's width (h 80, p 64, n 64) at prompts
# of 48, 200 and 256 tokens (one chunk each) and 512 (two chunks of 256)
GPU_SCAN_CASES = ([(b, S, h, p, n, c) for b, S, h, p, n in SCAN_CASES
                   for c in (16, 32, 64)]
                  + [(1, S, 80, 64, 64, 256) for S in (48, 200, 256, 512)]
                  + [(2, 96, 80, 64, 64, 32)])


def _hold_scan(got, want, what):
    """Within 1e-4 relative plus 1e-4 of the compared tensor's RMS."""
    g, w = _np(got), _np(want)
    rms = float(np.sqrt((w ** 2).mean()))
    np.testing.assert_allclose(g, w, atol=1e-4 * rms, rtol=1e-4,
                               err_msg=what)


@pytest.mark.gpu
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,S,h,p,n,chunk", GPU_SCAN_CASES)
def test_ssd_scan_kernel_matches_plain(cuda, b, S, h, p, n, chunk, dtype,
                                       init):
    x, dt, a_neg, B, C, s0 = _scan_inputs(b, S, h, p, n, seed=7, init=init)
    tdt = getattr(torch, dtype)
    args = [_t(x, tdt, cuda), _t(dt, None, cuda), _t(a_neg, None, cuda),
            _t(B, tdt, cuda), _t(C, tdt, cuda)]
    s0 = None if s0 is None else _t(s0, None, cuda)
    before = ops.ssd_scan.launches
    y, state = ops.ssd_scan(*args, chunk=chunk, init_state=s0)
    torch.cuda.synchronize()
    assert ops.ssd_scan.launches == before + 1
    assert y.dtype == torch.float32 and y.shape == (b, S, h, p)
    assert state.dtype == torch.float32 and state.shape == (b, h, p, n)
    wy, wstate = ssd_scan_ref(*[a.float() for a in args],
                              chunk=min(chunk, S), init_state=s0)
    _hold_scan(y, wy, "y")
    _hold_scan(state, wstate, "final state")


@pytest.mark.gpu
def test_ssd_scan_kernel_rejects_what_it_cannot_take(cuda):
    x, dt, a_neg, B, C, _ = _scan_inputs(1, 64, 2, 16, 8)
    args = [_t(a, None, cuda) for a in (x, dt, a_neg, B, C)]
    with pytest.raises(ValueError):  # a chunk past the kernel's 256
        ops.ssd_scan(*[_t(a, None, cuda) for a in
                       _scan_inputs(1, 512, 2, 16, 8)[:5]], chunk=512)
    with pytest.raises(ValueError):  # B in another type than x
        ops.ssd_scan(args[0], args[1], args[2], args[3].bfloat16(),
                     args[4], chunk=16)
    with pytest.raises(ValueError):  # strided x
        ops.ssd_scan(args[0].transpose(2, 3).contiguous().transpose(2, 3),
                     *args[1:], chunk=16)
    ops.ssd_scan(*args, chunk=16)  # and the same call as it should be


# zamba2-2.7b's shared attention: 32 heads of 80 (Hkv 32), causal
# prefills of 16 to 768 tokens, and its dense cache at B 8, max_seq 1024
GPU_FLASH_D80 = [(1, S, S, 32, 32, 80, True, 0) for S in (16, 200, 768)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal,window", GPU_FLASH_D80)
def test_flash_attention_kernel_at_d80(cuda, B, Sq, Sk, H, Hkv, D, causal,
                                       window, dtype):
    from test_torch_multimodal import (EXACT_TOL, TOL, _flash_inputs,
                                       _widened)
    tdt = getattr(torch, dtype)
    args = [_t(a, tdt, cuda) for a in _flash_inputs(B, Sq, Sk, H, Hkv, D,
                                                   seed=8)]
    before = ops.flash_attention.launches
    out = ops.flash_attention(*args, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    want = flash_attention_ref(*_widened(args), causal=causal, window=window)
    np.testing.assert_allclose(_np(out), _np(want), **EXACT_TOL[dtype])
    same = flash_attention_ref(*args, causal=causal, window=window)
    np.testing.assert_allclose(_np(out), _np(same), **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_flash_decode_kernel_at_d80(cuda, q_dtype):
    """A bf16 dense cache at zamba2's shared-attention layout: B 8,
    max_seq 1024, 32 heads of 80, a parked slot."""
    from test_torch_dense import (KERNEL_TOL, _decode_inputs,
                                  _hold_dead_rows, _rows_with_keys)
    from test_torch_kernels import hold_rounded
    q, kc, vc, cpos, pos = _decode_inputs(8, 1024, 32, 32, 80, True, seed=9,
                                          parked=(7,))
    qdt = getattr(torch, q_dtype)
    args = [_t(a, d, cuda) for a, d in ((q, qdt), (kc, torch.bfloat16),
                                        (vc, torch.bfloat16), (cpos, None),
                                        (pos, None))]
    before = ops.flash_decode.launches
    out = ops.flash_decode(*args)
    torch.cuda.synchronize()
    assert ops.flash_decode.launches == before + 1
    rows = _rows_with_keys(cpos, pos, 0)
    hold_rounded(out, flash_decode_ref, args, {}, rows)
    _hold_dead_rows(out, flash_decode_ref, args, ~rows, {}, q_dtype)
    np.testing.assert_allclose(_np(out)[rows],
                               _np(flash_decode_ref(*args))[rows],
                               **KERNEL_TOL["bfloat16"])


@pytest.mark.gpu
def test_device_init_is_seeded(cuda):
    """The init drawn on the card: the same (seed, path) gives the same
    leaf, another seed or path another one; each drawn leaf has its spec's
    standard deviation (within 2 %, over >= 65 k values) and mean ~0;
    ones and zeros stay exact."""
    tm = build_model(reduced(get_config(ARCH), d_model=512))
    a = tm.init(0, param_dtype=torch.bfloat16, device=cuda)
    b = tm.init(0, param_dtype=torch.bfloat16, device=cuda)
    c = tm.init(1, param_dtype=torch.bfloat16, device=cuda)
    for keys in (("mamba", "in_proj"), ("shared_attn", "mlp", "w_up")):
        s, ta, tb, tc = tm.spec, a, b, c
        for k in keys:
            s, ta, tb, tc = s[k], ta[k], tb[k], tc[k]
        assert ta.device.type == "cuda" and ta.dtype == torch.bfloat16
        assert torch.equal(ta, tb) and not torch.equal(ta, tc)
        std = float(ta.float().std())
        assert abs(std / s.scale - 1) < 0.02, (keys, std, s.scale)
        assert abs(float(ta.float().mean())) < 0.02 * s.scale
    sa = a["shared_attn"]
    assert not torch.equal(sa["mlp"]["w_up"], sa["mlp"]["w_gate"])
    assert bool((a["mamba"]["a_log"] == 1).all())
    assert bool((a["mamba"]["dt_bias"] == 0).all())
