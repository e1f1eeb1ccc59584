"""Port of the xLSTM family against the JAX package: the chunkwise mLSTM
held to ``repro.models.xlstm.mlstm_chunkwise`` and to both packages'
sequential oracles, the extreme-gate finiteness property, the mLSTM and
sLSTM blocks over a prompt and their one-token decode steps,
``lm.xlstm_forward``, ``Model.prefill`` and the dense ``serve_step`` of
reduced xlstm-1.3b on the same fp32 weights (``from_jax_params``), and
the serving engine (dense backend, exact-shape monolithic prefill)
against the JAX engine's ``Request.output``, with the refusals of both
(a 2-token prompt, a prompt past ``scan_chunk`` that is not a multiple of
it, the paged and int8 backends).  Also: the full-width spec against the
JAX package's (3,605,977,424 parameters).  On a CUDA card only: the
RMSNorm kernel at the widths xlstm-1.3b normalizes.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs on the CPU on any host (``need_jax``).

Tolerances (each with its reason):
* the chunkwise mLSTM against the JAX function and the sequential
  oracles: tests/test_moe_ssm.py:112's 2e-4 absolute and relative (fp32
  decayed sums over up to 64 tokens in other orders);
* blocks, decode steps and model steps in fp32: 1e-4 absolute and
  relative (the matmuls, cumulative sums and exponentials of at most
  four blocks in other orders; differences seen are ~1e-6);
* engines: identical greedy tokens;
* the RMSNorm kernel: test_torch_multimodal.py's tolerances, for the
  reasons stated there.
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
    from repro.models import xlstm as jxl
    from repro.serving.engine import Request as JRequest
    from repro.serving.engine import ServingEngine as JEngine
except ImportError:  # JAX (the reference) is not installed
    jax = None

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.kernels.rmsnorm import rmsnorm_ref
from repro_torch.models import lm
from repro_torch.models import xlstm as xl
from repro_torch.models.api import build_model
from repro_torch.nn import spec as spec_lib
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.weights import from_jax_params

ARCH = "xlstm-1.3b"
CELL_TOL = dict(atol=2e-4, rtol=2e-4)
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


def _hold(got, want, tol):
    """A tensor (or a nested tuple of them) against the JAX values."""
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _hold(g, w, tol)
        return
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


def _cell_inputs(b, S, h, dk, seed, gate_scale=1.0):
    """q, k, v, the log input gate and the (negative) log forget gate, as
    tests/test_moe_ssm.py draws them; ``gate_scale`` 20 for the
    extreme-gate property."""
    rng = np.random.default_rng(seed)
    out = [rng.normal(size=(b, S, h, dk)) for _ in range(3)]
    out += [rng.normal(size=(b, S, h)) * gate_scale,
            -np.abs(rng.normal(size=(b, S, h))) * gate_scale]
    return [a.astype(np.float32) for a in out]


# --------------------------------------------------------------- mLSTM cell


@pytest.mark.parametrize("chunk", [8, 32])
def test_mlstm_chunkwise_matches_jax(need_jax, chunk):
    """h and the final (C, n, m) against the JAX chunkwise function, the
    JAX sequential oracle and the port's own ``mlstm_reference``."""
    args = _cell_inputs(2, 64, 2, 8, seed=0)
    h, state = xl.mlstm_chunkwise(*map(_t, args), chunk=chunk)
    assert h.dtype == torch.float32 and h.shape == (2, 64, 2, 8)
    jargs = [jnp.asarray(a) for a in args]
    for jh, jstate in (jxl.mlstm_chunkwise(*jargs, chunk=chunk),
                       jxl.mlstm_reference(*jargs)):
        _hold(h, jh, CELL_TOL)
        _hold(state, jstate, CELL_TOL)
    rh, rstate = xl.mlstm_reference(*map(_t, args))
    _hold(h, _np(rh), CELL_TOL)
    _hold(state, tuple(_np(t) for t in rstate), CELL_TOL)


def test_mlstm_chunkwise_continues_a_state(need_jax):
    """From a carried (C, n, m), over two chunks of 16, as the JAX
    function."""
    args = _cell_inputs(1, 32, 2, 8, seed=1)
    rng = np.random.default_rng(2)
    init = (rng.normal(size=(1, 2, 8, 8)), rng.normal(size=(1, 2, 8)),
            rng.normal(size=(1, 2)))
    init = tuple(a.astype(np.float32) for a in init)
    h, state = xl.mlstm_chunkwise(*map(_t, args), chunk=16,
                                  init=tuple(map(_t, init)))
    jh, jstate = jxl.mlstm_chunkwise(*map(jnp.asarray, args), chunk=16,
                                     init=tuple(map(jnp.asarray, init)))
    _hold(h, jh, CELL_TOL)
    _hold(state, jstate, CELL_TOL)


@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("S", [16, 32, 48])
def test_mlstm_stability_extreme_gates(S, chunk):
    """Property (tests/test_moe_ssm.py:130): max-stabilization keeps h and
    the state finite under gate pre-activations 20 times their usual
    scale."""
    args = _cell_inputs(1, S, 2, 8, seed=S + chunk, gate_scale=20.0)
    h, state = xl.mlstm_chunkwise(*map(_t, args), chunk=chunk)
    assert bool(torch.isfinite(h).all())
    assert all(bool(torch.isfinite(t).all()) for t in state)


def test_mlstm_chunk_rule():
    """A sequence that does not split into whole chunks is refused with a
    ValueError (the JAX function asserts)."""
    args = _cell_inputs(1, 40, 2, 8, seed=3)
    with pytest.raises(ValueError, match="whole chunks of 16"):
        xl.mlstm_chunkwise(*map(_t, args), chunk=16)


# -------------------------------------------------------------- the blocks


def _block(kind, seed, d=64, nh=4, conv_width=4):
    """One block's weights (numpy, fp32) at the spec's shapes and scales,
    the norms and biases drawn around their init so every term matters."""
    rng = np.random.default_rng(seed)
    spec = (xl.mlstm_spec((1,), d, 2 * d, nh, conv_width) if kind == "m"
            else xl.slstm_spec((1,), d, nh))
    out = {}
    for k, s in spec.items():
        shape = s.shape[1:]
        if s.init == "normal":
            out[k] = rng.normal(size=shape) * s.scale
        else:
            out[k] = rng.normal(1.0 if s.init == "ones" else 0.0, 0.3, shape)
    return {k: v.astype(np.float32) for k, v in out.items()}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: _t(v) for k, v in p.items()})


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("S,chunk", [(48, 16), (40, 64), (1, 16)])
def test_mlstm_block_matches_jax(need_jax, S, chunk, init):
    """A whole prompt (three chunks, one chunk of 40, one token), from
    zeros or continuing a carried (conv, (C, n, m)) state: output, conv
    window and the three states."""
    jp, tp = _both(_block("m", seed=4))
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, S, 64)).astype(np.float32)
    carried = None
    if init:
        carried = (rng.normal(size=(2, 3, 128)),
                   (rng.normal(size=(2, 4, 32, 32)),
                    rng.normal(size=(2, 4, 32)), rng.normal(size=(2, 4))))
        carried = (carried[0].astype(np.float32),
                   tuple(a.astype(np.float32) for a in carried[1]))

    def conv(c, f):
        return None if c is None else (f(c[0]), tuple(map(f, c[1])))

    jy, jstate = jxl.mlstm_block(jp, jnp.asarray(x), nh=4, chunk=chunk,
                                 init=conv(carried, jnp.asarray))
    ty, tstate = xl.mlstm_block(tp, _t(x), nh=4, chunk=chunk,
                                init=conv(carried, _t), gather_qkv=True)
    _hold(ty, jy, STEP_TOL)
    _hold(tstate, jstate, STEP_TOL)


def test_mlstm_block_decode_matches_jax(need_jax):
    """Five one-token steps from a carried state: output and states."""
    jp, tp = _both(_block("m", seed=6))
    rng = np.random.default_rng(7)
    state = (rng.normal(size=(3, 3, 128)),
             (rng.normal(size=(3, 4, 32, 32)), rng.normal(size=(3, 4, 32)),
              rng.normal(size=(3, 4))))
    jstate = (jnp.asarray(state[0], jnp.float32),
              tuple(jnp.asarray(a, jnp.float32) for a in state[1]))
    tstate = (_t(state[0], torch.float32),
              tuple(_t(a, torch.float32) for a in state[1]))
    for _ in range(5):
        x = rng.normal(size=(3, 64)).astype(np.float32)
        jy, jstate = jxl.mlstm_block_decode(jp, jnp.asarray(x), jstate, nh=4)
        ty, tstate = xl.mlstm_block_decode(tp, _t(x), tstate, nh=4)
        _hold(ty, jy, STEP_TOL)
        _hold(tstate, jstate, STEP_TOL)


@pytest.mark.parametrize("init", [False, True])
def test_slstm_scan_and_block_match_jax(need_jax, init):
    """The sLSTM scan over 20 tokens and the whole block (out norm, the
    FFN whose pre-norm reuses ``norm``), from zeros or a carried (c, n,
    m, h)."""
    jp, tp = _both(_block("s", seed=8))
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 20, 64)).astype(np.float32)
    carried = None
    if init:
        carried = tuple(rng.normal(size=(2, 64)).astype(np.float32)
                        for _ in range(4))
        carried = (carried[0], np.abs(carried[1]) + 0.5) + carried[2:]
    jinit = None if carried is None else tuple(map(jnp.asarray, carried))
    tinit = None if carried is None else tuple(map(_t, carried))
    jh, jstate = jxl.slstm_scan(jp, jnp.asarray(x), nh=4, init=jinit)
    th, tstate = xl.slstm_scan(tp, _t(x), nh=4, init=tinit)
    _hold(th, jh, STEP_TOL)
    _hold(tstate, jstate, STEP_TOL)
    jy, jstate = jxl.slstm_block(jp, jnp.asarray(x), nh=4, init=jinit)
    ty, tstate = xl.slstm_block(tp, _t(x), nh=4, init=tinit)
    _hold(ty, jy, STEP_TOL)
    _hold(tstate, jstate, STEP_TOL)
    assert "norm" in tp and not any(k.startswith("ffn") for k in tp)


def test_slstm_block_decode_matches_jax(need_jax):
    """Five one-token steps of the sLSTM block from a carried state."""
    jp, tp = _both(_block("s", seed=10))
    rng = np.random.default_rng(11)
    state = [rng.normal(size=(3, 64)).astype(np.float32) for _ in range(4)]
    state[1] = np.abs(state[1]) + 0.5
    jstate, tstate = tuple(map(jnp.asarray, state)), tuple(map(_t, state))
    for _ in range(5):
        x = rng.normal(size=(3, 64)).astype(np.float32)
        jy, jstate = jxl.slstm_block_decode(jp, jnp.asarray(x), jstate, nh=4)
        ty, tstate = xl.slstm_block_decode(tp, _t(x), tstate, nh=4)
        _hold(ty, jy, STEP_TOL)
        _hold(tstate, jstate, STEP_TOL)


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


def test_spec_tree_matches_jax(need_jax):
    """Reduced: the port's spec has the JAX params' tree and shapes, and
    ``from_jax_params`` carries every leaf.  Full width: every leaf's
    shape as ``Model.abstract()``, 3,605,977,424 parameters (q/k/v are
    dense d_in x d_in), 6 groups of 7 mLSTM blocks and one sLSTM block."""
    cfg, jm, jp, tm, tp = _models()
    specs = spec_lib.tree_map_specs(lambda path, s: s.shape, tm.spec)
    assert specs == jax.tree.map(lambda a: a.shape, jp)
    assert tp["mlstm"]["wq"].shape == (1, 3, 128, 128)
    jabs = jbuild(jget_config(ARCH)).abstract()
    full = build_model(get_config(ARCH))
    shapes = spec_lib.tree_map_specs(lambda path, s: s.shape, full.spec)
    assert shapes == jax.tree.map(lambda a: a.shape, jabs)
    n = sum(int(np.prod(s)) for s in jax.tree.leaves(
        shapes, is_leaf=lambda s: isinstance(s, tuple)))
    assert n == 3_605_977_424
    assert lm.xlstm_groups(full.cfg) == (6, 7)


def test_xlstm_forward_matches_jax(need_jax):
    """The final hidden states and every cache leaf of a 33-token
    prompt."""
    cfg, jm, jp, tm, tp = _models()
    toks = np.random.default_rng(12).integers(0, cfg.vocab, (2, 33))
    jh, jc = jlm.xlstm_forward(cfg, jp, jnp.asarray(toks, jnp.int32),
                               remat=False, return_cache=True)
    th, tc = lm.xlstm_forward(tm.cfg, tp, _t(toks), return_cache=True)
    _hold(th, jh, STEP_TOL)
    _hold(tc, jc, STEP_TOL)


def _hold_cache(jcache, tcache):
    """Dtypes equal; fp32 leaves within STEP_TOL; bf16 leaves within one
    bf16 ulp of the larger value.  Where a leaf differs at all, the JAX
    values are copied into the port's, so that the next step starts from
    equal caches."""
    assert set(jcache) == set(tcache)
    for name, leaf in jcache.items():
        got = tcache[name]
        assert tuple(got.shape) == leaf.shape, name
        assert str(got.dtype).removeprefix("torch.") == str(leaf.dtype), name
        a, b = _np(leaf), _np(got)
        if got.dtype == torch.bfloat16:
            bound = 2.0 ** -7 * np.maximum(np.abs(a), np.abs(b))
            assert bool((np.abs(a - b) <= bound).all()), name
        else:
            np.testing.assert_allclose(b, a, **STEP_TOL, err_msg=name)
        if (a != b).any():
            got.copy_(torch.from_numpy(np.array(a)).to(got.dtype))


def test_prefill_and_decode_match_jax(need_jax):
    """``Model.prefill`` of a 48-token prompt over three chunks of 16
    (logits and every cache leaf), then three dense ``serve_step``s on
    the spliced cache with a free slot (logits of the live slot, within
    1e-4 of the largest |logit|, and the whole cache, whose conv leaf
    both packages return in the activation type)."""
    cfg, jm, jp, tm, tp = _models(scan_chunk=16)
    toks = np.random.default_rng(13).integers(0, cfg.vocab, (1, 48))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tc = tm.prefill(tp, {"tokens": _t(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4 *
                               float(np.abs(np.asarray(jl)).max()), rtol=0)
    _hold_cache(jc, tc)
    Sa = 64
    jcache = JEngine._splice_cache(
        {n: jnp.zeros(s.shape, s.dtype)
         for n, s in jm.abstract_cache(2, Sa).items()}, 0, jc)
    tcache = ServingEngine._splice_cache(
        {n: torch.zeros(s.shape, dtype=s.dtype)
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
        np.testing.assert_allclose(
            tl.numpy()[0], np.asarray(jl)[0], rtol=0,
            atol=1e-4 * float(np.abs(np.asarray(jl)[0]).max()))
        _hold_cache(dict(jcache), tcache)
        tok = int(np.argmax(np.asarray(jl)[0]))


def test_prefill_refusals_match_jax(need_jax):
    """What xlstm's prefill refuses in both packages: a bucketed
    (``length``) batch and embedding spans, with the JAX package's
    ValueError; a 300-token prompt with scan_chunk 256, which the JAX
    cell fails with an AssertionError and the port with a ValueError
    naming the rule; the family's capabilities."""
    cfg, jm, jp, tm, tp = _models()
    toks = np.zeros((1, 8), np.int64)
    feats = np.zeros((1, 8, cfg.d_model), np.float32)
    for extra, match in (({"length": np.asarray([6], np.int32)}, "bucketed"),
                         ({"embeds": feats,
                           "embed_mask": np.zeros((1, 8), bool)},
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


def test_engine_matches_jax(need_jax):
    """scan_chunk 16: prompts of 1 token (its conv row broadcast into the
    window), 3, 7, 16, 32 and 48 tokens (three chunks) through the engine
    on the dense backend with exact-shape monolithic prefill; the same
    greedy tokens and counters as the JAX engine."""
    cfg, jm, jp, tm, tp = _models(scan_chunk=16)
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (1, 7, 32, 48, 16, 3)]
    jeng, want = _serve(JEngine, JRequest, jm, jp, prompts)
    eng, got = _serve(ServingEngine, Request, tm, tp, prompts, device="cpu")
    assert got == want
    js, ts = jeng.stats(), eng.stats()
    for key in ("paged", "chunked", "bucketed", "decode_tokens",
                "prefill_tokens_computed", "prefill_tokens_padded"):
        assert ts[key] == js[key], key
    assert ts["paged"] is False and ts["chunked"] is False
    assert ts["prefills"] == len(prompts) and ts["prefill_chunks"] == 0


def test_engine_refusals_match_jax(need_jax):
    """A 2-token prompt's two conv rows broadcast into none of the
    window's three: both engines raise ValueError at its admission, before
    any leaf of the slot is written.  A 300-token prompt past scan_chunk
    256: the JAX engine fails at admission with an AssertionError, the
    port refuses it at submission with the prompt-length ValueError.  The
    paged backend and an int8 cache: ValueError in both."""
    cfg, jm, jp, tm, tp = _models()
    two = np.asarray([5, 9], np.int32)
    for eng in (JEngine(jm, jp, max_batch=2, max_seq=64),
                ServingEngine(tm, tp, max_batch=2, max_seq=64,
                              device="cpu")):
        req_cls = JRequest if isinstance(eng, JEngine) else Request
        eng.submit(req_cls(0, two, max_new_tokens=3))
        with pytest.raises(ValueError, match="broadcast"):
            eng.run_until_drained()
    long = np.zeros(300, np.int32)
    jeng = JEngine(jm, jp, max_batch=2, max_seq=512)
    jeng.submit(JRequest(0, long, max_new_tokens=2))
    with pytest.raises(AssertionError):
        jeng.run_until_drained()
    eng = ServingEngine(tm, tp, max_batch=2, max_seq=512, device="cpu")
    with pytest.raises(ValueError, match="multiple of it"):
        eng.submit(Request(0, long, max_new_tokens=2))
    assert not eng.busy()
    for kw in (dict(paged=True), dict(paged=False, kv_dtype="int8")):
        with pytest.raises(ValueError):
            JEngine(jm, jp, max_batch=2, max_seq=64, **kw)
        with pytest.raises(ValueError):
            ServingEngine(tm, tp, max_batch=2, max_seq=64, device="cpu",
                          **kw)


# ------------------------------------------------- the kernel on the card


# xlstm-1.3b's norms: d 2048 (each block's pre-norm, the sLSTM's out norm
# and FFN norm, the final norm) and d_in 4096 (the mLSTM's out norm) at a
# decode tick of 8 slots and a 768-token prompt
GPU_RMS_SHAPES = [(8, 2048), (8, 4096), (768, 2048), (768, 4096)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", GPU_RMS_SHAPES)
def test_rmsnorm_kernel_at_xlstm_widths(cuda, shape, dtype):
    from test_torch_multimodal import EXACT_TOL, TOL
    rng = np.random.default_rng(15)
    x = _t(rng.normal(size=shape), getattr(torch, dtype), cuda)
    s = _t(rng.normal(1.0, 0.3, shape[-1:]), torch.bfloat16, cuda)
    before = ops.rmsnorm.launches
    out = ops.rmsnorm(x, s, eps=1e-6)
    torch.cuda.synchronize()
    assert ops.rmsnorm.launches == before + 1
    want = rmsnorm_ref(x.float(), s.float())
    np.testing.assert_allclose(_np(out), _np(want), **EXACT_TOL[dtype])
    np.testing.assert_allclose(_np(out), _np(rmsnorm_ref(x, s)), **TOL[dtype])
