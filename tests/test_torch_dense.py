"""Port of dense-cache decode and monolithic prefill against the JAX
package: the plain flash-decode versions (bf16/fp32 and int8 caches) held
to the JAX kernels (interpret mode) and to their jnp oracles;
``Model.prefill`` with embedding spans, ``prefill_with_prefix``,
``prefill_chunk_dense`` (with and without embedding spans) and the dense
``serve_step`` held to the JAX model steps on the same fp32 weights, on
the reduced qwen2-0.5b, llama3.2-3b and gemma3-1b; and, on a CUDA card
only, the hand-written flash-decode kernel held to its plain version at
the serving widths.

Inputs are made with numpy from a seed and handed to both packages.  The
JAX side runs on the CPU on any host (the ``need_jax`` fixture pins it
there): JAX on a GPU computes fp32 products at a lower default precision
than these tolerances allow for.

Tolerances (each with its reason):
* plain flash decode vs the JAX oracle: fp32 differs in summation order
  only (1e-5); a bf16 output may round the other way by one bf16 ulp
  (2^-7 relative, 1e-2 absolute near the largest outputs);
* plain vs the JAX Pallas kernel (interpret mode): the kernel keeps the
  probabilities in fp32 where the oracle rounds them to the cache type -
  test_kernels.py's 2e-4 fp32 and 5e-2 bf16, test_kv_quant.py's 5e-3 for
  int8 caches;
* model steps: logits 1e-3 and the bf16 dense cache within one bf16 ulp
  of the value plus one of the layer's RMS, for the reason
  test_torch_model.py and test_torch_speculative.py state (fp32 values
  that differ in their last bits between the packages round to
  neighbouring bf16 values, and a later layer inherits that); the fp32
  K/V a prefill returns 1e-4;
* the CUDA kernel vs its plain version on the same values widened to fp32:
  summation order and the kernel's final rounding to q's type only -
  EXACT_TOL; in the working type (bf16 q, the plain version rounds its
  probabilities to bf16, the kernel does not) test_kv_cache.py's 5e-2,
  and 5e-3 for int8 caches (test_kv_quant.py);
* a reduced fp32 model's dense decode step on the card vs on the CPU:
  logits 1e-2, for the same rounding of the probabilities, carried
  through every layer (the test says more).
"""
import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.kernels.quant import quantize_kv as jquant
    from repro.models import build_model as jbuild
except ImportError:  # JAX (the reference) is not installed
    jax = None

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import (flash_decode_quant_ref,
                                              flash_decode_ref)
from repro_torch.kernels.quant import quantize_kv
from repro_torch.models.api import build_model
from repro_torch.weights import from_jax_params
from test_torch_kernels import hold_rounded

PLAIN_TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
             "bfloat16": dict(atol=1e-2, rtol=2 ** -7)}
KERNEL_TOL = {"float32": dict(atol=2e-4, rtol=2e-4),
              "bfloat16": dict(atol=5e-2, rtol=5e-2)}
QUANT_TOL = dict(atol=5e-3, rtol=5e-3)
EXACT_TOL = {"float32": dict(atol=1e-5, rtol=1e-4),
             "bfloat16": dict(atol=1e-5, rtol=2 ** -7)}

# (B, S, H, Hkv, D, window, holes): the sweep of test_kernels.py:35-39
# (full caches, positions 0..S-1), then caches as the engines leave them:
# -1 tails past each prompt and, with ``holes``, empty entries inside and
# stale entries past the query position (a rejected draft chain), at
# qwen2-0.5b's heads and gemma3-1b's MQA D 256 with a local window
CASES = [
    (2, 96, 8, 2, 64, 0, False),
    (2, 128, 4, 4, 32, 24, False),
    (1, 70, 8, 1, 64, 0, False),
    (3, 128, 14, 2, 64, 0, True),
    (2, 96, 4, 1, 256, 40, True),
]
# the sweep of test_kv_quant.py:116-120, then the two engine-like cases
QUANT_CASES = [
    (2, 96, 8, 2, 64, 0, False),
    (1, 70, 8, 1, 64, 0, False),
    (2, 128, 4, 4, 32, 24, False),
    (3, 128, 14, 2, 64, 0, True),
    (2, 96, 4, 1, 256, 40, True),
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


def _decode_inputs(B, S, H, Hkv, D, holes, seed, *, parked=()):
    """q [B,H,D], fp32 caches [B,S,Hkv,D], cache_positions [B,S] and pos
    [B].  Without ``holes``: every entry holds its index, pos in
    [S/2, S) (test_kernels.py).  With ``holes``: each slot holds a prompt
    of random length (-1 past it), a few entries inside it empty, and the
    query sits up to 3 positions before the last entry, so the entries
    past it are stale; slots in ``parked`` sit at pos = S (the engine's
    parked slots: everything written is visible, nobody reads the row)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    kc = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    vc = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    cpos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    if not holes:
        pos = rng.integers(S // 2, S, B).astype(np.int32)
        return q, kc, vc, cpos, pos
    pos = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(S // 4, S + 1))
        cpos[b, n:] = -1
        cpos[b, rng.choice(n, size=max(1, n // 16), replace=False)] = -1
        pos[b] = S if b in parked else max(n - 1 - int(rng.integers(0, 4)),
                                           0)
    return q, kc, vc, cpos, pos


def _t(a, dtype=None, device="cpu"):
    t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def _np(x):
    return np.asarray(x.float().cpu() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32), np.float32)


def _quantized(kc, vc):
    """bf16-rounded K/V quantized by the JAX package (int8 rows and fp32
    row scales), as an int8 cache would store them."""
    out = []
    for a in (kc, vc):
        b = np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
        out += [np.array(x) for x in jquant(jnp.asarray(b))]
    return out  # k8, ks, v8, vs


# --------------------------------------------- plain versions vs the JAX


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,Hkv,D,window,holes", CASES)
def test_flash_decode_plain_matches_jax(need_jax, B, S, H, Hkv, D, window,
                                        holes, dtype):
    q, kc, vc, cpos, pos = _decode_inputs(B, S, H, Hkv, D, holes, seed=42)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = (jnp.asarray(q, jdt), jnp.asarray(kc, jdt), jnp.asarray(vc, jdt),
             jnp.asarray(cpos), jnp.asarray(pos))
    out = ops.flash_decode(_t(q, tdt), _t(kc, tdt), _t(vc, tdt), _t(cpos),
                           _t(pos), window=window, block_k=32)
    assert out.dtype == tdt and out.shape == (B, H, D)
    want = jref.flash_decode_ref(*jargs, window=window)
    np.testing.assert_allclose(_np(out), _np(want), **PLAIN_TOL[dtype])
    kern = jops.flash_decode(*jargs, window=window, block_k=32)  # Pallas
    np.testing.assert_allclose(_np(out), _np(kern), **KERNEL_TOL[dtype])


@pytest.mark.parametrize("B,S,H,Hkv,D,window,holes", QUANT_CASES)
def test_flash_decode_quant_plain_matches_jax(need_jax, B, S, H, Hkv, D,
                                              window, holes):
    q, kc, vc, cpos, pos = _decode_inputs(B, S, H, Hkv, D, holes, seed=11)
    k8, ks, v8, vs = _quantized(kc, vc)
    jargs = (jnp.asarray(q, jnp.bfloat16), jnp.asarray(k8), jnp.asarray(v8),
             jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(cpos),
             jnp.asarray(pos))
    targs = (_t(q, torch.bfloat16), _t(k8), _t(v8), _t(ks), _t(vs),
             _t(cpos), _t(pos))
    out = ops.flash_decode_quant(*targs, window=window, block_k=32)
    assert out.dtype == torch.bfloat16 and out.shape == (B, H, D)
    want = jref.flash_decode_quant_ref(*jargs, window=window)
    np.testing.assert_allclose(_np(out), _np(want), **PLAIN_TOL["bfloat16"])
    kern = jops.flash_decode_quant(*jargs, window=window, block_k=32)
    np.testing.assert_allclose(_np(out), _np(kern), **QUANT_TOL)
    assert bool(torch.isfinite(out.float()).all())


def test_wrappers_run_plain_versions_on_cpu_only():
    q, kc, vc, cpos, pos = _decode_inputs(2, 96, 8, 2, 64, True, seed=0)
    args = (_t(q), _t(kc), _t(vc), _t(cpos), _t(pos))
    k8, ks = quantize_kv(_t(kc, torch.bfloat16))
    v8, vs = quantize_kv(_t(vc, torch.bfloat16))
    qargs = (_t(q), k8, v8, ks, vs, _t(cpos), _t(pos))
    before = (ops.flash_decode.launches, ops.flash_decode_quant.launches)
    assert torch.equal(ops.flash_decode(*args, window=8),
                       flash_decode_ref(*args, window=8))
    assert torch.equal(ops.flash_decode_quant(*qargs),
                       flash_decode_quant_ref(*qargs))
    assert (ops.flash_decode.launches,
            ops.flash_decode_quant.launches) == before  # no kernel here
    with pytest.raises(ValueError):  # a tensor on no CPU or CUDA device
        ops.flash_decode(_t(q), _t(kc).to("meta"), *args[2:])


# ----------------------------------------------------- model steps vs JAX


def _models(arch):
    cfg = jreduced(jget_config(arch), act_dtype="float32")
    jm = jbuild(cfg)
    jp = jm.init(jax.random.PRNGKey(0), param_dtype=jnp.float32)
    tm = build_model(reduced(get_config(arch), act_dtype="float32"))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jm, jp, tm, tp


def _hold_dense(jcache, tcache):
    """The dense cache's pos_map exactly; K/V within one bf16 ulp of the
    larger value plus one bf16 ulp of the layer's RMS (the module
    docstring says why).  Where K/V differ at all, the JAX values are
    copied into the port's cache so the next step starts equal."""
    np.testing.assert_array_equal(tcache["pos_map"].numpy(),
                                  np.asarray(jcache["pos_map"]))
    for name in ("k", "v"):
        a = np.array(jcache[name].astype(jnp.float32))
        b = tcache[name].float().numpy()
        rms = np.sqrt((a.reshape(len(a), -1) ** 2).mean(-1))
        bound = 2.0 ** -7 * (np.maximum(np.abs(a), np.abs(b))
                             + rms[:, None, None, None, None])
        assert bool((np.abs(a - b) <= bound).all()), name
        if (a != b).any():
            tcache[name].copy_(torch.from_numpy(a))


def _logits(tl, jl, rows=slice(None)):
    np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows],
                               atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "llama3.2-3b", "gemma3-1b"])
def test_monolithic_prefill_matches_jax(need_jax, arch):
    """``prefill`` of a bucket-padded prompt whose positions 3..10 are an
    embedding span, then ``prefill_with_prefix`` of a padded suffix
    against the first 16 positions' K/V (with an embedding span of its
    own): logits, pos_map and the K/V they return against the JAX
    package's."""
    cfg, jm, jp, tm, tp = _models(arch)
    rng = np.random.default_rng(2)
    T, Sb = 21, 32
    toks = np.zeros((1, Sb), np.int64)
    toks[0, :T] = rng.integers(0, cfg.vocab, T)
    feats = rng.normal(size=(1, Sb, cfg.d_model)).astype(np.float32)
    mask = np.zeros((1, Sb), bool)
    mask[0, 3:11] = True
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32),
                             "length": jnp.asarray([T], jnp.int32),
                             "embeds": jnp.asarray(feats),
                             "embed_mask": jnp.asarray(mask)})
    tl, tc = tm.prefill(tp, {"tokens": _t(toks),
                             "length": _t(np.asarray([T], np.int32)),
                             "embeds": _t(feats), "embed_mask": _t(mask)})
    _logits(tl, jl)
    np.testing.assert_array_equal(tc["pos_map"].numpy(),
                                  np.asarray(jc["pos_map"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=1e-4, rtol=1e-4)
    # the suffix of a 30-token prompt after a 16-token prefix hit, padded
    # to 16; its positions 18..19 are an embedding span
    Spre, n_sfx, Cb = 16, 14, 16
    sfx = np.zeros((1, Cb), np.int64)
    sfx[0, :n_sfx] = rng.integers(0, cfg.vocab, n_sfx)
    sfeats = rng.normal(size=(1, Cb, cfg.d_model)).astype(np.float32)
    smask = np.zeros((1, Cb), bool)
    smask[0, 2:4] = True
    pk, pv = (np.asarray(jc[n])[:, :, :Spre] for n in ("k", "v"))
    jl, (jk, jv) = jm.prefill_with_prefix(
        jp, {"tokens": jnp.asarray(sfx, jnp.int32),
             "length": jnp.asarray([n_sfx], jnp.int32),
             "embeds": jnp.asarray(sfeats),
             "embed_mask": jnp.asarray(smask)},
        jnp.asarray(pk), jnp.asarray(pv))
    tl, (tk, tv) = tm.prefill_with_prefix(
        tp, {"tokens": _t(sfx), "length": _t(np.asarray([n_sfx], np.int32)),
             "embeds": _t(sfeats), "embed_mask": _t(smask)},
        _t(pk), _t(pv))
    _logits(tl, jl)
    assert tk.shape == (cfg.n_layers, 1, Cb, cfg.n_kv_heads, cfg.hd)
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "llama3.2-3b", "gemma3-1b"])
def test_dense_chunks_and_decode_match_jax(need_jax, arch):
    """``prefill_chunk_dense`` into two slots of a dense bf16 cache (slot
    0: one padded chunk; slot 2: two chunks, the second padded and
    carrying an embedding span), then three dense ``serve_step`` ticks
    with slot 1 parked at pos = max_seq (its writes drop): logits and the
    whole dense cache against the JAX package's after every call."""
    cfg, jm, jp, tm, tp = _models(arch)
    B, Sa, C = 3, 48, 16
    abstract = jm.abstract_cache(B, Sa)
    jcache = {n: jnp.full(s.shape, -1, s.dtype) if n == "pos_map"
              else jnp.zeros(s.shape, s.dtype) for n, s in abstract.items()}
    tcache = {n: torch.full(s.shape, -1, dtype=s.dtype) if n == "pos_map"
              else torch.zeros(s.shape, dtype=s.dtype)
              for n, s in tm.abstract_cache(B, Sa).items()}
    rng = np.random.default_rng(0)
    chunks = [(0, 0, 11, False), (2, 0, 16, False), (2, 16, 9, True)]
    lengths = {0: 11, 2: 25}
    for slot, pos0, n, media in chunks:
        toks = np.zeros((1, C), np.int64)
        toks[0, :n] = rng.integers(0, cfg.vocab, n)
        batch = {"tokens": toks, "slot": slot, "pos": pos0, "length": n}
        if media:
            mask = np.zeros((1, C), bool)
            mask[0, 1:6] = True
            batch["embeds"] = rng.normal(size=(1, C, cfg.d_model)).astype(
                np.float32)
            batch["embed_mask"] = mask
        jb = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else None)
              for k, v in batch.items()}
        tb = {k: _t(v) if isinstance(v, np.ndarray) else v
              for k, v in batch.items()}
        jl, jcache = jm.prefill_chunk_dense(jp, jcache, jb)
        tl, tcache = tm.prefill_chunk_dense(tp, tcache, tb)
        _logits(tl, jl)
        _hold_dense(jcache, tcache)
    pos = np.asarray([lengths[0], Sa, lengths[2]], np.int64)
    live = [0, 2]
    toks = rng.integers(0, cfg.vocab, B)
    for _ in range(3):
        jl, jcache = jm.serve_step(jp, jcache, {
            "tokens": jnp.asarray(toks, jnp.int32),
            "pos": jnp.asarray(pos, jnp.int32)})
        tl, tcache = tm.serve_step(tp, tcache, {
            "tokens": _t(toks), "pos": _t(pos.astype(np.int32))})
        _logits(tl, jl, live)
        _hold_dense(jcache, tcache)
        toks = np.asarray(jnp.argmax(jl, -1))
        pos[live] += 1


# -------------------------------------------- CUDA kernel vs plain (card)


def _rows_with_keys(cpos, pos, window):
    """[B] slots that see at least one key (the others get the uniform
    average of their slot's value rows)."""
    ok = (cpos >= 0) & (cpos <= pos[:, None])
    if window:
        ok &= (pos[:, None] - cpos) < window
    return ok.any(1)


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


# the CPU cases, then the serving widths: qwen2-0.5b (14/2, D 64) at the
# engine's B 8 and max_seq 1024 with a parked slot, gemma3-1b's local
# layers (4/1, D 256, window 512), llama3.2-3b (24/8, D 128) and the
# reduced configs' D 16
GPU_CASES = CASES + [
    (8, 1024, 14, 2, 64, 0, True),
    (2, 1024, 4, 1, 256, 512, True),
    (2, 512, 24, 8, 128, 0, True),
    (3, 64, 4, 2, 16, 0, True),
    (3, 8192, 16, 2, 64, 0, True),  # scores in global memory
]


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,Hkv,D,window,holes", GPU_CASES)
def test_flash_decode_kernel_matches_plain(cuda, B, S, H, Hkv, D, window,
                                           holes, q_dtype, cache_dtype):
    parked = (B - 1,) if B > 2 else ()
    q, kc, vc, cpos, pos = _decode_inputs(B, S, H, Hkv, D, holes, seed=5,
                                          parked=parked)
    qdt, cdt = getattr(torch, q_dtype), getattr(torch, cache_dtype)
    args = [_t(a, d, cuda) for a, d in ((q, qdt), (kc, cdt), (vc, cdt),
                                        (cpos, None), (pos, None))]
    before = ops.flash_decode.launches
    kw = dict(window=window)
    out = ops.flash_decode(*args, **kw)
    torch.cuda.synchronize()
    assert ops.flash_decode.launches == before + 1
    assert out.dtype == qdt and out.shape == (B, H, D)
    rows = _rows_with_keys(cpos, pos, window)
    if cache_dtype == "bfloat16":  # probabilities rounded to bf16
        hold_rounded(out, flash_decode_ref, args, kw, rows)
    else:  # fp32 caches round nothing: the plain version is the exact twin
        want = flash_decode_ref(*_widened(args), **kw)
        np.testing.assert_allclose(_np(out)[rows], _np(want)[rows],
                                   **EXACT_TOL[q_dtype])
    _hold_dead_rows(out, flash_decode_ref, args, ~rows, kw, q_dtype)
    # against the plain version in the working type: both round the
    # probabilities to the cache type (either may round one the other
    # way), so the bf16 tolerance of test_kv_cache.py
    if cache_dtype == "bfloat16":
        work = flash_decode_ref(*args, **kw)
        np.testing.assert_allclose(_np(out)[rows], _np(work)[rows],
                                   **KERNEL_TOL["bfloat16"])


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,Hkv,D,window,holes", GPU_CASES)
def test_flash_decode_quant_kernel_matches_plain(cuda, B, S, H, Hkv, D,
                                                 window, holes, q_dtype):
    parked = (B - 1,) if B > 2 else ()
    q, kc, vc, cpos, pos = _decode_inputs(B, S, H, Hkv, D, holes, seed=9,
                                          parked=parked)
    k8, ks = quantize_kv(_t(kc, torch.bfloat16, cuda))
    v8, vs = quantize_kv(_t(vc, torch.bfloat16, cuda))
    # entries past each prompt hold poisoned scales: never read unmasked
    empty = _t(cpos < 0, None, cuda)
    ks[empty], vs[empty] = 1e6, 1e6
    args = (_t(q, getattr(torch, q_dtype), cuda), k8, v8, ks, vs,
            _t(cpos, None, cuda), _t(pos, None, cuda))
    before = ops.flash_decode_quant.launches
    out = ops.flash_decode_quant(*args, window=window)
    torch.cuda.synchronize()
    assert ops.flash_decode_quant.launches == before + 1
    rows = _rows_with_keys(cpos, pos, window)
    want = flash_decode_quant_ref(*_widened(args), window=window)
    np.testing.assert_allclose(_np(out)[rows], _np(want)[rows],
                               **EXACT_TOL[q_dtype])
    np.testing.assert_allclose(_np(out)[rows], _np(want)[rows], **QUANT_TOL)
    _hold_dead_rows(out, flash_decode_quant_ref, args, ~rows,
                    dict(window=window), q_dtype)
    assert bool(torch.isfinite(out.float()).all())


@pytest.mark.gpu
def test_flash_decode_kernel_rejects_what_it_cannot_take(cuda):
    def args(H, D, cache_dtype=torch.bfloat16, S=64):
        q, kc, vc, cpos, pos = _decode_inputs(2, S, H, 2, D, True, seed=0)
        return [_t(a, d, cuda) for a, d in ((q, None), (kc, cache_dtype),
                                            (vc, cache_dtype), (cpos, None),
                                            (pos, None))]
    with pytest.raises(ValueError):  # head dim 48 is not supported
        ops.flash_decode(*args(8, 48))
    with pytest.raises(ValueError):  # G = 17 query heads per kv head
        ops.flash_decode(*args(34, 64))
    with pytest.raises(ValueError):  # int8 caches need the quant wrapper
        ops.flash_decode(*args(8, 64, torch.int8))
    bad = args(8, 64)
    bad[4] = bad[4].long()  # int64 positions
    with pytest.raises(ValueError):
        ops.flash_decode(*bad)
    bad = args(8, 64)
    bad[1] = bad[1].transpose(1, 2).contiguous().transpose(1, 2)  # strided
    with pytest.raises(ValueError):
        ops.flash_decode(*bad)
    ops.flash_decode(*args(8, 64))  # and the same call as it should be


@pytest.mark.gpu
def test_dense_step_on_the_card_matches_the_cpu(cuda):
    """The dense decode step of a reduced fp32 model on the card (the
    kernel over a bf16 cache) against the CPU (the plain version), one
    launch per layer: logits within 1e-2, because the plain version rounds
    its probabilities to the cache's bf16 before the value product and the
    kernel keeps them in fp32 (2^-9 relative per probability, which moved
    the logits by up to 4.7e-3 on an H100), and the same argmax wherever
    the top two logits are more than 2e-2 apart."""
    model = build_model(reduced(get_config("gemma3-1b"),
                                act_dtype="float32"))
    cpu_params = model.init(0, param_dtype=torch.float32, device="cpu")
    gpu_params = _on(cpu_params, cuda)
    B, Sa = 3, 64
    caches = {}
    rng = np.random.default_rng(1)
    toks = rng.integers(0, model.cfg.vocab, (1, 32))
    for dev, params in (("cpu", cpu_params), (cuda, gpu_params)):
        cache = {n: torch.full(s.shape, -1, dtype=s.dtype, device=dev)
                 if n == "pos_map" else torch.zeros(s.shape, dtype=s.dtype,
                                                    device=dev)
                 for n, s in model.abstract_cache(B, Sa).items()}
        for slot, n in ((0, 30), (2, 17)):
            model.prefill_chunk_dense(params, cache, {
                "tokens": _t(toks, None, dev), "slot": slot, "pos": 0,
                "length": n})
        caches[str(dev)] = (params, cache)
    pos = np.asarray([30, Sa, 17], np.int32)
    ids = np.asarray([5, 0, 7])
    for _ in range(4):
        before = ops.flash_decode.launches
        outs = {}
        for dev, (params, cache) in caches.items():
            logits, _ = model.serve_step(params, cache, {
                "tokens": _t(ids, None, dev), "pos": _t(pos, None, dev)})
            outs[dev] = logits.cpu()
        assert ops.flash_decode.launches == before + model.cfg.n_layers
        np.testing.assert_allclose(outs["cuda"].numpy()[[0, 2]],
                                   outs["cpu"].numpy()[[0, 2]], atol=1e-2,
                                   rtol=1e-2)
        ids = torch.argmax(outs["cpu"], -1).numpy()
        top2 = torch.topk(outs["cpu"], 2, -1).values
        clear = ((top2[:, 0] - top2[:, 1]) > 2e-2).numpy()
        for b in (0, 2):
            if clear[b]:
                assert int(torch.argmax(outs["cuda"][b])) == ids[b]
        pos[[0, 2]] += 1


def _on(tree, device):
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    return tree.to(device)
