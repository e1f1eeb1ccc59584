"""Port of the MoE family against the JAX package: the plain grouped
matmul held to the JAX Pallas kernel (interpret mode) and its oracle;
``models.moe.moe_apply`` and ``moe_reference`` held to their JAX twins
(expert ids, capacity drops, ties, shared experts, ``moe_scan_chunks``);
the model steps of the reduced granite-moe-1b-a400m and qwen2-moe-a2.7b
(bucketed ``prefill``, ``prefill_with_prefix``, ``prefill_chunk_paged``/
``_dense``, ``serve_step(_paged)``, ``verify_step_paged``) on the same
fp32 weights (``from_jax_params``); and the serving engine (paged chunked
and monolithic, dense, int8, speculative with an MoE target and an MoE
draft, overflowing experts with free slots) against the JAX engine's
``Request.output``.  On a CUDA card only: the hand-written grouped-matmul
kernel held to its plain version at the CPU cases and at granite's and
qwen2-moe's expert shapes; rows with no visible key of the three
attention kernels held to their plain versions (a free slot's token is
routed by the MoE layer); and the CPU and CUDA engines giving identical
tokens when experts overflow.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs on the CPU on any host (``need_jax``).

Tolerances (each with its reason):
* plain grouped matmul vs the JAX oracle: the same fp32 products summed
  in another order (fp32: 1e-4 absolute on outputs of magnitude ~10,
  1e-5 relative); a bf16 output may round the other way by one bf16 ulp
  (2^-7 relative, 1e-2 absolute); vs the Pallas kernel test_kernels.py's
  own tolerances (1e-3 fp32; 1e-2 / 5e-2 bf16);
* ``moe_apply``/``moe_reference`` in fp32: expert ids exactly, outputs
  1e-5 absolute (matmuls summed in other orders, values of magnitude ~1);
* model steps: logits 1e-3 and caches as test_torch_model.py and
  test_torch_dense.py state (fp32 values differing in their last bits
  round to neighbouring bf16 values or int8 steps);
* engines: identical greedy tokens;
* the CUDA kernel vs its plain version on the card: against the plain
  version on the same values in fp32, one bf16 ulp (2^-7 relative) for a
  bf16 output (the kernel rounds its fp32 sum once, as the plain version
  does) and 1e-4 relative for fp32, plus 1e-3 absolute for the summation
  order of up to 2048 products of unit normals; in the working type
  test_kernels.py's 1e-2 / 5e-2;
* a row with no visible key: the same uniform weights over the same value
  rows summed in another order, so the tolerance is relative to the mean
  |v| of those rows (the plain version on |v|): one bf16 ulp for a bf16
  output, 1e-4 for fp32.
"""
import dataclasses
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
    from repro.kernels import ref as jref
    from repro.models import build_model as jbuild
    from repro.models import lm as jlm
    from repro.models import moe as jmoe
    from repro.serving.engine import Request as JRequest
    from repro.serving.engine import ServingEngine as JEngine
except ImportError:  # JAX (the reference) is not installed
    jax = None

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import (flash_decode_quant_ref,
                                              flash_decode_ref)
from repro_torch.kernels.moe_gmm import grouped_matmul_ref
from repro_torch.kernels.paged_decode import (paged_decode_quant_ref,
                                              paged_decode_ref)
from repro_torch.kernels.paged_verify import (paged_verify_quant_ref,
                                              paged_verify_ref)
from repro_torch.kernels.quant import quantize_kv
from repro_torch.models import lm, moe
from repro_torch.models.api import build_model
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.weights import from_jax_params
from test_torch_kernels import hold_rounded

ARCHS = ["granite-moe-1b-a400m", "qwen2-moe-a2.7b"]
# test_kernels.py::test_grouped_matmul's sweep (E, C, K, N)
GMM_CASES = [(4, 48, 96, 40), (8, 16, 64, 128), (2, 130, 70, 90)]
PLAIN_TOL = {"float32": dict(atol=1e-4, rtol=1e-5),
             "bfloat16": dict(atol=1e-2, rtol=2 ** -7)}
KERNEL_TOL = {"float32": dict(atol=1e-3, rtol=1e-3),
              "bfloat16": dict(atol=1e-2, rtol=5e-2)}
EXACT_TOL = {"float32": dict(atol=1e-3, rtol=1e-4),
             "bfloat16": dict(atol=1e-3, rtol=2 ** -7)}
DEAD_TOL = {"float32": dict(atol=1e-5, rtol=1e-4),
            "bfloat16": dict(atol=1e-5, rtol=2 ** -7)}


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


# ------------------------------------------------------- grouped matmul


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,K,N", GMM_CASES)
def test_grouped_matmul_plain_matches_jax(need_jax, E, C, K, N, dtype):
    rng = np.random.default_rng(42)
    x = rng.normal(size=(E, C, K)).astype(np.float32)
    w = rng.normal(size=(E, K, N)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    out = ops.grouped_matmul(_t(x, tdt), _t(w, tdt))
    assert out.dtype == tdt and out.shape == (E, C, N)
    np.testing.assert_allclose(_np(out), _np(jref.grouped_matmul_ref(jx, jw)),
                               **PLAIN_TOL[dtype])
    kern = jops.grouped_matmul(jx, jw, block_c=32, block_n=32, block_k=32)
    np.testing.assert_allclose(_np(out), _np(kern), **KERNEL_TOL[dtype])


def test_grouped_matmul_runs_plain_version_on_cpu_only():
    rng = np.random.default_rng(0)
    x = _t(rng.normal(size=(4, 48, 96)).astype(np.float32))
    w = _t(rng.normal(size=(4, 96, 40)).astype(np.float32))
    before = ops.grouped_matmul.launches
    assert torch.equal(ops.grouped_matmul(x, w), grouped_matmul_ref(x, w))
    assert ops.grouped_matmul.launches == before  # no kernel on the CPU
    with pytest.raises(ValueError):  # a tensor on no CPU or CUDA device
        ops.grouped_matmul(x, w.to("meta"))


def _gmm_tc_emulation(x, w, splits=1, bk=64):
    """The bf16 tensor-core instantiations of ``csrc/moe_gmm.cu`` in their
    own order, on the CPU: exact bf16 products summed in fp32 as 16-deep
    blocks in ascending K; with ``splits``, K cut at ``bk``-deep steps
    into that many ranges whose fp32 partials are summed in order (the
    kernel's split of K); rounded once to bf16."""
    E, C, K = x.shape
    xf, wf = x.float(), w.float()
    steps = -(-K // bk)
    per = -(-steps // splits)
    out = torch.zeros(E, C, w.shape[2])
    for k_lo in range(0, K, per * bk):
        part = torch.zeros_like(out)
        for k0 in range(k_lo, min(K, k_lo + per * bk), 16):
            part = part + xf[:, :, k0:k0 + 16] @ wf[:, k0:k0 + 16]
        out = out + part
    return out.bfloat16()


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("E,C,K,N", GMM_CASES)
def test_grouped_matmul_tc_arithmetic_within_exact_tol(E, C, K, N, splits):
    """The bf16 kernel's k16-blocked fp32 accumulation (K split or not),
    emulated on the CPU, stays within EXACT_TOL of the fp32 plain version
    on the widened inputs (what the card's kernel is held to)."""
    rng = np.random.default_rng(42)
    x = _t(rng.normal(size=(E, C, K)), torch.bfloat16)
    w = _t(rng.normal(size=(E, K, N)), torch.bfloat16)
    got = _gmm_tc_emulation(x, w, splits, bk=32 if C > 64 else 64)
    assert got.dtype == torch.bfloat16 and got.shape == (E, C, N)
    np.testing.assert_allclose(
        _np(got), _np(grouped_matmul_ref(x.float(), w.float())),
        **EXACT_TOL["bfloat16"])


# ------------------------------------------------------------ moe_apply


def _moe_params(d=32, E=8, ff=24, shared_ff=40, seed=0):
    """One layer's MoE weights (numpy, fp32) at the spec's shapes and
    scales; the shared expert's only with ``shared_ff``."""
    rng = np.random.default_rng(seed)
    spec = moe.moe_spec(1, d, E, ff, shared_ff)
    return {k: (rng.normal(size=s.shape[1:]) * s.scale).astype(np.float32)
            for k, s in spec.items()}


def _tokens(T=48, d=32, seed=1):
    """Token rows with two all-zero rows (a uniform router: every expert
    ties, and the lower ids must win)."""
    x = np.random.default_rng(seed).normal(size=(T, d)).astype(np.float32)
    x[[5, 17]] = 0.0
    return x


@pytest.mark.parametrize("capacity_factor", [100.0, 1.25, 0.3])
@pytest.mark.parametrize("norm_topk", [True, False])
@pytest.mark.parametrize("shared", [True, False])
def test_moe_apply_matches_jax(need_jax, shared, norm_topk,
                               capacity_factor):
    """Expert ids equal (ties included), outputs within 1e-5, with no
    drop (100), the default factor (1.25) and heavy drops (0.3)."""
    p = _moe_params(shared_ff=40 if shared else 0)
    x = _tokens()
    kw = dict(top_k=4, norm_topk=norm_topk, capacity_factor=capacity_factor)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    _, jids = jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(x) @ jp["router"], axis=-1), 4)
    _, _, tids = moe._route(tp, _t(x), 4, norm_topk)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tids.numpy()[5], [0, 1, 2, 3])
    want = jmoe.moe_apply(jp, jnp.asarray(x), **kw)
    got = moe.moe_apply(tp, _t(x), **kw)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    C = moe.capacity(48, 8, 4, capacity_factor)
    assert C == jmoe.capacity(48, 8, 4, capacity_factor)
    if capacity_factor == 0.3:  # tokens were dropped: the oracle differs
        ref = moe.moe_reference(tp, _t(x), top_k=4, norm_topk=norm_topk)
        assert C == 8 and not torch.allclose(got, ref, atol=1e-3)


@pytest.mark.parametrize("shared", [True, False])
def test_moe_reference_matches_jax(need_jax, shared):
    p = _moe_params(shared_ff=40 if shared else 0, seed=3)
    x = _tokens(seed=4)
    want = jmoe.moe_reference({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), top_k=2, norm_topk=False)
    tp = {k: _t(v) for k, v in p.items()}
    got = moe.moe_reference(tp, _t(x), top_k=2, norm_topk=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    # without drops the sort-based dispatch is the dense oracle
    np.testing.assert_allclose(
        moe.moe_apply(tp, _t(x), top_k=2, norm_topk=False,
                      capacity_factor=100.0).numpy(), got.numpy(),
        atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch,scan_chunks,axes", [
    ("granite-moe-1b-a400m", 2, None),   # two chunks of 64 tokens
    ("qwen2-moe-a2.7b", 4, None),        # four chunks of 32 tokens
    ("granite-moe-1b-a400m", 0, ("data",)),  # capacity aligned to 128
])
def test_ffn_scan_chunks_and_dispatch_axes_match_jax(need_jax, arch,
                                                     scan_chunks, axes):
    """``lm._ffn`` on [B, S, d] with ``moe_scan_chunks`` (the tokens go
    through the MoE block chunk by chunk, each chunk with its own
    capacity) or ``moe_dispatch_axes`` (capacity aligned to 128, no pin
    on one device), against the JAX ``_ffn``."""
    over = dict(act_dtype="float32", moe_scan_chunks=scan_chunks,
                moe_dispatch_axes=axes, capacity_factor=0.5)
    jcfg = jreduced(jget_config(arch), **over)
    tcfg = reduced(get_config(arch), **over)
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0), param_dtype=jnp.float32)
    layer0 = jax.tree.map(lambda a: np.asarray(a[0]), jp["layers"])
    x = np.random.default_rng(5).normal(size=(2, 64, 64)).astype(np.float32)
    x[0, 3] = 0.0
    if axes:  # the JAX function pins the capacity dim to a mesh axis
        mesh = jax.sharding.Mesh(np.asarray(jax.devices("cpu")[:1]),
                                 ("data",))
        with mesh:
            want = jax.jit(lambda p, v: jlm._ffn(p, jcfg, v))(
                layer0, jnp.asarray(x))
    else:
        want = jlm._ffn(layer0, jcfg, jnp.asarray(x))
    got = lm._ffn(from_jax_params(layer0, device="cpu"), tcfg, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_moe_apply_refuses_tensor_parallel():
    """``tp_axis`` is served (``distributed/tp.py``): in the two ranks of
    a gloo group, expert parallelism (4 of 8 experts a rank) and the
    expert-ff fallback (half of every expert's and the shared expert's ff
    columns a rank) give the unsharded layer's output bit for bit (fp32,
    drops at capacity factor 1.25 included).  Outside ``ShardedServing``'s
    binding of its axis a tensor-parallel layer refuses to run."""
    from repro_torch.distributed import runs, tp
    p_np, x_np = _moe_params(), _tokens()
    kw = dict(top_k=4, norm_topk=True, capacity_factor=1.25)
    modes = {"experts": ("experts",),
             "expert_ff": ("expert_ff", "shared_ff")}
    got = tp.spawn(runs.moe_layers, 2, "gloo", p_np, x_np, kw, modes)
    p = {k: _t(v) for k, v in p_np.items()}
    want = moe.moe_apply(p, _t(x_np), **kw)
    for name in modes:
        assert torch.equal(got[name], want), name
    with pytest.raises(RuntimeError, match="not bound"):
        moe.moe_apply(p, _t(x_np), top_k=4, norm_topk=True,
                      tp_axis="model", tp_shards=("experts",))


# ------------------------------------------------------------ model steps


@functools.cache
def _models(arch, **over):
    cfg = jreduced(jget_config(arch), act_dtype="float32", **over)
    jm = jbuild(cfg)
    jp = jm.init(jax.random.PRNGKey(0), param_dtype=jnp.float32)
    tm = build_model(reduced(get_config(arch), act_dtype="float32", **over))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jm, jp, tm, tp


def _logits(tl, jl, rows=slice(None)):
    np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows],
                               atol=1e-3, rtol=1e-3)


def _hold_cache(jcache, tcache, skip_null_page=True):
    """pos_map exactly; bf16 leaves within one bf16 ulp of the larger value
    plus one of the leaf's RMS, int8 within one step, scales rtol 4e-6
    (the reasons test_torch_model.py and test_torch_dense.py give).  The
    paged pools' null page is not compared: inactive slots all write its
    row 0 in an order neither package fixes.  Where leaves differ at all,
    the JAX values are copied into the port's so the next step starts
    equal."""
    for name, leaf in jcache.items():
        a = np.asarray(leaf.astype(jnp.float32))
        b = tcache[name].float().numpy()
        if skip_null_page and name != "pos_map" and name not in ("k", "v"):
            a, b = a[:, 1:], b[:, 1:]
        if name == "pos_map":
            np.testing.assert_array_equal(b, a)
        elif name.endswith("scales"):
            np.testing.assert_allclose(b, a, rtol=4e-6, atol=0)
        elif leaf.dtype == jnp.int8:
            assert np.abs(a - b).max() <= 1, name
        else:
            rms = np.sqrt((a ** 2).mean())
            bound = 2.0 ** -7 * (np.maximum(np.abs(a), np.abs(b)) + rms)
            assert bool((np.abs(a - b) <= bound).all()), name
        if (a != b).any():
            tcache[name].copy_(torch.from_numpy(
                np.asarray(leaf.astype(jnp.float32))).to(tcache[name].dtype))


@pytest.mark.parametrize("arch", ARCHS)
def test_monolithic_prefill_matches_jax(need_jax, arch):
    """A bucket-padded ``prefill`` (the padding's tokens compete for the
    experts' capacity too), then ``prefill_with_prefix`` of a padded
    suffix against the first 16 positions' K/V."""
    cfg, jm, jp, tm, tp = _models(arch)
    rng = np.random.default_rng(2)
    T, Sb = 27, 32
    toks = np.zeros((1, Sb), np.int64)
    toks[0, :T] = rng.integers(0, cfg.vocab, T)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32),
                             "length": jnp.asarray([T], jnp.int32)})
    tl, tc = tm.prefill(tp, {"tokens": _t(toks),
                             "length": _t(np.asarray([T], np.int32))})
    _logits(tl, jl)
    np.testing.assert_array_equal(tc["pos_map"].numpy(),
                                  np.asarray(jc["pos_map"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=1e-4, rtol=1e-4)
    Spre, n_sfx, Cb = 16, 11, 16
    sfx = np.zeros((1, Cb), np.int64)
    sfx[0, :n_sfx] = rng.integers(0, cfg.vocab, n_sfx)
    pk, pv = (np.asarray(jc[n])[:, :, :Spre] for n in ("k", "v"))
    jl, (jk, jv) = jm.prefill_with_prefix(
        jp, {"tokens": jnp.asarray(sfx, jnp.int32),
             "length": jnp.asarray([n_sfx], jnp.int32)},
        jnp.asarray(pk), jnp.asarray(pv))
    tl, (tk, tv) = tm.prefill_with_prefix(
        tp, {"tokens": _t(sfx), "length": _t(np.asarray([n_sfx], np.int32))},
        _t(pk), _t(pv))
    _logits(tl, jl)
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)


def _paged(jm, tm, P, bs, kv_dtype):
    abstract = jm.abstract_paged_cache(P, bs, kv_dtype=kv_dtype)
    jcache = {n: jnp.zeros(s.shape, s.dtype) for n, s in abstract.items()}
    tcache = {n: torch.zeros(s.shape, dtype=s.dtype)
              for n, s in tm.abstract_paged_cache(P, bs, kv_dtype).items()}
    return jcache, tcache


def _chunk_paged(cfg, jm, jp, tm, tp, jcache, tcache, row, toks, C):
    """Prefill ``toks`` into the table ``row`` in C-token chunks (the last
    one padded); returns the last logits' argmax."""
    done = 0
    while done < len(toks):
        n = min(C, len(toks) - done)
        padded = np.zeros(C, np.int64)
        padded[:n] = toks[done:done + n]
        jl, jcache = jm.prefill_chunk_paged(jp, jcache, {
            "tokens": jnp.asarray(padded, jnp.int32)[None],
            "block_tables": jnp.asarray(row)[None],
            "pos": jnp.asarray(done, jnp.int32),
            "length": jnp.asarray(n, jnp.int32)})
        tl, tcache = tm.prefill_chunk_paged(tp, tcache, {
            "tokens": _t(padded)[None], "block_tables": _t(row)[None],
            "pos": done, "length": n})
        _logits(tl, jl)
        _hold_cache(jcache, tcache)
        done += n
    return jcache, int(np.argmax(np.asarray(jl)[0]))


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_chunks_and_decode_match_jax(need_jax, arch, kv_dtype):
    """Paged prefill chunks of 16 (the padded columns are routed too) into
    two slots, then three ``serve_step_paged`` ticks with slot 1 free
    (null table)."""
    cfg, jm, jp, tm, tp = _models(arch)
    NB, bs = 8, 8
    jcache, tcache = _paged(jm, tm, 12, bs, kv_dtype)
    rng = np.random.default_rng(0)
    tables = np.full((3, NB), -1, np.int32)
    tables[0, :4], tables[2, :5] = [3, 1, 5, 7], [2, 4, 6, 8, 9]
    pos = np.asarray([21, 0, 37], np.int32)
    last = np.zeros(3, np.int64)
    for slot in (0, 2):
        toks = rng.integers(0, cfg.vocab, int(pos[slot]))
        jcache, last[slot] = _chunk_paged(cfg, jm, jp, tm, tp, jcache,
                                          tcache, tables[slot], toks, 16)
    for _ in range(3):
        jl, jcache = jm.serve_step_paged(jp, jcache, {
            "tokens": jnp.asarray(last, jnp.int32), "pos": jnp.asarray(pos),
            "block_tables": jnp.asarray(tables)})
        tl, tcache = tm.serve_step_paged(tp, tcache, {
            "tokens": _t(last), "pos": _t(pos), "block_tables": _t(tables)})
        _logits(tl, jl, [0, 2])
        _hold_cache(jcache, tcache)
        last = np.asarray(jnp.argmax(jl, -1)).astype(np.int64)
        pos[[0, 2]] += 1


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_chunks_and_decode_match_jax(need_jax, arch):
    """``prefill_chunk_dense`` into two slots of a dense cache, then three
    dense ``serve_step`` ticks with slot 1 parked at pos = max_seq."""
    cfg, jm, jp, tm, tp = _models(arch)
    B, Sa, C = 3, 48, 16
    jcache = {n: jnp.full(s.shape, -1, s.dtype) if n == "pos_map"
              else jnp.zeros(s.shape, s.dtype)
              for n, s in jm.abstract_cache(B, Sa).items()}
    tcache = {n: torch.full(s.shape, -1, dtype=s.dtype) if n == "pos_map"
              else torch.zeros(s.shape, dtype=s.dtype)
              for n, s in tm.abstract_cache(B, Sa).items()}
    rng = np.random.default_rng(1)
    for slot, pos0, n in ((0, 0, 11), (2, 0, 16), (2, 16, 9)):
        toks = np.zeros((1, C), np.int64)
        toks[0, :n] = rng.integers(0, cfg.vocab, n)
        jl, jcache = jm.prefill_chunk_dense(jp, jcache, {
            "tokens": jnp.asarray(toks, jnp.int32), "slot": slot,
            "pos": pos0, "length": n})
        tl, tcache = tm.prefill_chunk_dense(tp, tcache, {
            "tokens": _t(toks), "slot": slot, "pos": pos0, "length": n})
        _logits(tl, jl)
        _hold_cache(jcache, tcache, skip_null_page=False)
    pos = np.asarray([11, Sa, 25], np.int64)
    toks = rng.integers(0, cfg.vocab, B)
    for _ in range(3):
        jl, jcache = jm.serve_step(jp, jcache, {
            "tokens": jnp.asarray(toks, jnp.int32),
            "pos": jnp.asarray(pos, jnp.int32)})
        tl, tcache = tm.serve_step(tp, tcache, {
            "tokens": _t(toks), "pos": _t(pos.astype(np.int32))})
        _logits(tl, jl, [0, 2])
        _hold_cache(jcache, tcache, skip_null_page=False)
        toks = np.asarray(jnp.argmax(jl, -1))
        pos[[0, 2]] += 1


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_verify_step_matches_jax(need_jax, arch, kv_dtype):
    """Two verify passes of T = 4 over three prefilled slots and a free
    slot (null table, pos 0): 16 tokens against a capacity of 8, so the
    free slot's rows compete for the experts with the live ones."""
    cfg, jm, jp, tm, tp = _models(arch)
    NB, bs, T = 6, 8, 4
    jcache, tcache = _paged(jm, tm, 16, bs, kv_dtype)
    tables = np.full((4, NB), -1, np.int32)
    for slot, pages in {0: [3, 1, 5, 7], 2: [2, 4, 6, 8, 9, 10],
                        3: [11, 12, 13]}.items():
        tables[slot, :len(pages)] = pages
    rng = np.random.default_rng(0)
    pos = np.asarray([21, 0, 30, 14], np.int32)
    for slot in (0, 2, 3):
        toks = rng.integers(0, cfg.vocab, int(pos[slot]))
        jcache, _ = _chunk_paged(cfg, jm, jp, tm, tp, jcache, tcache,
                                 tables[slot], toks, 32)
    live = [0, 2, 3]
    for _ in range(2):
        toks = rng.integers(0, cfg.vocab, (4, T))
        jl, jcache = jm.verify_step_paged(jp, jcache, {
            "tokens": jnp.asarray(toks, jnp.int32), "pos": jnp.asarray(pos),
            "block_tables": jnp.asarray(tables)})
        tl, tcache = tm.verify_step_paged(tp, tcache, {
            "tokens": _t(toks), "pos": _t(pos), "block_tables": _t(tables)})
        assert tl.shape == (4, T, cfg.vocab)
        _logits(tl, jl, live)
        _hold_cache(jcache, tcache)
        pos[live] += 3


def test_moe_configs_build_specs():
    """granite-moe: 32 experts of 512 at d 1024, no shared expert;
    qwen2-moe: 60 experts of 1408 and a shared expert of 5632 at d 2048;
    the layers hold ``moe`` and no ``mlp``."""
    g = build_model(get_config("granite-moe-1b-a400m")).spec["layers"]
    q = build_model(get_config("qwen2-moe-a2.7b")).spec["layers"]
    assert "mlp" not in g and "mlp" not in q
    assert g["moe"]["w_gate"].shape == (24, 32, 1024, 512)
    assert g["moe"]["w_down"].shape == (24, 32, 512, 1024)
    assert "shared_gate" not in g["moe"]
    assert q["moe"]["w_up"].shape == (24, 60, 2048, 1408)
    assert q["moe"]["shared_down"].shape == (24, 5632, 2048)
    assert q["moe"]["shared_router"].shape == (24, 2048, 1)


# ------------------------------------------------------------- engines


def _mixed(vocab, n=6, seed=3):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 16).astype(np.int32)
    prompts = [rng.integers(0, vocab, m).astype(np.int32)
               for m in (6, 21, 33, 9)[:n]]
    prompts += [np.concatenate([shared, rng.integers(0, vocab, 3)
                                .astype(np.int32)]) for _ in range(2)]
    return prompts


def _serve(engine_cls, request_cls, model, params, prompts, new=8, **kw):
    eng = engine_cls(model, params, **{**dict(max_batch=2, max_seq=64,
                                              page_size=8), **kw})
    reqs = [request_cls(i, p, max_new_tokens=new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return eng, [tuple(r.output) for r in reqs]


def _one_layer(cfg, params):
    """A 1-layer cut of a model (JAX or port): its embed, layer 0 and
    final norm."""
    return (dataclasses.replace(cfg, n_layers=1),
            {**params, "layers": _tree(lambda a: a[:1], params["layers"])})


ENGINE_CASES = [
    ("granite-moe-1b-a400m", dict(prefill_chunk=16), {}),
    ("qwen2-moe-a2.7b", dict(prefill_chunk=16), {}),
    ("granite-moe-1b-a400m", dict(prefill_chunk=0), {}),
    ("qwen2-moe-a2.7b", dict(prefill_chunk=0, kv_dtype="int8"), {}),
    ("granite-moe-1b-a400m", dict(paged=False, prefill_chunk=16), {}),
    ("qwen2-moe-a2.7b", dict(paged=False, prefill_chunk=0), {}),
    ("granite-moe-1b-a400m", dict(prefill_chunk=16, kv_dtype="int8"), {}),
    # speculation: the MoE target drafts itself, or a 1-layer MoE draft
    ("granite-moe-1b-a400m", dict(prefill_chunk=16, spec_k=3, draft="self"),
     {}),
    ("qwen2-moe-a2.7b", dict(prefill_chunk=16, spec_k=3, draft="one_layer"),
     {}),
    # experts overflow: a lowered capacity factor, free slots beside live
    # ones in decode ticks (16 slots: 16 tokens, 8 a expert on average,
    # against a capacity of 8) and in verify passes (3 slots x 4 tokens)
    ("granite-moe-1b-a400m", dict(prefill_chunk=16, max_batch=16),
     dict(capacity_factor=0.3)),
    ("granite-moe-1b-a400m", dict(prefill_chunk=16, max_batch=3, spec_k=3,
                                  draft="one_layer"),
     dict(capacity_factor=0.3)),
]


@pytest.mark.parametrize("arch,kw,over", ENGINE_CASES)
def test_engine_matches_jax(need_jax, arch, kw, over):
    cfg, jm, jp, tm, tp = _models(arch, **over)
    prompts = _mixed(cfg.vocab)
    jkw, tkw = dict(kw), dict(kw, device="cpu")
    draft = kw.get("draft")
    if draft:
        del jkw["draft"], tkw["draft"]
        jd = (cfg, jp) if draft == "self" else _one_layer(cfg, jp)
        td = (tm.cfg, tp) if draft == "self" else _one_layer(tm.cfg, tp)
        jkw.update(draft_config=jd[0], draft_params=jd[1])
        tkw.update(draft_config=td[0], draft_params=td[1])
    jeng, want = _serve(JEngine, JRequest, jm, jp, prompts, **jkw)
    eng, got = _serve(ServingEngine, Request, tm, tp, prompts, **tkw)
    assert got == want
    js, ts = jeng.stats(), eng.stats()
    for key in ("decode_tokens", "prefix_hits", "prefill_tokens_computed",
                "spec_tokens_accepted"):
        assert ts.get(key) == js.get(key), key
    if draft:
        assert ts["verify_steps"] > 0 and ts["draft_steps"] > 0


# -------------------------------------------- CUDA kernel vs plain (card)


# the CPU cases, then the serving shapes: granite-moe-1b-a400m (E 32,
# d 1024, expert ff 512) gate/up and down at C 8 (a decode tick), 16 (a
# verify pass), 24 (a 64-token chunk) and 320 (a 1024-token bucket);
# qwen2-moe-a2.7b (E 60, d 2048, ff 1408) at C 8 and 88
GPU_GMM_CASES = GMM_CASES + [
    (32, C, K, N) for C in (8, 16, 24, 320)
    for K, N in ((1024, 512), (512, 1024))] + [
    (60, C, K, N) for C in (8, 88) for K, N in ((2048, 1408), (1408, 2048))]
# the edges of the bf16 instantiations: one token (at E 4 the grid has
# fewer CTAs than the card has SMs, so K is split), one past the small-C
# tile (C 17), and unaligned K through the small-C and chunk tiles
GPU_GMM_CASES += [(4, 1, 512, 256), (32, 1, 1024, 512), (4, 17, 512, 256),
                  (32, 17, 1024, 512), (3, 5, 70, 64), (2, 40, 70, 96)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,K,N", GPU_GMM_CASES)
def test_grouped_matmul_kernel_matches_plain(cuda, E, C, K, N, dtype):
    gen = torch.Generator(device=cuda).manual_seed(E * C + K)
    x = torch.randn(E, C, K, device=cuda, generator=gen)
    w = torch.randn(E, K, N, device=cuda, generator=gen)
    dt = getattr(torch, dtype)
    xd, wd = x.to(dt), w.to(dt)
    before = ops.grouped_matmul.launches
    out = ops.grouped_matmul(xd, wd)
    torch.cuda.synchronize()
    assert ops.grouped_matmul.launches == before + 1
    assert out.dtype == dt and out.shape == (E, C, N)
    exact = grouped_matmul_ref(xd.float(), wd.float())
    np.testing.assert_allclose(_np(out), _np(exact), **EXACT_TOL[dtype])
    np.testing.assert_allclose(_np(out), _np(grouped_matmul_ref(xd, wd)),
                               **KERNEL_TOL[dtype])


@pytest.mark.gpu
def test_grouped_matmul_kernel_reads_layer_views_in_place(cuda):
    """A layer's [E, K, N] view of a stacked [L, E, K, N] leaf goes to the
    kernel as it is (no copy), unaligned ragged shapes run scalar loads,
    and what the kernel cannot take raises."""
    w = torch.randn(3, 4, 70, 90, device=cuda)
    x = torch.randn(4, 13, 70, device=cuda)
    out = ops.grouped_matmul(x, w[1])
    np.testing.assert_allclose(_np(out), _np(grouped_matmul_ref(x, w[1])),
                               **EXACT_TOL["float32"])
    with pytest.raises(ValueError):  # mixed types
        ops.grouped_matmul(x.bfloat16(), w[1])
    with pytest.raises(ValueError):  # K mismatch
        ops.grouped_matmul(x[..., :64], w[1])
    with pytest.raises(ValueError):  # not contiguous
        ops.grouped_matmul(x, w[1].transpose(1, 2))
    with pytest.raises(ValueError):  # one tensor on the CPU
        ops.grouped_matmul(x, w[1].cpu())


def _hold_dead(out, plain, args, dead, kw, dtype):
    """Rows with no visible key against the plain version on the same
    inputs: the uniform softmax over every key it gathers.  The kernel
    sums the same weighted value rows in another order, so the tolerance
    is relative to the plain version on |v| (args[2])."""
    want = _np(plain(*args, **kw))[dead]
    absargs = list(args)
    absargs[2] = args[2].abs()
    scale = _np(plain(*absargs, **kw))[dead]
    tol = DEAD_TOL[dtype]
    err = np.abs(_np(out)[dead] - want)
    assert bool((err <= tol["atol"] + tol["rtol"] * scale).all()), \
        err.max()
    assert np.abs(want).max() > 0  # the rows are not zeros


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pages", ["bf16", "int8"])
@pytest.mark.parametrize("kind", ["decode", "verify"])
def test_paged_free_slot_rows_match_plain(cuda, kind, pages, q_dtype):
    """A free slot (null block table, pos 0) beside live ones: its rows
    see no key and must give the plain version's output, the mean of the
    null page's value rows, at qwen2-0.5b's heads and at granite-moe's
    (16/8, D 64)."""
    rng = np.random.default_rng(7)
    for H, Hkv, D in ((14, 2, 64), (16, 8, 64)):
        B, bs, NB, T = 4, 16, 12, 4 if kind == "verify" else 0
        P = 1 + B * NB
        kp = torch.from_numpy(rng.normal(size=(P, bs, Hkv, D)).astype(
            np.float32)).to(cuda, torch.bfloat16)
        vp = torch.from_numpy(rng.normal(size=(P, bs, Hkv, D)).astype(
            np.float32)).to(cuda, torch.bfloat16)
        bt = np.full((B, NB), -1, np.int32)
        bt[0, :5], bt[2, :12], bt[3, :1] = range(1, 6), range(6, 18), [18]
        pos = np.asarray([70, 0, 180, 3], np.int32) - (T - 1 if T else 0)
        pos[1] = 0
        shape = (B, T, H, D) if T else (B, H, D)
        q = _t(rng.normal(size=shape).astype(np.float32),
               getattr(torch, q_dtype), cuda)
        tables, p = _t(bt, None, cuda), _t(pos, None, cuda)
        if pages == "int8":
            k8, ks = quantize_kv(kp)
            v8, vs = quantize_kv(vp)
            args = (q, k8, v8, ks, vs, tables, p)
            fn = ops.paged_verify_quant if T else ops.paged_decode_quant
            plain = paged_verify_quant_ref if T else paged_decode_quant_ref
        else:
            args = (q, kp, vp, tables, p)
            fn = ops.paged_verify if T else ops.paged_decode
            plain = paged_verify_ref if T else paged_decode_ref
        out = fn(*args)  # as served
        torch.cuda.synchronize()
        _hold_dead(out, plain, args, [1], {}, q_dtype)
        # the live rows against the plain version on the values widened to
        # fp32: the exact twin for int8 pages (dequantized to fp32, nothing
        # rounded); bf16 pages round each probability, within ROUNDED_TOL
        live = [0, 2, 3]
        if pages == "int8":
            wide = [a.float() if a.is_floating_point() else a for a in args]
            np.testing.assert_allclose(_np(out)[live],
                                       _np(plain(*wide))[live],
                                       **DEAD_TOL[q_dtype])
        else:
            hold_rounded(out, plain, args, {}, live)


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cache", ["float32", "bfloat16", "int8"])
def test_flash_decode_free_slot_rows_match_plain(cuda, cache, q_dtype):
    """A free dense slot (cache_positions all -1) and a slot whose window
    holds no key: no visible key, so the plain version's mean of the
    slot's S value rows (S 96, not a power of two: the bf16 weight is
    rounded)."""
    rng = np.random.default_rng(8)
    B, S, H, Hkv, D = 3, 96, 8, 2, 64
    q = _t(rng.normal(size=(B, H, D)).astype(np.float32),
           getattr(torch, q_dtype), cuda)
    kc = torch.from_numpy(rng.normal(size=(B, S, Hkv, D)).astype(
        np.float32)).to(cuda)
    vc = torch.from_numpy(rng.normal(size=(B, S, Hkv, D)).astype(
        np.float32)).to(cuda)
    cpos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    cpos[1] = -1
    cpos[2, 40:] = -1
    pos = _t(np.asarray([60, 5, 95], np.int32), None, cuda)
    window = 20  # slot 2 at 95 sees keys 76..95: none is held
    cp = _t(cpos, None, cuda)
    if cache == "int8":
        k8, ks = quantize_kv(kc.bfloat16())
        v8, vs = quantize_kv(vc.bfloat16())
        args = (q, k8, v8, ks, vs, cp, pos)
        fn, plain = ops.flash_decode_quant, flash_decode_quant_ref
    else:
        dt = getattr(torch, cache)
        args = (q, kc.to(dt), vc.to(dt), cp, pos)
        fn, plain = ops.flash_decode, flash_decode_ref
    out = fn(*args, window=window)
    torch.cuda.synchronize()
    _hold_dead(out, plain, args, [1, 2], dict(window=window), q_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [
    dict(max_batch=16),  # decode ticks: 16 tokens against a capacity of 8
    dict(max_batch=3, spec_k=3, draft=True),  # verify: 12 tokens
    dict(max_batch=16, paged=False),  # dense decode ticks
    dict(max_batch=3, spec_k=3, draft=True, kv_dtype="int8"),
])
def test_overflowing_experts_card_matches_cpu(cuda, kw):
    """Reduced granite-moe in fp32 with capacity_factor 0.3, free slots
    beside live ones: the CPU engine (plain versions) and the CUDA engine
    (kernels) give identical tokens.  A free slot's attention row decides
    where its token is routed, and so which live token an overflowing
    expert drops."""
    cfg = reduced(get_config("granite-moe-1b-a400m"), act_dtype="float32",
                  capacity_factor=0.3)
    model = build_model(cfg)
    params = model.init(0, param_dtype=torch.float32, device="cpu")
    gpu = _tree(lambda t: t.to(cuda), params)
    kw = dict(kw, prefill_chunk=16)
    outs = []
    for dev, p in (("cpu", params), ("cuda", gpu)):
        dkw = dict(kw)
        if dkw.pop("draft", False):
            dcfg, dparams = _one_layer(cfg, p)
            dkw.update(draft_config=dcfg, draft_params=dparams)
        outs.append(_serve(ServingEngine, Request, model, p,
                           _mixed(cfg.vocab) + _mixed(cfg.vocab, seed=9),
                           device=dev, **dkw)[1])
    assert outs[0] == outs[1]


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_free_slot_routing_card_matches_cpu(cuda, kv_dtype):
    """A verify pass of reduced granite-moe in fp32 with capacity_factor
    0.3 and the free slot first (slot 0, null table): its four rows come
    first in every expert's run, so where they are routed decides which
    live rows overflow.  The null page holds what inactive slots' decode
    writes leave there (random rows here), so the free slot's attention
    rows are not zero.  The live rows' logits on the card (kernels) must
    be the CPU's (plain versions) within 1e-2 (test_torch_dense.py's
    card-vs-CPU bound for fp32 logits: probabilities rounded to the page
    type in other places); a dropped slot moves them by far more."""
    cfg = reduced(get_config("granite-moe-1b-a400m"), act_dtype="float32",
                  capacity_factor=0.3)
    model = build_model(cfg)
    params = model.init(0, param_dtype=torch.float32, device="cpu")
    NB, bs, T = 6, 8, 4
    tables = np.full((4, NB), -1, np.int32)
    for slot, pages in {1: [3, 1, 5, 7], 2: [2, 4, 6, 8, 9, 10],
                        3: [11, 12, 13]}.items():
        tables[slot, :len(pages)] = pages
    pos = np.asarray([0, 21, 30, 14], np.int32)
    rng = np.random.default_rng(0)
    prompts = {s: rng.integers(0, cfg.vocab, int(pos[s])) for s in (1, 2, 3)}
    toks = rng.integers(0, cfg.vocab, (4, T))
    null = rng.normal(size=(2, cfg.n_layers, bs, cfg.n_kv_heads, cfg.hd))
    cache = {n: torch.zeros(s.shape, dtype=s.dtype) for n, s
             in model.abstract_paged_cache(16, bs, kv_dtype).items()}
    for i, name in enumerate(("k_pages", "v_pages")):
        rows = _t(null[i], torch.float32)
        if kv_dtype == "int8":
            rows, scales = quantize_kv(rows)
            cache[name[0] + "_scales"][:, 0] = scales
        cache[name][:, 0] = rows.to(cache[name].dtype)
    for slot, prompt in prompts.items():  # prefilled once, on the CPU
        padded = np.zeros(32, np.int64)
        padded[:len(prompt)] = prompt
        _, cache = model.prefill_chunk_paged(params, cache, {
            "tokens": _t(padded)[None],
            "block_tables": _t(tables[slot])[None],
            "pos": 0, "length": len(prompt)})
    logits = []
    for dev in ("cpu", cuda):  # the verify pass over the same pages
        lg, _ = model.verify_step_paged(
            _tree(lambda t: t.to(dev), params),
            _tree(lambda t: t.to(dev, copy=True), cache),
            {"tokens": _t(toks, None, dev), "pos": _t(pos, None, dev),
             "block_tables": _t(tables, None, dev)})
        logits.append(_np(lg)[1:])
    np.testing.assert_allclose(logits[1], logits[0], atol=1e-2, rtol=0)


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    return fn(tree)
