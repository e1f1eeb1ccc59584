"""The column-stable dense product (``kernels/dense_matmul.py``) against
the JAX package: its plain version against ``jnp.dot`` in bf16 and fp32;
its launch plan, the same for every shard of a global N and refusing a
shard that cannot run the variant the global shape picks; the autograd
Function's gradients against ``jax.vjp`` of the same product; and the
model's routing: one reduced forward each of llama3.2-3b, qwen2-moe-a2.7b
and whisper-large-v3 calls it once for every column-cut weight of every
layer and for nothing else.  On a CUDA card only: the kernel held to its
plain version at its variants' edges, and a shard's product under the
global plan equal to those columns of the unsharded product bit for bit.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs on the CPU on any host (``need_jax``).

Tolerances (each with its reason):
* plain version vs ``jnp.dot`` in fp32: the same fp32 products summed in
  another order, on outputs of magnitude ~1: 1e-5 absolute and relative;
  in bf16 both round an fp32 sum to bf16, and sums differing in their
  last bits may round to neighbouring values: one bf16 ulp (2^-7
  relative) plus 1e-2 absolute;
* gradients vs ``jax.vjp``: as the forward, for dx and dw;
* the CUDA kernel vs its plain version on the card: against the plain
  version on the same values in fp32, one bf16 ulp (2^-7) for a bf16
  output (the kernel rounds its fp32 sum once) and 1e-4 relative for
  fp32, plus 1e-4 absolute for the summation order; in the working type
  test_kernels.py's 1e-2 / 5e-2 (both round fp32 sums to bf16);
* the column slices: bit for bit, the contract of the kernel.
"""
import collections

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
except ImportError:  # JAX (the reference) is not installed
    jax = None

from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.device import observe_kernels
from repro_torch.kernels import dense_matmul as dm
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.models.api import build_model

PLAIN_TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
             "bfloat16": dict(atol=1e-2, rtol=2 ** -7)}
EXACT_TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
             "bfloat16": dict(atol=1e-4, rtol=2 ** -7)}
KERNEL_TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
              "bfloat16": dict(atol=1e-2, rtol=5e-2)}
# (M, K, N): a decode tick, a verify pass, a chunk, prompts, ragged and
# unaligned shapes
CASES = [(1, 64, 96), (4, 128, 64), (16, 96, 40), (64, 70, 90),
         (65, 128, 256), (130, 64, 200), (33, 1024, 3072)]
# the projections tensor parallelism cuts by columns (K, N): llama3.2-3b's
# and granite-moe-1b-a400m's, and the reduced configs'
PROJECTIONS = [(3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072),
               (1024, 1024), (1024, 512), (64, 64), (64, 128), (128, 64)]
ROWS = (1, 4, 8, 16, 17, 32, 64, 65, 128, 512, 1024, 8192)


def _zoo_projections() -> list:
    """Every column-cut (K, N) of every config of the zoo at full width: q,
    k/v and o, the MLP's (the shared expert's) up and down (zamba2's shared
    block reads [2d]; xlstm has none)."""
    out = set()
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        if cfg.block_kind == "xlstm":
            continue
        d = cfg.d_model
        q, kv = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
        din = 2 * d if cfg.block_kind == "mamba_hybrid" else d
        ff = cfg.shared_ff if cfg.n_experts else cfg.d_ff
        out.update({(din, q), (din, kv), (q, d)})
        if ff:
            out.update({(d, ff), (ff, d)})
    return sorted(out)


ZOO = _zoo_projections()


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


def _inputs(M, K, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, K)).astype(np.float32),
            (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32))


def _np(x):
    return np.asarray(x.detach().float().cpu() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------- plain version


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", CASES)
def test_plain_version_matches_jnp_dot(need_jax, M, K, N, dtype):
    xn, wn = _inputs(M, K, N, M * K + N)
    dt = getattr(torch, dtype)
    out = ops.dense_matmul(torch.from_numpy(xn).to(dt),
                           torch.from_numpy(wn).to(dt))
    want = jnp.dot(jnp.asarray(xn, dtype), jnp.asarray(wn, dtype),
                   preferred_element_type=jnp.float32).astype(dtype)
    assert out.dtype == dt and out.shape == (M, N)
    np.testing.assert_allclose(_np(out), _np(want), **PLAIN_TOL[dtype])


def test_cpu_and_meta_run_the_plain_version():
    """On the CPU the wrapper is ``x @ w`` bit for bit (the port's CPU
    results are what they were before the kernel), on ``meta`` its shape
    only; neither counts a launch."""
    xn, wn = _inputs(5, 32, 24, 3)
    x, w = torch.from_numpy(xn), torch.from_numpy(wn)
    before = ops.dense_matmul.launches
    assert torch.equal(ops.dense_matmul(x, w), x @ w)
    out = ops.dense_matmul(x.to("meta"), w.to("meta"), plan_n=96)
    assert out.device.type == "meta" and out.shape == (5, 24)
    assert ops.dense_matmul.launches == before


# ------------------------------------------------------------------ plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,N", sorted(set(PROJECTIONS) | set(ZOO)))
def test_every_shard_launches_the_global_plan(dtype, K, N):
    """At every row count, each rank's shard of w (N / tp columns, tp 1, 2
    and 4) passed with ``plan_n=N`` gets the unsharded call's plan: the
    variant, the tile width and the K split; the split covers K in whole
    steps with no split empty."""
    for M in ROWS:
        x = torch.empty(M, K, dtype=dtype)
        want = dm.launch_plan(x, torch.empty(K, N, dtype=dtype))
        assert want == dm.plan(dtype, M, K, N)
        for tp in (1, 2, 4):
            shard = torch.empty(K, N // tp, dtype=dtype)
            assert dm.launch_plan(x, shard, plan_n=N) == want
        bk = dm.TILES[want.variant][2]
        ktiles = -(-K // bk)
        assert (want.splits - 1) * want.kt_per < ktiles \
            <= want.splits * want.kt_per
        assert want.variant == ("fp32" if dtype == torch.float32 else
                                "mma_sync" if M <= dm.SMALL_ROWS else
                                "wgmma")
        assert want.width in dm.WIDTHS[want.variant]


def test_plan_fills_the_card_at_a_decode_tick():
    """bf16 at M <= 64: the tile width (64 or 128 columns) and the K split
    of the global N by ``split_cost``, two CTAs an SM (264 slots on 132
    SMs): a wave costs its CTAs' walk or the card's bandwidth, whichever
    is longer, so llama3.2-3b's wq takes 128-column tiles in 4 splits of
    12 steps (96 CTAs, each streaming 16 KB a step); a rank's own N (768
    at TP 4) would take 64 columns in 16 splits."""
    p = dm.plan(torch.bfloat16, 4, 3072, 3072)
    assert (p.variant, p.rows8, p.width, p.splits, p.kt_per) == (
        "mma_sync", 1, 128, 4, 12)
    assert p.ctas(4, 3072) == 96 <= 2 * dm.SMS
    own = dm.plan(torch.bfloat16, 4, 3072, 768)
    assert (own.width, own.splits, own.kt_per) == (64, 16, 3)
    # w_gate's 64 tiles of 128 columns split in 2; chameleon-34b's
    # gate/up has 172, more than the card streams at once: unsplit
    assert (dm.plan(torch.bfloat16, 4, 3072, 8192).width,
            dm.plan(torch.bfloat16, 4, 3072, 8192).splits) == (128, 2)
    assert dm.plan(torch.bfloat16, 4, 8192, 22016).splits == 1
    assert [dm.plan(torch.bfloat16, m, 64, 64).rows8
            for m in (1, 8, 9, 16, 17, 32, 33, 64)] == [1, 1, 2, 2, 4, 4, 8,
                                                        8]
    assert dm.plan(torch.bfloat16, 65, 64, 64).variant == "wgmma"
    # rows TMA cannot describe run the mma.sync tiles at any M
    assert dm.plan(torch.bfloat16, 300, 70, 96).variant == "mma_sync"
    assert dm.plan(torch.bfloat16, 300, 70, 96).rows8 == 8


def test_prompt_plans_fill_the_card():
    """bf16 at M 1024, the wgmma kernel's plans: qwen2-0.5b's projections
    launch at least 96 units of work (CTAs) wherever K has the steps for
    a split to pay, that is at least twice the 15 K steps a split's end
    costs (``SPLIT``): down [4864, 896] (76 steps) splits in 2 over
    [128 x 128] tiles, 112 units; gate/up [896, 4864] has 304 [128 x
    128] tiles; wq [896, 896] and k/v [896, 128] (14 steps) run their
    [128 x 128] tiles unsplit (56 and 8 units, where [128 x 256] tiles
    give 32 and 8).  llama3.2-3b's and chameleon-34b's gate/up, wq and
    down keep the default [128 x 256] tiles unsplit."""
    qwen = {"wq": (896, 896), "gate/up": (896, 4864), "down": (4864, 896),
            "wk/wv": (896, 128)}
    for name, (K, N) in qwen.items():
        p = dm.plan(torch.bfloat16, 1024, K, N)
        ktiles = -(-K // dm.TILES["wgmma"][2])
        if ktiles >= 2 * dm.SPLIT["wgmma"]:
            assert p.ctas(1024, N) >= 96, (name, p)
        else:
            assert p.splits == 1 and p.width == 128, (name, p)
    assert dm.plan(torch.bfloat16, 1024, 896, 896) == dm.Plan(
        "wgmma", 0, 128, 1, 14)
    assert dm.plan(torch.bfloat16, 1024, 4864, 896) == dm.Plan(
        "wgmma", 0, 128, 2, 38)
    assert dm.plan(torch.bfloat16, 1024, 896, 4864).ctas(1024, 4864) == 304
    for K, N in ((3072, 8192), (3072, 3072), (8192, 3072), (8192, 22016),
                 (8192, 8192), (22016, 8192)):
        p = dm.plan(torch.bfloat16, 1024, K, N)
        assert (p.width, p.splits) == (256, 1), (K, N, p)
    # the training batch's products stay [128 x 256] unsplit
    assert dm.plan(torch.bfloat16, 8192, 4864, 896).splits == 1
    # the cost: waves times the K steps a CTA walks, plus a split's end
    # each wave; a bytes-bound wave takes at least its CTAs' steps at the
    # card's rate
    assert dm.split_cost(56, 76, 2, 132, 1.0, 0.0, 15, 2) == 38 + 17
    assert dm.split_cost(56, 76, 3, 132, 1.0, 0.0, 15, 4) == 2 * (26 + 19)
    assert dm.split_cost(344, 128, 1, 264, 1.0, 0.01, 0, 0) == \
        128 * (264 * 0.01 + 1)


def test_a_shard_that_cannot_run_the_global_variant_raises():
    """The global [128, 64] x [64, 1000] is the wgmma kernel's; a quarter
    of its columns (250 a rank, rows of 500 bytes) cannot be read by TMA,
    so the shard raises rather than switch; so does an unaligned x, and
    operands the kernel does not take."""
    x = torch.empty(128, 64, dtype=torch.bfloat16)
    assert dm.launch_plan(x, torch.empty(64, 1000, dtype=torch.bfloat16)) \
        .variant == "wgmma"
    with pytest.raises(ValueError, match="16-byte-aligned"):
        dm.launch_plan(x, torch.empty(64, 250, dtype=torch.bfloat16),
                       plan_n=1000)
    # at a decode tick the same shard runs the global plan's mma.sync
    assert dm.launch_plan(torch.empty(4, 64, dtype=torch.bfloat16),
                          torch.empty(64, 250, dtype=torch.bfloat16),
                          plan_n=1000) == dm.plan(torch.bfloat16, 4, 64, 1000)
    base = torch.empty(128 * 64 + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        dm.launch_plan(base[1:].view(128, 64),
                       torch.empty(64, 256, dtype=torch.bfloat16))
    w = torch.empty(64, 256, dtype=torch.bfloat16)
    for bad_x, bad_w, match in (
            (x.float(), w, "both fp32 or both bf16"),
            (x.half(), w.half(), "both fp32 or both bf16"),
            (x[None], w, r"\[M, K\]"),
            (torch.empty(128, 32, dtype=torch.bfloat16), w, r"\[M, K\]"),
            (torch.empty(64, 128, dtype=torch.bfloat16).T, w, "contiguous")):
        with pytest.raises(ValueError, match=match):
            dm.launch_plan(bad_x, bad_w)
    with pytest.raises(ValueError, match="plan_n"):
        dm.launch_plan(x, w, plan_n=128)


# -------------------------------------------------------------- gradient


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(6, 32, 48), (40, 96, 24)])
def test_gradients_match_jax_vjp(need_jax, M, K, N, dtype):
    xn, wn = _inputs(M, K, N, 11 * M + N)
    rng = np.random.default_rng(M + K)
    dyn = rng.standard_normal((M, N)).astype(np.float32)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(xn).to(dt).requires_grad_()
    w = torch.from_numpy(wn).to(dt).requires_grad_()
    y = ops.dense_matmul(x, w)
    assert y.grad_fn is not None and "DenseMatmul" in type(y.grad_fn).__name__
    y.backward(torch.from_numpy(dyn).to(dt))
    jy, vjp = jax.vjp(jnp.dot, jnp.asarray(xn, dtype), jnp.asarray(wn, dtype))
    jdx, jdw = vjp(jnp.asarray(dyn, dtype))
    np.testing.assert_allclose(_np(y), _np(jy), **PLAIN_TOL[dtype])
    np.testing.assert_allclose(_np(x.grad), _np(jdx), **PLAIN_TOL[dtype])
    np.testing.assert_allclose(_np(w.grad), _np(jdw), **PLAIN_TOL[dtype])
    with pytest.raises(ValueError, match="serving"):
        ops.dense_matmul(x, w, plan_n=2 * N)


# --------------------------------------------------------------- routing


class _Weights:
    """An observer that counts the dense product's calls by the storage
    address of their weight, and every kernel wrapper's calls by name."""

    def __init__(self):
        self.weights = collections.Counter()
        self.calls = collections.Counter()

    def kernel(self, name, fn, args, kwargs):
        self.calls[name] += 1
        if name == "dense_matmul_fwd":
            self.weights[args[1].data_ptr()] += 1
        return fn(*args, **kwargs)


def _layer_weights(tree, n, names) -> collections.Counter:
    return collections.Counter(
        lm.layer_slice(tree, i)[a][b].data_ptr()
        for i in range(n) for a, b in names)


ATTN = [("attn", w) for w in ("wq", "wk", "wv", "wo")]
GATED = [("mlp", w) for w in ("w_gate", "w_up", "w_down")]
SHARED = [("moe", w) for w in ("shared_gate", "shared_up", "shared_down")]
PLAIN_MLP = [("mlp", "w1"), ("mlp", "w2")]
CROSS = [("xattn", w) for w in ("wq", "wk", "wv", "wo")]


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen2-moe-a2.7b",
                                  "whisper-large-v3"])
def test_forward_routes_every_column_cut_weight(arch):
    """One reduced forward calls ``dense_matmul`` exactly once for every
    column-cut weight of every layer (7 a llama layer: q, k, v, o and the
    gated MLP's three; 4 + the shared expert's 3 a qwen2-moe layer;
    whisper's encoder layers 6 and decoder layers 10, the cross-attention
    included) and for no other weight (the LM head and the routers stay
    ``x @ w``)."""
    # fp32 activations on the fp32 weights: each weight reaches the kernel
    # as it lies (no cast), so its address names it
    cfg = reduced(get_config(arch), act_dtype="float32")
    model = build_model(cfg)
    params = model.init(0, torch.float32, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab, (2, 12)))
    obs = _Weights()
    with torch.no_grad(), observe_kernels(obs):
        if cfg.cross_attention:
            frames = torch.from_numpy(np.random.default_rng(1)
                                      .standard_normal((2, 20, cfg.d_model))
                                      .astype(np.float32))
            lm.forward_hidden(cfg, params, {"tokens": tokens,
                                            "encoder_frames": frames})
            want = (_layer_weights(params["encoder"], cfg.encoder_layers,
                                   ATTN + PLAIN_MLP)
                    + _layer_weights(params["layers"], cfg.n_layers,
                                     ATTN + CROSS + PLAIN_MLP))
            per_layer = (6, 10)
        else:
            h = lm.attn_forward(cfg, params, tokens)
            lm.last_logits(cfg, params, h[:, -1])
            names = ATTN + (SHARED if cfg.n_experts else GATED)
            want = _layer_weights(params["layers"], cfg.n_layers, names)
            per_layer = (len(names),)
    assert obs.weights == want
    layers = ((cfg.encoder_layers, cfg.n_layers) if cfg.cross_attention
              else (cfg.n_layers,))
    assert obs.calls["dense_matmul_fwd"] == sum(
        n * k for n, k in zip(layers, per_layer))
    assert cfg.cross_attention or per_layer == (7,)


# -------------------------------------------------------- on the card


# every variant, split and unsplit: the mma.sync tiles 64 and 128 wide
# split K (decode, verify, chunk rows; llama3.2-3b's w_gate) and unsplit
# ([1, 70] x [70, 90], chameleon-34b's gate/up), the wgmma kernel's
# [128 x 256] tiles (512 x [3072, 8192]), its [128 x 128] tiles unsplit
# (qwen2-0.5b's wq and ragged k/v at M 1024, [1000, 896] x [896, 200]) and
# split (its down, [8192, 1024]), fp32 split and unsplit at the same
# shapes
GPU_CASES = CASES + [(8, 3072, 1024), (64, 8192, 3072), (512, 3072, 8192),
                     (300, 896, 4864), (1, 70, 90), (200, 70, 90),
                     (1024, 896, 896), (1024, 4864, 896), (1024, 896, 128),
                     (1024, 8192, 1024), (1000, 896, 200), (8, 896, 128),
                     (8, 3072, 8192), (4, 8192, 22016), (17, 70, 300)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", GPU_CASES)
def test_kernel_matches_plain(cuda, M, K, N, dtype):
    gen = torch.Generator(device=cuda).manual_seed(M * K + N)
    dt = getattr(torch, dtype)
    x = torch.randn(M, K, device=cuda, generator=gen).to(dt)
    w = (torch.randn(K, N, device=cuda, generator=gen) * K ** -0.5).to(dt)
    before = ops.dense_matmul.launches
    out = ops.dense_matmul(x, w)
    torch.cuda.synchronize()
    assert ops.dense_matmul.launches == before + 1
    assert out.dtype == dt and out.shape == (M, N)
    np.testing.assert_allclose(_np(out), _np(x.float() @ w.float()),
                               **EXACT_TOL[dtype])
    np.testing.assert_allclose(_np(out), _np(dm.dense_matmul_ref(x, w)),
                               **KERNEL_TOL[dtype])
    assert torch.equal(ops.dense_matmul(x, w), out)  # deterministic


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,N", PROJECTIONS + [(896, 896), (4864, 896),
                                               (896, 128), (8192, 1024)])
def test_shard_products_are_the_unsharded_columns(cuda, K, N, dtype):
    """Rank r's product over its N / tp columns, under the global plan,
    equals those columns of the unsharded product bit for bit, at a
    decode tick, a verify pass, a chunk and prompts (at M 1024 the
    wgmma kernel's [128 x 128] tiles, unsplit for qwen2-0.5b's wq and k/v,
    in 2 splits for its down and for [8192, 1024])."""
    gen = torch.Generator(device=cuda).manual_seed(K + N)
    dt = getattr(torch, dtype)
    w = (torch.randn(K, N, device=cuda, generator=gen) * K ** -0.5).to(dt)
    for M in (4, 16, 64, 128, 1024):
        x = torch.randn(M, K, device=cuda, generator=gen).to(dt)
        full = ops.dense_matmul(x, w)
        for tp in (2, 4):
            n = N // tp
            for r in range(tp):
                got = ops.dense_matmul(x, w[:, r * n:(r + 1) * n]
                                       .contiguous(), plan_n=N)
                assert torch.equal(got, full[:, r * n:(r + 1) * n]), (M, tp,
                                                                      r)


@pytest.mark.gpu
def test_kernel_reads_layer_views_and_refuses(cuda):
    """A layer's [K, N] view of a stacked [L, K, N] leaf goes in as it is;
    a CUDA tensor never reaches the plain version: what the kernel cannot
    take raises."""
    w = torch.randn(3, 128, 256, device=cuda, dtype=torch.bfloat16)
    x = torch.randn(100, 128, device=cuda, dtype=torch.bfloat16)
    out = ops.dense_matmul(x, w[1])
    np.testing.assert_allclose(_np(out), _np(x.float() @ w[1].float()),
                               **EXACT_TOL["bfloat16"])
    with pytest.raises(ValueError, match="16-byte-aligned"):
        ops.dense_matmul(x, torch.randn(128, 250, device=cuda,
                                        dtype=torch.bfloat16), plan_n=1000)
    with pytest.raises(ValueError, match="both fp32 or both bf16"):
        ops.dense_matmul(x.half(), w[1].half())
    with pytest.raises(ValueError, match="several devices"):
        ops.dense_matmul(x, w[1].cpu())


@pytest.mark.gpu
def test_one_launch_a_call(cuda):
    """Every call is one kernel launch, split plans included (the tile's
    last CTA sums the partials: no second kernel, no ``zeros`` for the
    counters), and calls repeated on reused counters give the same bits."""
    cases = [(8, 3072, 3072, torch.bfloat16), (64, 8192, 3072, torch.bfloat16),
             (1024, 4864, 896, torch.bfloat16), (1024, 8192, 1024,
                                                 torch.bfloat16),
             (8, 3072, 3072, torch.float32)]
    for M, K, N, dt in cases:
        assert dm.plan(dt, M, K, N).splits > 1, (M, K, N, dt)
        x = torch.randn(M, K, device=cuda).to(dt)
        w = (torch.randn(K, N, device=cuda) * K ** -0.5).to(dt)
        first = ops.dense_matmul(x, w)
        torch.cuda.synchronize()
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        with prof:
            outs = [ops.dense_matmul(x, w) for _ in range(5)]
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")]
        if kernels:  # a session on the card's host now and then sees none
            assert len(kernels) == 5, [e.name for e in kernels]
            assert all("dense_" in e.name for e in kernels)
        assert all(torch.equal(o, first) for o in outs)
