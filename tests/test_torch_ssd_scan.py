"""The SSD scan's chunked tensor-core kernel (bf16 x, B and C): its launch
plan, a CPU emulation of its arithmetic held to the plain version and to
the JAX package, and — on a CUDA card only — the kernel held to its plain
version at the edges of its tiles (one token, chunks that are not a
multiple of 16, n 8 and p 16, p and n past one 64-column block, 64
chunks of state passing, b 2), a second call on reused scratch, its
launch count, its variant and a call without a device-to-host sync.

The emulation (``_tc_emulation``) computes what the three passes of
``csrc/ssd_scan.cu`` compute, in their order and with their roundings:
each chunk cut into blocks of 64 tokens, a_cum of each block counted
from its first token by the kernel's one-warp scan (two tokens a lane,
then a scan of the lanes' sums); each block's own state x^T W with W =
B dt exp(a_cum[e] - a_cum) (e the block's last token) split into bf16
hi + lo; the states passed block by block in order; then each block's
y = exp(a_cum[t]) (C . s_in) + P . x over its own keys, with s_in and
the weighted scores P split into bf16 hi + lo, every sum in fp32, and
P's decay below a key's 16 taken as two factors against the 16's last
token, as the kernel takes it.  Only the
order of the fp32 sums inside the tensor cores differs.  Inputs are
drawn with numpy from a seed (as test_kernels.py::test_ssd_scan draws
them) and x, B and C rounded to bf16, so the fp32 references see the
numbers the kernel sees.

Tolerance (SCAN_TOL, each case): 1e-4 relative plus 1e-4 times the RMS of
the compared tensor, on y and the final state, as chip_smoke.py and
test_torch_mamba2.py's gpu cases hold the kernel: the same products
summed in other orders over up to 256 keys per chunk and a state
carried across up to 64 chunks, with each fp32 factor as hi + lo (within
2^-16 of it); a wrong mask, decay, chunk boundary or a dropped lo part
moves outputs by far more (``test_one_rounding_leaves_the_tolerance``).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

try:
    import jax
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.models import mamba2 as jm2
except ImportError:  # the port's tests run without the reference too
    jax = None

from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as sk
from repro_torch.kernels.ssd_scan import ssd_scan_ref

SCAN_TOL = dict(atol_rms=1e-4, rtol=1e-4)
# (b, S, h, p, n, chunk): the CPU sweep (test_torch_mamba2.py:SCAN_CASES
# at chunks 16, 32, 64; n 8 and p 16 among them), zamba2-2.7b's width (80
# heads of 64, state 64, chunk 256) at the prompts phase 9c serves that
# are not a multiple of 16 (1, 37, 200 tokens) or are (48) and at 512
# tokens, b 2, 64 chunks of state passing, and p and n that are neither
# a multiple of 8 nor within one 64-column block
SWEEP = [(b, S, h, p, n, c) for b, S, h, p, n in
         ((2, 64, 4, 16, 8), (1, 128, 2, 32, 16)) for c in (16, 32, 64)]
EDGES = [(1, S, 80, 64, 64, 256) for S in (1, 37, 48, 200)] + [
    (2, 96, 6, 64, 64, 32), (1, 1024, 2, 16, 8, 16), (1, 48, 3, 24, 12, 16),
    (1, 128, 2, 80, 72, 64)]
ZAMBA2_512 = [(1, 512, 80, 64, 64, 256)]
CASES = SWEEP + EDGES + ZAMBA2_512


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


def _inputs(b, S, h, p, n, seed=0, init=False):
    """fp32 tensors on the CPU: x, B, C unit normals rounded to bf16, dt
    in [0.1, 0.9), a_neg in (-1, -0.1], with ``init`` a unit-normal
    state."""
    rng = np.random.default_rng(seed)

    def t(a, bf16=False):
        out = torch.from_numpy(np.asarray(a, np.float32))
        return out.bfloat16().float() if bf16 else out

    return (t(rng.normal(size=(b, S, h, p)), True),
            t(rng.uniform(0.1, 0.9, (b, S, h))),
            t(-rng.uniform(0.1, 1.0, (h,))),
            t(rng.normal(size=(b, S, n)), True),
            t(rng.normal(size=(b, S, n)), True),
            t(rng.normal(size=(b, h, p, n))) if init else None)


def _hold(got, want, what):
    """Within SCAN_TOL: 1e-4 relative plus 1e-4 of the compared RMS."""
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    assert np.isfinite(g).all(), what
    rms = float(np.sqrt((w.astype(np.float64) ** 2).mean())) if w.size else 0
    np.testing.assert_allclose(g, w, atol=SCAN_TOL["atol_rms"] * rms,
                               rtol=SCAN_TOL["rtol"], err_msg=what)


def _np(t):
    return t.detach().float().cpu().numpy()


def _split(v, lo=True):
    """v as bf16 hi + lo (the kernel's tc::split_bf16); without ``lo``
    one bf16 rounding."""
    hi = v.bfloat16().float()
    return (hi, (v - hi).bfloat16().float()) if lo else (hi,)


def _block_cumsum(a, width=64):
    """a_cum over the last axis (a block of M <= 64 tokens) in the order of
    the kernel's ``block_cumsum``: lane i of one warp takes tokens 2i and
    2i + 1 (tokens past M count 0), then an inclusive scan of the lanes'
    sums (a += shuffled a at offsets 1, 2, 4, 8, 16).  Returns the first
    ``width`` values."""
    M = a.shape[-1]
    lead = a.shape[:-1]
    a = F.pad(a, (0, 64 - M))
    v0 = a[..., 0::2]
    v1 = v0 + a[..., 1::2]
    inc = v1
    for off in (1, 2, 4, 8, 16):
        shifted = torch.zeros_like(inc)
        shifted[..., off:] = inc[..., :-off]
        inc = inc + shifted
    pre = torch.zeros_like(inc)
    pre[..., 1:] = inc[..., :-1]
    return torch.stack([pre + v0, pre + v1], -1).reshape(*lead, 64)[
        ..., :width]


def _tc_emulation(x, dt, a_neg, B, C, *, chunk, init_state=None, lo=True):
    """The chunked kernel's arithmetic on the CPU (x, B, C fp32 tensors
    holding bf16 values); returns (y [b,S,h,p], final state [b,h,p,n]).
    ``lo=False`` drops the lo parts (one bf16 rounding of each fp32
    factor)."""
    b, S, h, p = x.shape
    n = B.shape[-1]
    Q = chunk
    nc = S // Q
    assert nc * Q == S
    a = (dt * a_neg[None, None, :]).reshape(b, nc, Q, h).transpose(2, 3)
    dts = dt.reshape(b, nc, Q, h).transpose(2, 3)  # [b, nc, h, Q]
    xc = x.reshape(b, nc, Q, h, p).transpose(2, 3)  # [b, nc, h, Q, p]
    Bc, Cc = B.reshape(b, nc, Q, n), C.reshape(b, nc, Q, n)
    blocks = [(r0, min(r0 + 64, Q)) for r0 in range(0, Q, 64)]
    # a_cum of each block, counted from its first token (16-padded: tokens
    # past the block count 0)
    acums = [_block_cumsum(a[..., r0:r1], -(-(r1 - r0) // 16) * 16)
             for r0, r1 in blocks]

    # pass 1: each block's own state x^T (B dt exp(a_cum[e] - a_cum)), e
    # its last token, and its decay exponent a_cum[e]
    local, decay = [], []
    for (r0, r1), acp in zip(blocks, acums):
        at = acp[..., :r1 - r0]
        last = at[..., -1:]
        W = Bc[:, :, None, r0:r1] \
            * (dts[..., r0:r1] * torch.exp(last - at))[..., None]
        local.append(sum(torch.einsum("bchsp,bchsn->bchpn",
                                      xc[..., r0:r1, :], w)
                         for w in _split(W, lo)))
        decay.append(last[..., 0])
    # pass 2: the states entering each block, chunk by chunk, block by block
    s = (torch.zeros(b, h, p, n) if init_state is None
         else init_state.float().clone())
    s_in = [[None] * nc for _ in blocks]
    for c in range(nc):
        for j in range(len(blocks)):
            s_in[j][c] = s
            s = s * torch.exp(decay[j][:, c])[..., None, None] \
                + local[j][:, c]
    # pass 3: y = exp(a_cum[t]) (C . s_in) + P . x, P over the block's own
    # keys
    y = torch.zeros(b, nc, h, Q, p)
    for j, ((r0, r1), acp) in enumerate(zip(blocks, acums)):
        at, ds = acp[..., :r1 - r0], dts[..., r0:r1]
        Cj, Bj = Cc[:, :, r0:r1], Bc[:, :, r0:r1]
        inter = sum(torch.einsum("bctn,bchpn->bchtp", Cj, part)
                    for part in _split(torch.stack(s_in[j], 1), lo))
        inter = torch.exp(at)[..., None] * inter
        scores = torch.einsum("bctn,bcsn->bcts", Cj, Bj)  # exact products
        # dt[s] exp(a_cum[t] - a_cum[s]): in a key's own 16, as it is;
        # below it, exp(a_cum[t] - a_cum[ref]) (dt[s] exp(a_cum[ref] -
        # a_cum[s])), ref the 16's last token
        sixteen = torch.arange(r1 - r0) // 16
        ref = acp[..., sixteen * 16 + 15]
        below = torch.exp(at[..., :, None] - ref[..., None, :]) \
            * (ds * torch.exp(ref - at))[..., None, :]
        own = torch.exp(at[..., :, None] - at[..., None, :]) \
            * ds[..., None, :]
        weight = torch.where(sixteen[:, None] == sixteen[None, :], own,
                             below)
        causal = torch.tril(torch.ones(r1 - r0, r1 - r0, dtype=torch.bool))
        P = torch.where(causal, scores[:, :, None] * weight,
                        torch.zeros((), dtype=torch.float32))
        intra = sum(torch.einsum("bchts,bchsp->bchtp", part,
                                 xc[..., r0:r1, :])
                    for part in _split(P, lo))
        y[..., r0:r1, :] = inter + intra
    return y.transpose(2, 3).reshape(b, S, h, p), s


# ------------------------------------------------------------- the plan


@pytest.mark.parametrize("b,S,h,p,n,chunk", CASES + [
    (1, 1024, 80, 64, 64, 256), (1, 768, 80, 64, 64, 256),
    (1, 256, 80, 64, 64, 256)])
def test_plan_from_the_shapes(b, S, h, p, n, chunk):
    """Grids and scratch from the shapes alone: every chunk in blocks of
    64 tokens, one CTA per (head, block, batch) in passes 1 and 3, a
    thread per state element in pass 2; each block's entering state (bf16
    hi and lo), own state and decay."""
    Q = sk.chunk_length(S, chunk)
    pl = sk.plan(b, S, h, p, n, Q)
    nc = S // Q
    per = -(-Q // 64)
    assert (pl.chunks, pl.block, pl.per_chunk) == (nc, sk.BLOCK, per)
    assert pl.blocks == nc * per and pl.ctas == b * nc * per * h
    assert pl.passing_ctas * sk.PASS_THREADS >= b * h * p * n
    assert (pl.passing_ctas - b * h) * sk.PASS_THREADS < b * h * p * n
    assert pl.split_shape == (b, pl.blocks, h, 2, p, n)
    assert pl.states_shape == (b, pl.blocks, h, p, n)
    assert pl.decay_shape == (b, pl.blocks, h)
    assert pl.scratch_bytes == (2 * int(np.prod(pl.split_shape))
                                + 4 * int(np.prod(pl.states_shape))
                                + 4 * int(np.prod(pl.decay_shape)))
    assert sk.plan(b, S, h, p, n, Q) is pl  # cached


def test_plan_at_zamba2_prefills():
    """zamba2-2.7b (80 heads of 64, state 64, chunk 256): 16 blocks and
    1280 CTAs a pass at 1024 tokens, 960 at 768, 320 at 256; a 1-token
    prompt is one block."""
    big = sk.plan(1, 1024, 80, 64, 64, 256)
    assert (big.chunks, big.per_chunk, big.blocks) == (4, 4, 16)
    assert big.ctas == 1280 and big.passing_ctas == 80 * 16
    assert big.scratch_bytes == 16 * 80 * (8 * 64 * 64 + 4)
    assert sk.plan(1, 768, 80, 64, 64, 256).ctas == 960
    assert sk.plan(1, 256, 80, 64, 64, 256).ctas == 320
    one = sk.plan(1, 1, 80, 64, 64, 1)
    assert (one.chunks, one.blocks, one.ctas) == (1, 1, 80)
    assert sk.plan(1, 200, 80, 64, 64, 200).per_chunk == 4
    with pytest.raises(ValueError):
        sk.plan(1, 300, 80, 64, 64, 256)


# ------------------------------------------- the emulation on the CPU


def test_block_cumsum_is_a_cumsum():
    """The block scan's order gives the cumulative sum, to fp32 rounding,
    at every block length up to 64."""
    rng = np.random.default_rng(3)
    for M in (1, 2, 15, 16, 31, 33, 37, 63, 64):
        a = torch.from_numpy(-rng.uniform(0.01, 0.9, (3, M))
                             .astype(np.float32))
        want = torch.cumsum(a.double(), -1)
        got = _block_cumsum(a, M)
        assert got.shape == a.shape
        np.testing.assert_allclose(got.double().numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("b,S,h,p,n,chunk", CASES)
def test_emulation_matches_plain_and_jax(need_jax, b, S, h, p, n, chunk,
                                         init):
    """The emulation, y and the final state, against ``ssd_scan_ref``,
    JAX's ``ssd_chunked`` and (from zeros: it has no initial state and no
    state output) the Pallas kernel ``ssd_scan_tpu`` in interpret mode."""
    x, dt, a_neg, B, C, s0 = _inputs(b, S, h, p, n, seed=S + h, init=init)
    Q = sk.chunk_length(S, chunk)
    y, state = _tc_emulation(x, dt, a_neg, B, C, chunk=Q, init_state=s0)
    assert y.dtype == torch.float32 and y.shape == (b, S, h, p)
    assert state.shape == (b, h, p, n)
    ry, rstate = ssd_scan_ref(x, dt, a_neg, B, C, chunk=Q, init_state=s0)
    _hold(_np(y), _np(ry), "y vs ssd_scan_ref")
    _hold(_np(state), _np(rstate), "final state vs ssd_scan_ref")
    jx = [jnp.asarray(_np(t)) for t in (x, dt, a_neg, B, C)]
    js0 = None if s0 is None else jnp.asarray(_np(s0))
    jy, jstate = jm2.ssd_chunked(*jx, chunk=Q, init_state=js0)
    _hold(_np(y), np.asarray(jy), "y vs ssd_chunked")
    _hold(_np(state), np.asarray(jstate), "final state vs ssd_chunked")
    if not init:
        ky = jops.ssd_scan(*jx, chunk=Q, interpret=True)
        _hold(_np(y), np.asarray(ky), "y vs ssd_scan_tpu (interpret)")


@pytest.mark.parametrize("b,S,h,p,n,chunk", [(1, 256, 8, 64, 64, 256),
                                             (2, 64, 4, 16, 8, 32)])
def test_one_rounding_leaves_the_tolerance(b, S, h, p, n, chunk):
    """Without the lo parts (one bf16 rounding of each fp32 factor) the
    same arithmetic leaves SCAN_TOL on y: the tolerance tells hi + lo
    from one rounding."""
    x, dt, a_neg, B, C, _ = _inputs(b, S, h, p, n, seed=5)
    ry, _ = ssd_scan_ref(x, dt, a_neg, B, C, chunk=chunk)
    y, _ = _tc_emulation(x, dt, a_neg, B, C, chunk=chunk)
    _hold(_np(y), _np(ry), "hi + lo")
    y1, _ = _tc_emulation(x, dt, a_neg, B, C, chunk=chunk, lo=False)
    with pytest.raises(AssertionError):
        _hold(_np(y1), _np(ry), "one rounding")


# ------------------------------------------------ the kernel on a card


GPU_CASES = ([(1, S, 80, 64, 64, 256) for S in (1, 37, 200)]
             + [(2, 64, 4, 16, 8, 16), (1, 1024, 80, 64, 64, 16),
                (2, 512, 80, 64, 64, 256), (1, 48, 3, 24, 12, 16),
                (1, 128, 2, 80, 72, 64), (1, 256, 4, 128, 128, 64)])


def _on(dev, args, dtype):
    x, dt, a_neg, B, C, s0 = args
    return ([x.to(dev, dtype), dt.to(dev), a_neg.to(dev), B.to(dev, dtype),
             C.to(dev, dtype)], None if s0 is None else s0.to(dev))


@pytest.mark.gpu
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,S,h,p,n,chunk", GPU_CASES)
def test_kernel_matches_plain(cuda, b, S, h, p, n, chunk, dtype, init):
    """y and the final state against the plain version on the card, one
    launch counted per call."""
    tdt = getattr(torch, dtype)
    args, s0 = _on(cuda, _inputs(b, S, h, p, n, seed=11, init=init), tdt)
    before = ops.ssd_scan.launches
    y, state = ops.ssd_scan(*args, chunk=chunk, init_state=s0)
    torch.cuda.synchronize()
    assert ops.ssd_scan.launches == before + 1
    assert y.dtype == torch.float32 and y.shape == (b, S, h, p)
    assert state.dtype == torch.float32 and state.shape == (b, h, p, n)
    wy, ws = ssd_scan_ref(*[a.float() for a in args], chunk=min(chunk, S),
                          init_state=s0)
    _hold(_np(y), _np(wy), "y")
    _hold(_np(state), _np(ws), "final state")


@pytest.mark.gpu
def test_kernel_matches_emulation(cuda):
    """At zamba2's width over two chunks from a state, the kernel and the
    CPU emulation of its arithmetic agree within SCAN_TOL too."""
    cpu = _inputs(1, 512, 80, 64, 64, seed=12, init=True)
    args, s0 = _on(cuda, cpu, torch.bfloat16)
    y, state = ops.ssd_scan(*args, chunk=256, init_state=s0)
    ey, es = _tc_emulation(*cpu[:5], chunk=256, init_state=cpu[5])
    _hold(_np(y), _np(ey), "y vs the emulation")
    _hold(_np(state), _np(es), "final state vs the emulation")


@pytest.mark.gpu
def test_second_call_on_reused_scratch(cuda):
    """Calls on the scratch an earlier call freed: each holds to its own
    plain version, and the same inputs give the same bits again."""
    first = _on(cuda, _inputs(1, 512, 80, 64, 64, seed=13, init=True),
                torch.bfloat16)
    second = _on(cuda, _inputs(1, 512, 80, 64, 64, seed=14), torch.bfloat16)
    y1, s1 = ops.ssd_scan(*first[0], chunk=256, init_state=first[1])
    y2, s2 = ops.ssd_scan(*second[0], chunk=256, init_state=second[1])
    y3, s3 = ops.ssd_scan(*first[0], chunk=256, init_state=first[1])
    torch.cuda.synchronize()
    for (args, s0), y, s in ((first, y1, s1), (second, y2, s2)):
        wy, ws = ssd_scan_ref(*[a.float() for a in args], chunk=256,
                              init_state=s0)
        _hold(_np(y), _np(wy), "y")
        _hold(_np(s), _np(ws), "final state")
    assert torch.equal(y1, y3) and torch.equal(s1, s3)


@pytest.mark.gpu
def test_no_host_sync(cuda):
    """The wrapper reads nothing on the host: a call under
    ``set_sync_debug_mode("error")`` raises no sync error."""
    args, s0 = _on(cuda, _inputs(1, 768, 80, 64, 64, seed=15, init=True),
                   torch.bfloat16)
    ops.ssd_scan(*args, chunk=256, init_state=s0)  # build and load first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, state = ops.ssd_scan(*args, chunk=256, init_state=s0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(state).all())


@pytest.mark.gpu
def test_variant_and_shared_memory(cuda):
    """bf16 x runs the tensor-core chunked passes, fp32 x the walk; each
    pass fits the card's shared memory at zamba2's width."""
    assert sk.variant(torch.bfloat16).startswith("tensor-core chunked")
    assert sk.variant(torch.float32).startswith("fp32 walk")
    smem = sk.smem_bytes(256, 64, 64, torch.bfloat16)
    assert set(smem) == {"block states", "state passing", "block outputs"}
    assert smem["state passing"] == 0
    assert 0 < max(smem.values()) <= sk.MAX_SMEM_BYTES
    assert set(sk.smem_bytes(256, 64, 64, torch.float32)) == {"walk"}
    for shape in ((1, 1024, 80, 64, 64, 256), (2, 48, 3, 24, 12, 16),
                  (1, 200, 80, 64, 64, 200)):
        assert sk._lib().ssd_scan_scratch_bytes(*shape) \
            == sk.plan(*shape).scratch_bytes
    assert sk._lib().ssd_scan_block() == sk.BLOCK
